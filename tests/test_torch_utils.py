"""The port's FLOP model and profiling helpers (geoa3_tpu_torch/utils/
flops.py, profiling.py) on the CPU: the MAC inventory equal to the JAX
package's, and the PointNet forward's and input gradient's products
counted by torch.utils.flop_counter equal to it (exactly: both count the
matrix products alone, tests/test_flops.py holds the JAX count against
XLA's within 5%)."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from geoa3_tpu.utils import flops as JF
from geoa3_tpu_torch.models import build_model
from geoa3_tpu_torch.ops.kernels import _build
from geoa3_tpu_torch.utils import flops as F
from geoa3_tpu_torch.utils.profiling import annotate, debug_nans, device_trace, timed

torch.set_num_threads(1)


@pytest.mark.parametrize("b,n,classes", [(1, 64, 10), (4, 256, 40), (32, 1024, 40)])
def test_mac_inventory_matches_jax(b, n, classes):
    assert F.pointnet_forward_macs(n, classes) == JF.pointnet_forward_macs(n, classes)
    assert F.pointnet_input_grad_macs(n, classes) == JF.pointnet_input_grad_macs(n, classes)
    assert F.attack_geometry_macs(n) == JF.attack_geometry_macs(n)
    assert F.attack_step_flops(b, n, 16, classes) == JF.attack_step_flops(b, n, 16, classes)


@pytest.mark.parametrize("n", [128, 1024])
def test_pointnet_counts_match_flop_counter(n):
    model = build_model("PointNet", classes=40, npoint=n, device="cpu")
    model.requires_grad_(False)
    x = torch.randn(2, n, 3)
    with FlopCounterMode(display=False) as fc:
        model(x)
    assert fc.get_total_flops() == 2 * 2 * F.pointnet_forward_macs(n)
    x.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        model(x).sum().backward()
    assert fc.get_total_flops() == 2 * 2 * (
        F.pointnet_forward_macs(n) + F.pointnet_input_grad_macs(n))


def test_peak_is_float32s_of_the_card(monkeypatch):
    assert F.device_peak_flops("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert F.device_peak_flops("cuda") == 67e12
    assert F.device_peak_flops() == 67e12
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Some GPU")
    assert F.device_peak_flops("cuda") is None


def test_mfu():
    out = F.mfu(4.0, 32, 1024, peak=67e12)
    assert out["peak_tflops"] == 67.0 and 0 < out["mfu"] < 1
    assert out["tflops"] == pytest.approx(
        F.attack_step_flops(32, 1024)["total"] / 4e-3 / 1e12, rel=0.01)
    assert "mfu" not in F.mfu(4.0, 32, 1024, peak=0)


def test_profiling_helpers(tmp_path):
    with annotate("test-region"):
        pass
    with debug_nans(False):
        (torch.zeros(1) / 0).sum()
    out, dt = timed(lambda x: torch.as_tensor(x) * 2, 21.0)
    assert float(out) == 42.0 and dt >= 0
    with device_trace(str(tmp_path / "trace")) as d:
        with annotate("traced"):
            torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0 and d


def test_debug_nans_raises_on_a_planted_nan():
    with debug_nans(True):
        assert _build.check_nans
        torch.empty(16)  # unwritten memory is not a NaN made
        y = torch.ones(3) * 2
        with pytest.raises(FloatingPointError, match="NaN"):
            torch.log(y - 3)
    assert not _build.check_nans
    torch.log(torch.ones(3) - 2)  # off again
