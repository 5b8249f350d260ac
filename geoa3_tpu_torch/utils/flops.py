"""Analytic FLOP accounting for the attack step -> model FLOP utilisation
(port of geoa3_tpu/utils/flops.py; the same inventory).

Conventions (so that the number is reproducible):
  * FLOPs = 2 x MACs for every matrix product and convolution; elementwise,
    BatchNorm, ReLU and pooling work is not counted;
  * the backward counts input-gradient products only: the victim is frozen
    (eval mode, reference main_attack.py:146), so no weight gradient is
    computed;
  * the geometry terms count the algorithmic minimum of matrix-product work
    (one [n, n] distance expansion each for the dual 1-NN and the kappa
    terms, the payload and scatter contractions at their logical widths),
    not what a kernel actually executes;
  * the peak is float32's outside the tensor cores: the port turns TF32 off
    (device.float32_exact) and computes in float32 throughout, so the
    tensor cores' TF32 or bf16 peaks do not apply.

PointNet's layer inventory mirrors models/pointnet.py (reference
Model/PointNet.py:96-179): T-Net(3) -> bmm -> conv1/2 -> T-Net(64) -> bmm ->
conv3/4 -> conv5 (kernel 3) -> pool -> FC head.
"""

from __future__ import annotations

from typing import Optional

import torch


def _tnet_macs(n: int, K: int) -> int:
    """TransformNet MACs per instance (models/pointnet.py TransformNet)."""
    per_point = K * 64 + 64 * 128 + 128 * 1024
    fc = 1024 * 512 + 512 * 256 + 256 * K * K
    return n * per_point + fc


def pointnet_forward_macs(n: int, classes: int = 40) -> int:
    """Per-instance forward MACs of the 1024-wide PointNet victim."""
    macs = _tnet_macs(n, 3) + n * 3 * 3  # input T-Net + bmm
    macs += n * (3 * 64 + 64 * 64)  # conv1, conv2
    macs += _tnet_macs(n, 64) + n * 64 * 64  # feature T-Net + bmm
    macs += n * (64 * 64 + 64 * 128)  # conv3, conv4
    macs += n * 3 * 128 * 1024  # conv5: kernel-3 conv (reference :110)
    macs += 1024 * 512 + 512 * 256 + 256 * classes  # FC head
    return macs


def pointnet_input_grad_macs(n: int, classes: int = 40) -> int:
    """Per-instance input-gradient MACs (frozen victim: dX terms only).

    Every dense or conv dX = dY W^T costs its forward's MACs; the two
    feature bmms also produce dT (feat^T dY, n K^2 each), since the
    transforms are functions of the input themselves.
    """
    return pointnet_forward_macs(n, classes) + n * (3 * 3 + 64 * 64)


def attack_geometry_macs(n: int, k: int = 16) -> int:
    """Per-instance matrix-product MACs of the loss geometry, per step:
    the dual 1-NN distance expansion (n^2 x 3), the 8 payload planes
    (n^2 x 8), the o2a gather's backward scatter (n^2 x 3), the kappa
    forward's expansion and its masked reduction (n^2 x 6) and the kappa
    backward's mask-weighted products (n^2 x 6). The k selection rounds are
    comparisons, with no credit."""
    del k  # the selection rounds carry no matrix-product credit
    return n * n * (3 + 8 + 3 + 6 + 6)


def attack_step_flops(batch: int, n: int, k: int = 16, classes: int = 40) -> dict:
    """FLOPs of one attack inner step at batch x n (see the module doc)."""
    fwd = 2 * pointnet_forward_macs(n, classes) * batch
    bwd = 2 * pointnet_input_grad_macs(n, classes) * batch
    geo = 2 * attack_geometry_macs(n, k) * batch
    return {
        "victim_fwd": fwd,
        "victim_bwd": bwd,
        "geometry": geo,
        "total": fwd + bwd + geo,
    }


# float32 peak FLOP/s outside the tensor cores, by a substring of the card's
# name (NVIDIA's H100 datasheet: SXM5 67, NVL 60, PCIe 51 TFLOP/s)
_PEAK_F32 = (
    ("H100 80GB HBM3", 67e12),  # H100 SXM5
    ("H100 NVL", 60e12),
    ("H100 PCIe", 51e12),
)


def device_peak_flops(device=None) -> Optional[float]:
    """float32 peak FLOP/s of a torch device (the current card when None);
    None for the CPU or a card this table does not know."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for sub, peak in _PEAK_F32:
        if sub in name:
            return peak
    return None


def mfu(ms_per_step: float, batch: int, n: int, k: int = 16,
        peak: Optional[float] = None, classes: int = 40) -> Optional[dict]:
    """{'tflops', 'mfu', 'peak_tflops'} for a measured step time; 'mfu' and
    'peak_tflops' only where the peak is known (`peak`, else the current
    card's float32 peak: device_peak_flops)."""
    peak = peak if peak is not None else device_peak_flops()
    total = attack_step_flops(batch, n, k, classes)["total"]
    achieved = total / (ms_per_step / 1e3)
    out = {"tflops": round(achieved / 1e12, 2)}
    if peak:
        out["mfu"] = round(achieved / peak, 4)
        out["peak_tflops"] = round(peak / 1e12, 1)
    return out
