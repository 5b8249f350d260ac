"""The harness's arithmetic on made-up inputs: the rate over whole batches
and the whole window, the trace's busy and idle time, the kernel groups and
the roofline share (a group that matches nothing drops out of both sums)."""

import sys
import time
import types

import pytest

from benchmark import layers, plugins, run, spec


class _Fake:
    """A driver whose batches take a fixed time."""

    steps_per_batch = 10

    def __init__(self, cell, seed, device):
        self.calls = []

    def sync(self):
        pass

    def run_batch(self, i, record=False):
        time.sleep(0.05)
        self.calls.append((i, record))

    def rate(self, steps, window_s):
        return {"attacks_per_s": 9 * steps / (5000 * window_s)}

    def clouds_per_batch(self):
        return 9

    def free(self):
        pass

    def check(self, settings):
        import torch
        return {"loss": torch.zeros(2, 3)}


@pytest.fixture
def fake(monkeypatch):
    mod = types.ModuleType("benchmark.traffic.fake")
    mod.Driver = _Fake
    monkeypatch.setitem(sys.modules, "benchmark.traffic.fake", mod)
    bench = spec.benchmark()
    cell = {"name": "pointnet.attack.all", "workload": {"chips": 1},
            "traffic": {"driver": "fake"},
            "settings": {"sample_batches": 2,
                         "limits": {"loss": {"stat": "max", "limit": 0.0}}}}
    return cell, bench


def test_rate_over_whole_batches(fake):
    cell, bench = fake
    t0 = time.perf_counter()
    res = run.measure(cell, bench, 3, 0.12, False, "cpu")
    took = time.perf_counter() - t0
    rate = res["metrics"]["attacks_per_s"]["value"]
    batches = res["attempted"] // 9
    assert batches == 3  # 0.15 s of whole batches reach 0.12 s
    window = 9 * batches * 10 / (5000 * rate)
    assert 0.15 <= window <= took
    assert res["correct"] and res["failed"] == 0


def test_sampled_batch_runs_in_a_short_window(fake):
    cell, bench = fake
    res = run.measure(cell, bench, 1, 0.0, False, "cpu")  # seed 1 samples batch 1
    assert res["attempted"] == 18


def _summary():
    return {"window_s": 1.0, "busy_s": 0.6, "steps": 10,
            "kernels": {"void pool_fwd_kernel<3>(float const*)": (0.2, 30),
                        "nn1_tile_kernel": (0.1, 10),
                        "ampere_sgemm_128x64_nn": (0.1, 20),
                        "some_new_kernel": (0.2, 10)},
            "device_ops": 70, "idle": {}}


def test_groups_and_roofline():
    groups = plugins.groups()
    s = _summary()
    by = plugins.classify(s, groups)
    assert by["pool_fwd"] == (0.2, 30) and by["nn1"] == (0.1, 10)
    assert by["matmul"] == (0.1, 20) and by["other"] == (0.2, 10)
    layout = dict(kind="attack", arch="PointNet", b=288, n=1024, k=16, refresh=10,
                  batch_steps=200, classes=40, config=spec.cell("pointnet.attack.all")["config"])
    rates = (67e12, 3.35e12)
    ctx = dict(summary=s, layout=layout, step_flops=1e12, peaks=rates, groups=groups,
               by_group=by)
    g = {m.NAME: m for m in groups}
    want = 100 * 10 * (g["pool_fwd"].bound_s(layout, rates)
                       + g["nn1"].bound_s(layout, rates)) / 0.3
    assert layers.roofline_percent(ctx, "attack") == pytest.approx(want)
    # a group that ran nothing (pool_bwd) is in neither sum; unknown kernels
    # and library products are not the program's
    assert g["pool_bwd"].bound_s(layout, rates) > 0
    assert layers.idle_share(ctx, "attack") == pytest.approx(0.4)
    assert layers.mfu_percent(ctx, "attack") == pytest.approx(100 * 1e13 / 67e12)
    assert layers.layer_ms_per_step(ctx, "victim") == pytest.approx(1e3 * 0.3 / 10)
    assert layers.layer_ms_per_step(ctx, "losses") == pytest.approx(1e3 * 0.1 / 10)
    assert layers.idle_share(ctx, "train") is None


def test_roofline_silent_without_a_port_kernel():
    groups = plugins.groups()
    s = dict(_summary(), kernels={"some_new_kernel": (0.2, 10)})
    ctx = dict(summary=s, layout=dict(kind="attack", arch="PointNet", b=1, n=64, k=16,
                                      refresh=10, batch_steps=20, classes=40,
                                      config=spec.cell("pointnet.attack.all")["config"]),
               step_flops=1.0, peaks=(67e12, 3.35e12), groups=groups,
               by_group=plugins.classify(s, groups))
    assert layers.roofline_percent(ctx, "attack") is None


def test_bounds_never_exceed_the_work():
    # each PointNet group's bound is at least its bytes' or flops' share
    layout = dict(kind="attack", arch="PointNetPP_MSG", b=36, n=1024, k=16, refresh=10,
                  batch_steps=200, classes=40, config=spec.cell("msg.attack.all")["config"])
    for g in plugins.groups():
        b = g.bound_s(layout, (67e12, 3.35e12))
        assert b is None or b >= 0


@pytest.mark.parametrize("cell", ["pointnet.attack.all", "msg.attack.all"])
def test_the_configuration_states_the_programs_shapes(cell):
    """The program's victim has exactly the state dict the configuration
    file states, and a width changed in the file fails the run's set-up."""
    import copy

    from geoa3_tpu_torch import build_model

    from benchmark import arch

    cfg = spec.cell(cell)["config"]
    model = build_model(cfg["arch"], cfg["classes"], cfg["npoint"], device="cpu")
    assert len(arch.check_model(model, cfg)) == len(model.state_dict())
    wider = copy.deepcopy(cfg)
    if cfg["arch"] == "PointNet":
        wider["conv5"]["width"] = 512
    else:
        wider["sa2"]["mlps"][1][2] = 128
    with pytest.raises(RuntimeError, match="differs"):
        arch.check_model(model, wider)


def test_flops_and_bounds_follow_the_configuration():
    import copy

    from benchmark import flops

    layout = dict(kind="attack", arch="PointNetPP_MSG", b=36, n=1024, k=16, refresh=10,
                  batch_steps=200, classes=40, config=spec.cell("msg.attack.all")["config"])
    g = {m.NAME: m for m in plugins.groups()}
    rates = (67e12, 3.35e12)
    narrow = dict(layout, config=copy.deepcopy(layout["config"]))
    narrow["config"]["group_all"][1] = 256
    narrow["config"]["sa1"]["nsamples"][2] = 64
    assert flops.attack_step(narrow["config"], 36) < flops.attack_step(layout["config"], 36)
    for name in ("group_mlp_fwd", "group_mlp_bwd", "ballquery_fwd"):
        assert g[name].bound_s(narrow, rates) < g[name].bound_s(layout, rates)
    # the counts at the published widths: PointNet 1.59 GFLOP a cloud-step
    assert flops.attack_step(spec.cell("pointnet.attack.all")["config"], 1) == pytest.approx(
        1.58791168e9)
