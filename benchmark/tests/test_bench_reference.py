"""The plain reference and the check, on the CPU at a tiny size: the
reference agrees with itself across block sizes; a run of the port through
the harness is correct; each fault the attack cells can have, planted in
the port's timed path, makes `correct` false; and on the card, the control
(the reference in TF32 in the port's place) fails the check."""

import pytest
import torch

from benchmark import check, run, spec, weights
from benchmark.reference import attack as R


def _cell(const=10.0):
    bench = spec.benchmark()
    c = spec.cell("pointnet.attack.all", bench)
    c["config"].update(iter_max_steps=10, npoint=128)
    c["traffic"].update(instances=1, pool_batches=2, initial_const=const)
    return c, bench


def _batch(seed=5):
    from benchmark.traffic.attack import Driver
    c, _ = _cell(const=0.1)
    drv = Driver(c, seed, "cpu")
    return drv, drv.batches[0]


def test_reference_agrees_across_blocks():
    drv, bt = _batch()
    p = {k: v.double() if v.is_floating_point() else v
         for k, v in weights.make(drv.shapes, 5, "cpu").items()}
    args = (drv.spec, p, bt["pc"], bt["nrm"], bt["target"], bt["offsets"])
    a, b = R.run(*args, block=4), R.run(*args, block=9)
    for xa, xb in zip(sum(a.clouds, []), sum(b.clouds, [])):
        assert torch.allclose(xa, xb, rtol=0, atol=1e-6)
    assert torch.equal(a.success, b.success)
    ga, gb = R.judge(*args, a, block=4), R.judge(*args, a, block=9)
    for k in ("loss", "step"):
        assert torch.allclose(ga[k], gb[k], rtol=1e-6, atol=1e-12)
    # the float64 reference judged against itself reads the rounding of its
    # float32 outputs only, and its float64 gradients exactly
    assert float(ga["loss"].max()) < 2e-7
    assert float(ga["grad"].max()) < 1e-12


def _measure(const=0.1, seed=11):
    c, bench = _cell(const=const)
    return run.measure(c, bench, seed, 0.0, False, "cpu")


def test_the_port_is_correct():
    res = _measure()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from geoa3_tpu_torch.attack import engine

    orig = engine._Optimizer.update
    monkeypatch.setattr(engine._Optimizer, "update",
                        lambda self, g, st: 0 * orig(self, g, st))
    res = _measure()
    assert not res["correct"] and res["checks"]["step"]["value"] >= 0.99


def test_half_the_batch_left_out(monkeypatch):
    from geoa3_tpu_torch.attack import engine

    orig = engine.forward_losses

    def half(*a, **k):
        loss, aux = orig(*a, **k)
        n = aux.loss_n.shape[0]
        return aux.loss_n[: (n + 1) // 2].sum() / n, aux

    monkeypatch.setattr(engine, "forward_losses", half)
    res = _measure()
    assert not res["correct"] and res["checks"]["step"]["value"] >= 0.99


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    """One instance's reported loss, 1e-3 off where the step makes it."""
    from geoa3_tpu_torch.attack import engine

    orig = engine.forward_losses

    def altered(*a, **k):
        loss, aux = orig(*a, **k)
        n = aux.loss_n.detach().clone()
        n[0] *= 1 + 1e-3
        return loss, aux._replace(loss_n=n)

    monkeypatch.setattr(engine, "forward_losses", altered)
    res = _measure()
    assert not res["correct"] and res["checks"]["loss"]["value"] >= 0.9e-3


def test_a_best_cloud_altered(monkeypatch):
    """The best-tracking result of a successful instance altered: the
    judge reads 1 for it (the record made to succeed on one instance)."""
    drv, bt = _batch()
    drv.run_batch(0, record=True)
    batch, rec = drv.record
    drv.free()
    rec.success[0] = True
    rec.best_bs[0], rec.best_step[0] = 1, 3
    rec.best_attack[0] = rec.clouds[1][3][0] + 1e-3
    gaps = drv.check(drv.cell["settings"])
    assert float(gaps["loss"][-1, 0]) == 1.0


@pytest.mark.chip
def test_control_fails(card):
    """The control at a reduced size on the card: the reference computed in
    TF32 in the port's place reads above a limit."""
    from benchmark import control

    c, _ = _cell(const=0.1)
    c["config"].update(npoint=1024, iter_max_steps=20)
    c["traffic"].update(instances=4)
    nums, _ = control._stand_in(c, 21, c["settings"], "control")
    assert not check.passed(nums), nums
