"""The train traffic through a whole run on the CPU at a small batch
(b = 4): the port's first three steps against the float64 reference are
correct, and each fault a train cell can have, planted in the port's timed
path, makes `correct` false."""

import pytest
import torch

from benchmark import run, spec

B = 4


def _cell():
    cell = spec.cell("msg.train")
    cell["traffic"].update(batch=B, pool_batches=3, steps_per_call=1)
    return cell


def _measure(seed=3):
    return run.measure(_cell(), spec.benchmark(), seed, 0.0, False, "cpu")


def test_the_port_is_correct():
    res = _measure()
    assert res["correct"], res["checks"]
    assert res["metrics"]["train_samples_per_s"]["value"] > 0


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    orig = torch.optim.Adam.step

    def still(self, *a, **k):
        saved = [p.detach().clone() for g in self.param_groups for p in g["params"]]
        out = orig(self, *a, **k)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups for p in g["params"]), saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", still)
    res = _measure()
    # the running statistics still move; every parameter leaf reads 1
    assert not res["correct"] and res["checks"]["change"]["value"] >= 0.99
    assert res["checks"]["update"]["value"] >= 0.99


@pytest.mark.parametrize("what", ["gradient", "update"])
def test_a_step_that_climbs_the_loss(monkeypatch, what):
    """The gradient's sign flipped before Adam takes it, or Adam's update
    applied the wrong way: the norms are the reference's, the differences
    read about 2."""
    orig = torch.optim.Adam.step

    def climb(self, *a, **k):
        params = [p for g in self.param_groups for p in g["params"]]
        saved = [p.detach().clone() for p in params]
        if what == "gradient":
            for p in params:
                p.grad.neg_()
        out = orig(self, *a, **k)
        if what == "update":
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(2 * s - p)
        return out

    monkeypatch.setattr(torch.optim.Adam, "step", climb)
    res = _measure()
    name = "grad_diff" if what == "gradient" else "update"
    assert not res["correct"] and res["checks"][name]["value"] >= 1.5


def test_half_the_batch_left_out(monkeypatch):
    from geoa3_tpu_torch import train as T

    orig = T.smoothing_cross_entropy

    def half(logits, target, classes, smoothing=0.2):
        n = logits.shape[0] // 2
        return orig(logits[:n], target[:n], classes, smoothing)

    monkeypatch.setattr(T, "smoothing_cross_entropy", half)
    res = _measure()
    assert not res["correct"] and res["checks"]["grad"]["value"] > 0.1


def test_a_loss_altered_where_it_is_produced(monkeypatch):
    from geoa3_tpu_torch import train as T

    orig = T.make_train_step

    def altered(*a, **k):
        step = orig(*a, **k)

        def run_step(*args, **kw):
            state, m = step(*args, **kw)
            return state, dict(m, loss=m["loss"] * (1 + 1e-3))
        return run_step

    monkeypatch.setattr(T, "make_train_step", altered)
    res = _measure()
    assert not res["correct"] and res["checks"]["loss"]["value"] >= 0.9e-3


@pytest.mark.chip
def test_control_fails(card):
    """The control on the card at the cell's size reads above a limit."""
    from benchmark import check
    from benchmark.traffic.train import Driver
    cell = spec.cell("msg.train")
    drv = Driver(cell, 5, card)
    drv.control(0)
    drv.free()
    assert not check.passed(check.numbers(drv.check(cell["settings"]), cell["settings"]))
