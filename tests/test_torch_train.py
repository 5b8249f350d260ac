"""The port's trainer (geoa3_tpu_torch/train.py) against the JAX package's
(geoa3_tpu/train.py), on the CPU.

Weights come from the JAX trainer's initial state with random BatchNorm
parameters and statistics (and, for PointNet, T-Net output layers away from
zero, so that the T-Nets' gradients are not 0), carried across by
models.convert; the dropout masks are read from the JAX train-mode apply (an
entry is kept where the dropout's output is nonzero) and fed to the port.
One train step is held piece by piece, not by its parameters: Adam's first
step is about lr * sign(g), and some gradients are 0 in exact arithmetic
(the biases that a BatchNorm follows, and the BatchNorm biases before a max
pool whose output meets a BatchNorm), so their float noise decides a +-lr
step. Held: the loss (1e-5 relative), the logits (1e-5 of the largest), each
gradient tensor (1e-4 of its largest entry; for the vanishing ones, 1e-4 of
1e-2 times the model's largest gradient entry), the new running statistics
(1e-5 relative: at b = 2 the unbiased variance rule would be 2x off), and
the optimiser on its own, fed one gradient sequence on both sides (1e-6).

PointNet at 4 classes, 32 points, b = 4; PointNet++ as
tests/test_torch_pointnetpp.py sizes it (b = 2, 1024 points, 10 classes).
Both sides run the step in float64: at these batch sizes a float32 step is
ill-conditioned (the BatchNorms over 2-4 rows in the heads), so float32
cannot tell a wrong function from rounding. Measured on PointNet at b = 4:
the port's own float32 gradients are 1e-4 to 4e-4 of each tensor's largest
from its float64 ones; on PointNet++ at b = 2 the JAX package's float32
gradients are 17-36% from its float64 ones, the port's 13%. In float64 the
two packages agree to ~4e-8 (the float32 rounding of the carried-across
values).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

import geoa3_tpu.train as JT
from geoa3_tpu.data.modelnet_train import SyntheticTrainDataset as JSynthetic
from geoa3_tpu_torch import train as T
from geoa3_tpu_torch.data import modelnet_train as tdata
from geoa3_tpu_torch.data.modelnet_train import SyntheticTrainDataset
from geoa3_tpu_torch.models import build_model
from geoa3_tpu_torch.models.convert import (
    adam_state_from_optax,
    from_flax_variables,
    load_reference_state_dict,
)
from geoa3_tpu_torch.models.layers import batch_norm, dropout
from geoa3_tpu_torch.utils.checkpoint import (
    BEST_NAME,
    CKPT_NAME,
    load_checkpoint,
    save_checkpoint,
)
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(2)

PN = dict(arch="PointNet", classes=4, npoint=32, batch_size=4)
PP = dict(classes=10, npoint=1024, batch_size=2)


def _cfgs(**kw):
    return JT.TrainConfig(**kw), T.TrainConfig(device="cpu", **kw)


def _variables(jcfg, seed):
    """The JAX trainer's initial state, its BatchNorm made non-trivial and
    PointNet's T-Net output layers moved off their zero kernel."""
    state = JT.init_state(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    params = _randomise_bn(jax.tree.map(np.asarray, state.params), rng)
    for tnet in ("input_transform", "feature_transform"):
        if tnet in params:
            k = params[tnet]["fc3"]["kernel"]
            params[tnet]["fc3"]["kernel"] = (0.01 * rng.randn(*k.shape)).astype(np.float32)
    return {
        "params": params,
        "batch_stats": _randomise_bn(jax.tree.map(np.asarray, state.batch_stats), rng),
    }


def _clouds(b, n, seed):
    rng = np.random.RandomState(seed)
    pc = rng.randn(b, n, 3).astype(np.float32)
    return pc / np.linalg.norm(pc, axis=-1).max()


_JAX_STEPS = {}


def _jax_grad_fn(jcfg, epoch=1, x64=False):
    """value_and_grad of the JAX train step's loss (geoa3_tpu/train.py:
    126-150) -> (loss, (logits, new batch_stats, dropout outputs)), grads."""
    key = (jcfg, epoch, x64)
    if key in _JAX_STEPS:
        return _JAX_STEPS[key]
    model = JT._build(jcfg, epoch)

    def loss_fn(params, batch_stats, pc, target, rng):
        out, mutated = model.apply(
            {"params": params, "batch_stats": batch_stats}, pc, train=True,
            mutable=["batch_stats", "intermediates"], rngs={"dropout": rng},
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
        logits, transform = out if jcfg.arch == "PointNet" else (out, None)
        loss = JT.smoothing_cross_entropy(logits, target, jcfg.classes,
                                          jcfg.label_smoothing)
        if transform is not None:
            eye = jnp.eye(transform.shape[1], dtype=transform.dtype)[None]
            mat_diff = jnp.einsum("bij,bkj->bik", transform, transform) - eye
            loss = loss + 0.001 * jnp.sum(mat_diff**2) / 2
        return loss, (logits, mutated["batch_stats"], mutated["intermediates"])

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    _JAX_STEPS[key] = fn
    return fn


def _keep_masks(jcfg, inter):
    """The dropout keep masks of the JAX apply, in the port's `keep` form."""
    def kept(tree):
        return torch.from_numpy(np.asarray(tree["__call__"][0]) != 0)

    if jcfg.arch == "PointNet":
        return (kept(inter["Dropout_0"]), kept(inter["Dropout_1"]))
    return kept(inter["head"]["Dropout_0"])


def _jax_step(jcfg, variables, pc, target, seed, epoch=1, x64=False):
    """One JAX train-mode loss and gradient, in float64 with `x64`."""
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        v = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)
        (loss, (logits, stats, inter)), grads = _jax_grad_fn(jcfg, epoch, x64)(
            v["params"], v["batch_stats"], jnp.asarray(pc, dt),
            jnp.asarray(target), jax.random.PRNGKey(seed))
        tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        return dict(loss=float(loss), logits=np.asarray(logits),
                    grads=tree(grads), stats=tree(stats),
                    keep=_keep_masks(jcfg, inter))


def _port_model(tcfg, variables):
    model = build_model(tcfg.arch, tcfg.classes, tcfg.npoint, device="cpu")
    load_reference_state_dict(model, from_flax_variables(variables))
    return model.train()


def _port_step(tcfg, model, pc, target, keep, epoch=1):
    """The port's train loss and its backward, at the epoch's BN momentum."""
    state = T.TrainState(model, T.make_optimizer(tcfg, model, epoch))
    T.set_epoch(tcfg, state, epoch)
    model.zero_grad(set_to_none=True)
    dt = next(model.parameters()).dtype
    loss, logits = T.train_loss(tcfg, model, torch.from_numpy(pc).to(dt),
                                torch.from_numpy(target).long(), keep=keep)
    loss.backward()
    return loss, logits


def _vanishing(name):
    """Gradients that are 0 in exact arithmetic, or nearly: the biases that
    a BatchNorm follows (PointNet's conv1-conv5, fc1, fc2 and the T-Nets'
    layers before their BatchNorms; PointNet++'s layers carry none), and the
    BatchNorm biases before a max pool whose output meets a BatchNorm
    (PointNet's bn5 and T-Net bn3; each PointNet++ scale's last one): their
    gradient sums a BatchNorm's input gradient over the batch, 0 where every
    pooled value of the channel is active."""
    if name.startswith(("SA_modules", "fc_layer")):
        return name.endswith(".7.bias") and name.startswith("SA_modules")
    if name in ("bn5.bias", "input_transform.bn3.bias", "feature_transform.bn3.bias"):
        return True
    return name.endswith(".bias") and "bn" not in name and "fc3" not in name


def _hold_step(tcfg, variables, want, model, loss, logits):
    np.testing.assert_allclose(float(loss.detach()), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"],
                               rtol=0, atol=1e-5 * np.abs(want["logits"]).max())
    gsd = from_flax_variables({"params": want["grads"],
                               "batch_stats": want["stats"]})
    gmax = max(np.abs(v.numpy()).max() for k, v in gsd.items()
               if not k.endswith(("running_mean", "running_var", "tracked")))
    worst = {}
    for name, p in model.named_parameters():
        w = gsd[name].numpy()
        scale = np.abs(w).max()
        if _vanishing(name):
            scale = max(scale, 1e-2 * gmax)
        err = np.abs(p.grad.numpy() - w).max()
        worst[name] = err / scale
        assert err <= 1e-4 * scale, (name, err, scale)
    ssd = from_flax_variables({"params": variables["params"],
                               "batch_stats": want["stats"]})
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), ssd[name].numpy(), rtol=1e-5,
                                       atol=1e-5 * np.abs(ssd[name].numpy()).max(),
                                       err_msg=name)
    return worst


@pytest.fixture(scope="module")
def pointnet_setup():
    jcfg, tcfg = _cfgs(**PN)
    return jcfg, tcfg, _variables(jcfg, 0)


def test_schedules_and_smoothing_ce_match_jax():
    for e in (0, 1, 19, 20, 39, 40, 500, 2000):
        assert T.lr_for_epoch(1e-3, e) == JT.lr_for_epoch(1e-3, e)
        assert T.lr_for_epoch(2e-3, e, 7) == JT.lr_for_epoch(2e-3, e, 7)
        assert T.bn_momentum_for_epoch(0.5, e) == JT.bn_momentum_for_epoch(0.5, e)
    rng = np.random.RandomState(0)
    for classes, s in ((5, 0.2), (40, 0.2), (10, 0.0), (7, 0.5)):
        logits = (3 * rng.randn(6, classes)).astype(np.float32)
        target = rng.randint(0, classes, 6)
        got = float(T.smoothing_cross_entropy(torch.from_numpy(logits),
                                              torch.from_numpy(target), classes, s))
        want = float(JT.smoothing_cross_entropy(jnp.asarray(logits),
                                                jnp.asarray(target), classes, s))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
    with pytest.raises(ValueError, match="classes"):
        T.smoothing_cross_entropy(torch.zeros(2, 5), torch.zeros(2), 4)


def test_pointnet_train_step_matches_jax(pointnet_setup):
    jcfg, tcfg, variables = pointnet_setup
    pc = _clouds(4, 32, 3).astype(np.float64)
    target = np.asarray([0, 1, 2, 3], np.int32)
    want = _jax_step(jcfg, variables, pc, target, seed=5, x64=True)
    assert any(not k.all() for k in want["keep"]), "no entry dropped"
    model = _port_model(tcfg, variables).double()
    loss, logits = _port_step(tcfg, model, pc, target, want["keep"])
    worst = _hold_step(tcfg, variables, want, model, loss, logits)
    assert max(worst.values()) > 0  # the comparison saw the gradients


def test_pointnet_step_later_epoch_matches_jax(pointnet_setup):
    """Epoch 21: the BatchNorm momentum has halved (0.25, flax 0.75)."""
    jcfg, tcfg, variables = pointnet_setup
    pc = _clouds(4, 32, 7).astype(np.float64)
    target = np.asarray([3, 2, 1, 0], np.int32)
    want = _jax_step(jcfg, variables, pc, target, seed=8, epoch=21, x64=True)
    model = _port_model(tcfg, variables).double()
    loss, logits = _port_step(tcfg, model, pc, target, want["keep"], epoch=21)
    assert model.bn1.momentum == 0.25
    _hold_step(tcfg, variables, want, model, loss, logits)


@pytest.fixture(scope="module")
def ssg_setup():
    jcfg, tcfg = _cfgs(arch="PointNetPP", **PP)
    return jcfg, tcfg, _variables(jcfg, 0)


@pytest.mark.parametrize("arch", ["PointNetPP", "PointNetPP_MSG"])
def test_pointnetpp_train_step_matches_jax(arch):
    """FPS, the ball query, the grouping, the unfused shared MLPs with the
    train-mode BatchNorm, GroupAll and the head's dropout, in float64 on
    both sides."""
    jcfg, tcfg = _cfgs(arch=arch, **PP)
    variables = _variables(jcfg, 2)
    pc = _clouds(2, 1024, 9)
    target = np.asarray([4, 0], np.int32)
    want = _jax_step(jcfg, variables, pc.astype(np.float64), target, seed=3,
                     x64=True)
    assert not want["keep"].all(), "no entry dropped"
    model = _port_model(tcfg, variables).double()
    loss, logits = _port_step(tcfg, model, pc, target, want["keep"])
    assert loss.dtype == torch.float64
    _hold_step(tcfg, variables, want, model, loss, logits)


def _optax_run(jcfg, params, grads_seq, opt_state=None):
    tx = JT.make_optimizer(jcfg, epoch=1)
    opt_state = tx.init(params) if opt_state is None else opt_state
    for g in grads_seq:
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    return params, opt_state


def _grads_like(params, rng, scale):
    return jax.tree.map(
        lambda p: jnp.asarray((scale * rng.randn(*p.shape)).astype(np.float32)),
        params)


@pytest.mark.parametrize("carried", [False, True], ids=["fresh", "carried"])
def test_optimizer_matches_optax(pointnet_setup, carried):
    """Three steps of the port's Adam + L2 on the same gradients as optax's,
    from a fresh state and from one carried across after five steps."""
    jcfg, tcfg, variables = pointnet_setup
    rng = np.random.RandomState(11)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = None
    if carried:
        params, opt_state = _optax_run(
            jcfg, params, [_grads_like(params, rng, 0.1) for _ in range(5)])
    start = jax.tree.map(np.asarray, params)
    grads = [_grads_like(params, rng, s) for s in (0.05, 1e-4, 0.3)]
    want, _ = _optax_run(jcfg, params, grads, opt_state)

    model = _port_model(tcfg, {"params": start,
                               "batch_stats": variables["batch_stats"]})
    opt = T.make_optimizer(tcfg, model, epoch=1)
    if carried:
        opt.load_state_dict({"state": adam_state_from_optax(opt_state, model),
                             "param_groups": opt.state_dict()["param_groups"]})
        assert float(opt.state[next(model.parameters())]["step"]) == 5
    for g in grads:
        gsd = from_flax_variables({"params": jax.tree.map(np.asarray, g),
                                   "batch_stats": variables["batch_stats"]})
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        opt.step()
    wsd = from_flax_variables({"params": jax.tree.map(np.asarray, want),
                               "batch_stats": variables["batch_stats"]})
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), wsd[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_adam_state_from_optax_maps_every_parameter(ssg_setup):
    jcfg, tcfg, variables = ssg_setup
    params = jax.tree.map(jnp.asarray, variables["params"])
    rng = np.random.RandomState(2)
    _, opt_state = _optax_run(jcfg, params, [_grads_like(params, rng, 1.0)])
    model = _port_model(tcfg, variables)
    state = adam_state_from_optax(opt_state, model)
    assert len(state) == len(list(model.parameters()))
    nu = from_flax_variables({
        "params": jax.tree.map(np.asarray, opt_state[1][0].nu),
        "batch_stats": variables["batch_stats"]})
    for i, (name, p) in enumerate(model.named_parameters()):
        assert state[i]["exp_avg"].shape == p.shape
        assert torch.equal(state[i]["exp_avg_sq"], nu[name])
        assert float(state[i]["step"]) == 1
    with pytest.raises(ValueError, match="no Adam state"):
        adam_state_from_optax((), model)


def test_one_cloud_last_batch_matches_jax(pointnet_setup):
    """A dataset of 5 clouds at batch 4 (the same synthetic clouds on both
    sides) trains through its one-cloud last batch, in float64. Before each
    step the port's weights are carried into the JAX model, so each step's
    running statistics come from the same weights; at b = 1 the head's
    BatchNorms see one value a channel and normalise to 0, as flax does."""
    from geoa3_tpu.models.convert import convert_pointnet_state_dict

    jcfg, tcfg, variables = pointnet_setup
    kw = dict(num_per_class=5, classes=1, batch_size=4, npoints=32, seed=3)
    jds, tds = JSynthetic(**kw), SyntheticTrainDataset(**kw)
    model = _port_model(tcfg, variables).double()
    state = T.TrainState(model, T.make_optimizer(tcfg, model))
    step = T.make_train_step(tcfg, epoch=1)
    sizes = []
    jds.reset()
    tds.reset()
    while tds.has_next_batch():
        points, target = tds.next_batch(False)
        jpoints, jtarget = jds.next_batch(False)
        np.testing.assert_array_equal(points, jpoints)
        pc = T._prep_batch(tcfg, points).astype(np.float64)
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        jvars = jax.tree.map(np.asarray, convert_pointnet_state_dict(sd))
        want = _jax_step(jcfg, jvars, pc, target, seed=len(sizes), x64=True)
        state, metrics = step(state, torch.from_numpy(pc),
                              torch.from_numpy(target).long(), keep=want["keep"])
        np.testing.assert_allclose(float(metrics["loss"]), want["loss"], rtol=1e-5)
        ssd = from_flax_variables({"params": jvars["params"],
                                   "batch_stats": want["stats"]})
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(
                    buf.numpy(), ssd[name].numpy(), rtol=1e-5,
                    atol=1e-5 * np.abs(ssd[name].numpy()).max(), err_msg=name)
        assert all(torch.isfinite(p).all() for p in model.parameters())
        sizes.append(len(target))
    assert sizes == [4, 1] and state.step == 2


def test_batch_norm_of_one_row_is_flax_zero():
    bn = torch.nn.BatchNorm1d(3, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([2.0, 3.0, 4.0]))
        bn.bias.copy_(torch.tensor([0.5, -1.0, 0.0]))
    x = torch.tensor([[1.0, -2.0, 7.0]], requires_grad=True)
    y = batch_norm(x, bn, training=True)
    assert torch.equal(y.detach(), bn.bias.detach()[None])
    y.sum().backward()
    assert torch.equal(x.grad, torch.zeros_like(x))
    # flax's update: 0.9 * old + 0.1 * batch (torch momentum 0.1)
    torch.testing.assert_close(bn.running_mean, 0.1 * x.detach()[0], rtol=1e-6, atol=0)
    torch.testing.assert_close(bn.running_var, torch.full((3,), 0.9), rtol=1e-6, atol=0)


def test_dropout_keeps_its_mask_and_draws_from_the_generator():
    x = torch.ones(64, 256)
    g = torch.Generator().manual_seed(4)
    a = dropout(x, 0.3, True, torch.Generator().manual_seed(4))
    b = dropout(x, 0.3, True, g)
    assert torch.equal(a, b) and not torch.equal(dropout(x, 0.3, True, g), a)
    kept = (a != 0).float().mean().item()
    assert 0.65 < kept < 0.75 and torch.allclose(a[a != 0], torch.tensor(1 / 0.7))
    keep = torch.rand(64, 256) < 0.5
    assert torch.equal(dropout(x, 0.5, True, keep=keep), torch.where(keep, 2.0, 0.0))
    assert dropout(x, 0.3, False) is x
    with pytest.raises(ValueError, match="keep mask"):
        dropout(x, 0.3, True, keep=keep[:2])


@pytest.mark.parametrize("arch", ["PointNet", "PointNetPP"])
def test_eval_after_a_step_equals_a_fresh_load(arch):
    """The eval-mode fold caches see the optimiser's and the BatchNorm's
    in-place updates: eval after a step equals a fresh model loaded with the
    stepped state_dict."""
    npoint = 32 if arch == "PointNet" else 1024
    tcfg = T.TrainConfig(arch=arch, classes=10, npoint=npoint, batch_size=2,
                         device="cpu")
    gen = torch.Generator().manual_seed(1)
    state = T.init_state(tcfg, gen)
    pc = torch.from_numpy(_clouds(2, npoint, 2))
    target = torch.tensor([1, 2])
    step, ev = T.make_train_step(tcfg), T.make_eval_step(tcfg)
    _, before = ev(state, pc, target)
    before_logits = state.model(pc)
    state, _ = step(state, pc, target, gen)
    state.model.eval()
    after = state.model(pc)
    fresh = build_model(arch, 10, npoint, device="cpu")
    fresh.load_state_dict(state.model.state_dict())
    assert not torch.equal(after, before_logits)
    assert torch.equal(after, fresh(pc))


def test_init_follows_flax_initialisers():
    tcfg = T.TrainConfig(arch="PointNet", classes=40, npoint=64, device="cpu")
    state = T.init_state(tcfg, torch.Generator().manual_seed(0))
    m = state.model
    assert m.training
    w = m.conv5.weight
    std = (3 * 128) ** -0.5 / 0.87962566103423978
    assert w.abs().max() <= 2 * std and 0.8 * std < w.std() < 1.0 * std
    assert torch.count_nonzero(m.conv5.bias) == 0
    assert torch.equal(m.feature_transform.fc3.bias.reshape(64, 64), torch.eye(64))
    assert torch.count_nonzero(m.feature_transform.fc3.weight) == 0
    assert torch.equal(m.bn5.running_var, torch.ones(1024))
    again = T.init_state(tcfg, torch.Generator().manual_seed(0)).model
    assert torch.equal(again.conv5.weight, w)


def _datasets(mod, **kw):
    base = dict(classes=4, batch_size=8, npoints=32)
    base.update(kw)
    return (mod.SyntheticTrainDataset(num_per_class=8, **base),
            mod.SyntheticTrainDataset(num_per_class=4, split="test", **base))


def test_checkpoint_round_trip(tmp_path):
    state = {"epoch": 3, "state_dict": {"w": torch.arange(6.0).reshape(2, 3)},
             "optimizer": {"state": {}, "param_groups": [{"lr": 1e-3, "params": [0]}]},
             "best_prec": 91.5, "class_prec": 90.0}
    path = save_checkpoint(str(tmp_path), state, is_best=True)
    assert path.endswith(CKPT_NAME) and not (tmp_path / (CKPT_NAME + ".tmp")).exists()
    back = load_checkpoint(str(tmp_path))
    assert back["epoch"] == 3 and torch.equal(back["state_dict"]["w"],
                                              state["state_dict"]["w"])
    best = load_checkpoint(str(tmp_path), best=True)
    assert best["best_prec"] == 91.5
    state["epoch"] = 4
    save_checkpoint(str(tmp_path), state, is_best=False)
    assert load_checkpoint(str(tmp_path))["epoch"] == 4
    assert load_checkpoint(str(tmp_path), best=True)["epoch"] == 3
    assert load_checkpoint(str(tmp_path / "nowhere")) is None


@pytest.mark.parametrize("arch", ["PointNet", "PointNetPP"])
def test_jax_package_reads_the_ports_best_checkpoint(tmp_path, arch):
    """The trainer's model_best.pth.tar, read by the JAX package's victim
    loader, gives the port's eval logits."""
    from geoa3_tpu.models.registry import build_model as jbuild
    from geoa3_tpu.utils.checkpoint import load_victim_variables

    npoint = 32 if arch == "PointNet" else 1024
    tcfg = T.TrainConfig(arch=arch, classes=4, npoint=npoint, batch_size=8,
                         epochs=1, device="cpu")
    train_ds, test_ds = _datasets(tdata, npoints=npoint)
    state, _ = T.train(tcfg, train_ds, test_ds, modeldir=str(tmp_path),
                       log=lambda s: None)
    assert (tmp_path / BEST_NAME).is_file() and (tmp_path / CKPT_NAME).is_file()
    variables = load_victim_variables(str(tmp_path / BEST_NAME), arch=arch)
    pc = _clouds(2, npoint, 5)
    want = state.model(torch.from_numpy(pc)).detach().numpy()
    got = np.asarray(jbuild(arch, 4, npoint).apply(variables, jnp.asarray(pc),
                                                    train=False))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_resume_continues_training(tmp_path):
    """--resume restores epoch, best and optimiser, and continues (reference
    :167-178)."""
    tcfg = T.TrainConfig(arch="PointNet", classes=4, npoint=32, batch_size=8,
                         epochs=2, device="cpu")
    ds, ds_test = _datasets(tdata)
    state1, _ = T.train(tcfg, ds, ds_test, modeldir=str(tmp_path), log=lambda s: None)
    assert state1.step == 8
    cfg3 = dataclasses.replace(tcfg, epochs=3)
    logs = []
    state2, _ = T.train(cfg3, ds, ds_test, modeldir=str(tmp_path),
                        log=logs.append, resume=str(tmp_path))
    assert any("loaded checkpoint" in line for line in logs)
    assert sum("epoch [" in line for line in logs) == 1
    ckpt = load_checkpoint(str(tmp_path))
    assert ckpt["epoch"] == 3
    assert float(next(iter(ckpt["optimizer"]["state"].values()))["step"]) == 12
    assert len((tmp_path / "result.txt").read_text().splitlines()) == 3


def test_epoch_retry_on_transient_failure(tmp_path, monkeypatch):
    """A failed epoch is retried from the last good host copy."""
    tcfg = T.TrainConfig(arch="PointNet", classes=4, npoint=32, batch_size=8,
                         epochs=3, device="cpu")
    ds, ds_test = _datasets(tdata)
    real_make = T.make_train_step
    calls = {"n": 0}
    boom = {"armed": 2}

    def flaky_make(cfg_, epoch):
        step = real_make(cfg_, epoch)

        def wrapped(state, pc, target, generator=None, keep=None):
            calls["n"] += 1
            if calls["n"] >= 6 and boom["armed"] > 0:
                boom["armed"] -= 1
                raise RuntimeError("injected transient device failure")
            return step(state, pc, target, generator, keep)

        return wrapped

    monkeypatch.setattr(T, "make_train_step", flaky_make)
    logs = []
    state, _ = T.train(tcfg, ds, ds_test, modeldir=str(tmp_path), log=logs.append)
    assert len([line for line in logs if "retrying from last good state" in line]) == 2
    assert sum("epoch [" in line for line in logs) == 3
    assert load_checkpoint(str(tmp_path))["epoch"] == 3
    # the retried epochs restarted from the copy: 12 steps kept, not more
    assert float(next(iter(state.optimizer.state.values()))["step"]) == 12


def test_epoch_retry_exhaustion_raises(tmp_path, monkeypatch):
    tcfg = T.TrainConfig(arch="PointNet", classes=4, npoint=32, batch_size=8,
                         epochs=2, max_epoch_retries=1, device="cpu")
    ds, ds_test = _datasets(tdata)

    def always_fail(cfg_, epoch):
        def wrapped(state, pc, target, generator=None, keep=None):
            raise RuntimeError("permanent failure")

        return wrapped

    monkeypatch.setattr(T, "make_train_step", always_fail)
    with pytest.raises(RuntimeError, match="permanent failure"):
        T.train(tcfg, ds, ds_test, modeldir=str(tmp_path), log=lambda s: None)


def _train_argv(tmp_path, *extra):
    return ["--datadir", "synthetic:4:2", "-c", "4", "--npoint", "32", "-b", "4",
            "--modeldir", str(tmp_path / "model"), "--device", "cpu", *extra]


def test_main_train_cli_trains_saves_and_resumes(tmp_path):
    """The CLI on tiny synthetic data, on the CPU: one result.txt line an
    epoch, both checkpoint files, then a resume to epoch 3."""
    from geoa3_tpu_torch.cli import main_train

    parser = main_train.build_parser()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_train.main(parser.parse_args(_train_argv(tmp_path)[:-2]))
    result = main_train.main(parser.parse_args(_train_argv(tmp_path, "--epochs", "2")))
    model_dir = tmp_path / "model"
    lines = (model_dir / "result.txt").read_text().splitlines()
    assert len(lines) == 2 and all("train-acc" in line and "test:" in line
                                   for line in lines)
    assert 0.0 <= result["best_prec"] <= 100.0
    ckpt = load_checkpoint(str(model_dir))
    assert ckpt["epoch"] == 2 and set(ckpt) == {
        "epoch", "state_dict", "optimizer", "best_prec", "class_prec"}
    assert load_checkpoint(str(model_dir), best=True)["best_prec"] == result["best_prec"]
    main_train.main(parser.parse_args(_train_argv(
        tmp_path, "--epochs", "3", "--resume", str(model_dir))))
    assert len((model_dir / "result.txt").read_text().splitlines()) == 3
    assert load_checkpoint(str(model_dir))["epoch"] == 3


def test_readiness_cli_on_a_trained_checkpoint(tmp_path):
    """readiness on the port's model_best.pth.tar and a small attack set:
    convert and attack_smoke PASS, torch_parity and clean_acc SKIP with
    their reasons, exit 0; a broken checkpoint FAILs with exit 1."""
    import json

    import scipy.io as sio

    from geoa3_tpu_torch.cli import main_train, readiness
    from geoa3_tpu_torch.data.synthetic import sample_shape

    main_train.main(main_train.build_parser().parse_args(
        _train_argv(tmp_path, "--epochs", "1")))
    rng = np.random.RandomState(0)
    pcs, nrms = zip(*(sample_shape(i, 32, rng) for i in range(3)))
    mat = tmp_path / "set.mat"
    sio.savemat(mat, {"data": np.stack(pcs).transpose(0, 2, 1),
                      "normal": np.stack(nrms).transpose(0, 2, 1),
                      "label": np.asarray([[0, 1, 2]])})
    argv = ["--checkpoint", str(tmp_path / "model" / BEST_NAME), "--classes", "4",
            "--npoint", "32", "--data_dir_file", str(mat), "--device", "cpu",
            "--out", str(tmp_path / "report.json")]
    parser = readiness.build_parser()
    assert readiness.main(parser.parse_args(argv)) == 0
    steps = json.loads((tmp_path / "report.json").read_text())["steps"]
    assert {k: v["status"] for k, v in steps.items()} == {
        "convert": "PASS", "torch_parity": "SKIP", "clean_acc": "SKIP",
        "attack_smoke": "PASS"}
    assert "--reference_dir" in steps["torch_parity"]["detail"]
    assert "--modelnet_root" in steps["clean_acc"]["detail"]
    broken = tmp_path / "broken.pth.tar"
    torch.save({"state_dict": {"conv1.weight": torch.zeros(2)}}, broken)
    argv[1] = str(broken)
    assert readiness.main(parser.parse_args(argv)) == 1
    assert readiness.main(parser.parse_args(["--device", "cpu"])) == 0


def test_fp_module_train_mode_matches_jax():
    """PointnetFPModule in train mode (its shared MLP with the train-mode
    BatchNorm): output, input gradients and new running statistics against
    the JAX module's train-mode apply, in float64."""
    from geoa3_tpu.models.pointnetpp import PointnetFPModule as JFP
    from geoa3_tpu_torch.models.pointnetpp import PointnetFPModule
    from tests.test_torch_grouping import _fp_state_dict

    rng = np.random.RandomState(94)
    b, n, m, c1, c2 = 2, 96, 24, 8, 16
    args = [rng.randn(b, n, 3), rng.randn(b, m, 3), rng.randn(b, n, c1),
            rng.randn(b, m, c2)]
    ct = rng.randn(b, n, 32)
    jmod = JFP(mlp=(32, 32))
    variables = jmod.init({"params": jax.random.PRNGKey(4)},
                          *[jnp.asarray(a, jnp.float32) for a in args], train=False)
    variables = {"params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
                 "batch_stats": _randomise_bn(
                     jax.tree.map(np.asarray, variables["batch_stats"]), rng)}
    with jax.enable_x64(True):
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)

        def jloss(uf, kf):
            out, mutated = jmod.apply(v64, jnp.asarray(args[0]), jnp.asarray(args[1]),
                                      uf, kf, train=True, mutable=["batch_stats"])
            return jnp.sum(out * ct), (out, mutated["batch_stats"])

        (_, (want, stats)), wgrads = jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(args[2]), jnp.asarray(args[3]))
        want, wgrads = np.asarray(want), [np.asarray(g) for g in wgrads]
        stats = jax.tree.map(np.asarray, stats)
    mod = PointnetFPModule([c2 + c1, 32, 32])
    mod.load_state_dict(_fp_state_dict(variables))
    mod = mod.double().train()
    uf = torch.from_numpy(args[2]).requires_grad_(True)
    kf = torch.from_numpy(args[3]).requires_grad_(True)
    got = mod(torch.from_numpy(args[0]), torch.from_numpy(args[1]), uf, kf)
    (got * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    for g, w in zip((uf.grad, kf.grad), wgrads):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())
    for k in range(2):
        bn, st = mod.mlp[3 * k + 1], stats["mlp"][f"bn{k}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), st["mean"], rtol=1e-5,
                                   atol=1e-5 * np.abs(st["mean"]).max())
        np.testing.assert_allclose(bn.running_var.numpy(), st["var"], rtol=1e-5)
