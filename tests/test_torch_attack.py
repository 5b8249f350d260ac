"""The port's attack engine against geoa3_tpu.attack on the CPU.

The victim is PointNet (10 classes, random weights and BatchNorm statistics,
carried across by from_flax_variables), b=2 clouds of n=128 points, k=8.
The JAX engine's initial offsets are reproduced from its key splits and
injected into the port through `init_offset`.

Where the two differ in arithmetic: the JAX engine's CPU path computes the
curvature statistic from gathered neighbours, the port from a selection
mask; both pick the same neighbours and take direct differences, and float32
sums in other orders, which 40 Adam steps carry into the loss trajectories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu import losses as jlosses
from geoa3_tpu.attack import AttackConfig as JConfig
from geoa3_tpu.attack import engine as jengine
from geoa3_tpu.models.pointnet import PointNet as JPointNet
from geoa3_tpu.models.registry import make_eval_fn as jmake_eval_fn
from geoa3_tpu_torch import losses as tlosses
from geoa3_tpu_torch.attack import AttackConfig, engine
from geoa3_tpu_torch.data.synthetic import sample_shape
from geoa3_tpu_torch.models import build_model, make_eval_fn
from geoa3_tpu_torch.models.convert import from_flax_variables
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(1)
B, N, CLASSES, K = 2, 128, 10, 8
CFG = dict(attack_label="Untarget", classes=CLASSES, npoint=N, curv_loss_knn=K)


@pytest.fixture(scope="module")
def setup():
    jmodel = JPointNet(classes=CLASSES, npoint=N)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, N, 3)), train=False
    )
    rng = np.random.RandomState(1)
    variables = {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng
        ),
    }
    rng = np.random.RandomState(2)
    pcs, nrms = zip(*(sample_shape(i, N, rng) for i in (0, 4)))
    pc, nrm = np.stack(pcs), np.stack(nrms)
    # random weights leave every cloud ~0.3 logits from the boundary, out of
    # reach of a short attack: move the runner-up class of instance 0 to
    # within 0.02 of its top class through the last bias
    logits = np.asarray(jmake_eval_fn(jmodel, variables)(jnp.asarray(pc)))
    top, runner = np.argsort(logits[0])[::-1][:2]
    bias = np.array(variables["params"]["fc3"]["bias"])
    bias[runner] += logits[0, top] - logits[0, runner] - 0.02
    variables["params"]["fc3"]["bias"] = bias
    jfn = jmake_eval_fn(jmodel, variables)
    model = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
    model.load_state_dict(from_flax_variables(variables))
    tfn = make_eval_fn(model)
    pred = np.asarray(jfn(jnp.asarray(pc))).argmax(-1)
    # instance 0 must leave its predicted class; instance 1 is labelled with
    # another class, so it succeeds from the first step (best-tracking)
    gt = np.array([pred[0], (pred[1] + 1) % CLASSES], np.int64)
    return jfn, tfn, pc, nrm, gt


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_offsets(key, bs_steps):
    """The JAX engine's initial offsets: key -> split -> k_run -> split ->
    k_init per binary step (geoa3_tpu/attack/engine.py:561,497-498)."""
    out = []
    for _ in range(bs_steps):
        key, k_run = jax.random.split(key)
        k_init, _ = jax.random.split(k_run)
        out.append(np.asarray(1e-3 * jax.random.normal(k_init, (B, N, 3), jnp.float32)))
    return out


def test_forward_losses_value_and_grad(setup):
    jfn, tfn, pc, nrm, gt = setup
    adv = (pc + 0.01 * np.random.RandomState(3).randn(*pc.shape)).astype(np.float32)
    const = np.array([10.0, 3.0], np.float32)
    jcfg = JConfig(**CFG)
    kap = jlosses.get_kappa_ori(jnp.asarray(pc), jnp.asarray(nrm), K)

    def jloss(x):
        return jengine.forward_losses(
            jfn, jnp.asarray(pc), x, jnp.asarray(nrm), kap, jnp.asarray(gt),
            jnp.asarray(const), jcfg,
        )

    (jl, jaux), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(adv))

    x = _t(adv).requires_grad_(True)
    tkap = tlosses.get_kappa_ori(_t(pc), _t(nrm), K)
    tl, taux = engine.forward_losses(
        tfn, _t(pc), x, _t(nrm), tkap, _t(gt), _t(const), AttackConfig(**CFG)
    )
    tl.backward()
    for name in ("cls_loss", "dis_loss", "hd_loss", "curv_loss", "loss_n"):
        # float32 victim and loss sums in other orders
        np.testing.assert_allclose(
            getattr(taux, name).detach().numpy(), np.asarray(getattr(jaux, name)),
            rtol=1e-4, atol=1e-6, err_msg=name,
        )
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-3,
                               atol=1e-3 * np.abs(jg).max())


@pytest.mark.parametrize("refresh", [10, 1])
def test_whole_attack_matches_jax(setup, refresh):
    jfn, tfn, pc, nrm, gt = setup
    cfg = dict(CFG, binary_max_steps=2, iter_max_steps=20,
               curv_knn_refresh_every=refresh)
    key = jax.random.PRNGKey(7)
    want = jengine.make_attack_fn(jfn, JConfig(**cfg))(
        jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(gt), jnp.asarray(gt), key
    )
    offsets = _jax_offsets(key, 2)
    got = engine.make_attack_fn(
        tfn, AttackConfig(**cfg), init_offset=lambda i: _t(offsets[i])
    )(_t(pc), _t(nrm), _t(gt), _t(gt))

    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.best_attack_step.numpy(),
                                  np.asarray(want.best_attack_step))
    np.testing.assert_array_equal(got.best_attack_bs_idx.numpy(),
                                  np.asarray(want.best_attack_bs_idx))
    assert got.success.all() and got.best_attack_step[0] > 0
    # 40 Adam steps carry the ~1e-5 per-step differences described above
    # (measured: all_loss within 2.5e-5, best_loss 1.2e-3 relative, best
    # cloud 8.5e-4 at K=1); Adam moves a coordinate by up to lr = 0.01 a
    # step, so the cloud is held to half of that
    np.testing.assert_allclose(got.all_loss.numpy(), np.asarray(want.all_loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.best_loss.numpy(), np.asarray(want.best_loss),
                               rtol=5e-3)
    np.testing.assert_allclose(got.best_attack.numpy(), np.asarray(want.best_attack),
                               rtol=0, atol=5e-3)


def test_generator_draws_are_reproducible(setup):
    _, tfn, pc, nrm, gt = setup
    cfg = AttackConfig(**CFG, binary_max_steps=1, iter_max_steps=2)
    fn = engine.make_attack_fn(tfn, cfg)
    runs = [fn(_t(pc), _t(nrm), _t(gt), _t(gt), torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0].all_loss, runs[1].all_loss)


STILL_REFUSED = ()


@pytest.mark.parametrize("field,value", [
    ("is_pro_grad", True), ("cc_linf", 0.1), ("is_pre_jitter_input", True),
    ("is_subsample_opt", True), ("is_partial_var", True),
    ("uniform_loss_weight", 1.0), ("is_use_lr_scheduler", True),
])
def test_unported_modes_raise(field, value):
    """A mode that is still refused raises with its ROADMAP message (none is
    left: farthest-point sampling is ported); every switch builds an attack."""
    cfg = AttackConfig(**{field: value})
    if field in STILL_REFUSED:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            engine.make_attack_fn(lambda x: x, cfg)
    else:
        assert callable(engine.make_attack_fn(lambda x: x, cfg))


def test_unported_arguments_raise():
    """host_binary_loop is accepted (the loop is host-driven anyway); the
    debug callback keeps the JAX engine's conditions."""
    assert callable(
        engine.make_attack_fn(lambda x: x, AttackConfig(), host_binary_loop=True)
    )
    with pytest.raises(ValueError, match="host_binary_loop"):
        engine.make_attack_fn(lambda x: x, AttackConfig(),
                              debug_callback=lambda *a: None)
    with pytest.raises(ValueError, match="partial-var"):
        engine.make_attack_fn(
            lambda x: x, AttackConfig(is_partial_var=True),
            host_binary_loop=True, debug_callback=lambda *a: None,
        )
