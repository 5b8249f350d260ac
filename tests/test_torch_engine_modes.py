"""The port's engine side modes against geoa3_tpu.attack.engine on the CPU:
tangent jitter, projection, per-point clipping, SGD and the LR schedule,
partial-variable mode, eval_logits_fn and the debug callback.

Same victim, clouds and labels as tests/test_torch_attack.py (PointNet, 10
classes, b=2, n=128, k=8). The two engines draw from different generators,
so the JAX engine's draws are reproduced from its key splits and injected
into the port: the initial offsets through `init_offset`, the jitter's
gaussians, the patch seed index and the patch offsets through `draws`.
Eigenvectors are defined up to sign and the two eigensolvers pick differently
on ~1/6 of the points, so the jitter hook flips each gaussian where the
port's eigenvector points against the JAX one: the product, which is all the
jitter uses, is then the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu.attack import AttackConfig as JConfig
from geoa3_tpu.attack import engine as jengine
from geoa3_tpu.attack import project as jproject
from geoa3_tpu_torch.attack import AttackConfig, engine
from geoa3_tpu_torch.attack import project as tproject
from tests.test_torch_attack import B, CFG, N, _t, setup  # noqa: F401

torch.set_num_threads(1)
BS, ITERS = 2, 10


class JaxDraws:
    """The JAX engine's random numbers, replayed from its key splits
    (geoa3_tpu/attack/engine.py:561, :497-498, :415 for the main loop;
    :724-729 for partial-variable mode)."""

    def __init__(self, key, cfg):
        self.cfg = cfg
        self.offsets, self.jit_keys = [], {}
        k = key
        for bs in range(BS):
            k, k_run = jax.random.split(k)
            k_init, ks = jax.random.split(k_run)
            self.offsets.append(np.asarray(
                1e-3 * jax.random.normal(k_init, (B, N, 3), jnp.float32)))
            for step in range(ITERS):
                ks, k_jit, _, _ = jax.random.split(ks, 4)
                self.jit_keys[bs, step] = k_jit
        self.seeds, self.parts = {}, {}
        k = key
        for bs in range(BS):
            for phase in range(ITERS // cfg.partial_reinit_every):
                k, k_pt, k_off, _ = jax.random.split(k, 4)
                self.seeds[bs, phase] = int(jax.random.randint(k_pt, (), 0, N))
                self.parts[bs, phase] = np.asarray(1e-3 * jax.random.normal(
                    k_off, (B, cfg.knn_range, 3), jnp.float32))

    def init_offset(self, bs_idx):
        return _t(self.offsets[bs_idx])

    def jitter_gauss(self, bs_idx, step, cloud):
        k1, k2 = jax.random.split(self.jit_keys[bs_idx, step])
        g1 = np.asarray(jax.random.normal(k1, (B, N, 1)))
        g2 = np.asarray(jax.random.normal(k2, (B, N, 1)))
        _, wvec, _ = jproject._local_covariance_eig(
            jnp.asarray(cloud.numpy()), self.cfg.jitter_k)
        _, gvec, _ = tproject._local_covariance_eig(cloud, self.cfg.jitter_k)
        s = np.sign((gvec.numpy() * np.asarray(wvec)).sum(-2))  # [b, n, 3]
        return _t(g1 * s[..., 2:3]), _t(g2 * s[..., 1:2])

    def patch_seed(self, bs_idx, phase):
        return self.seeds[bs_idx, phase]

    def patch_offset(self, bs_idx, phase):
        return _t(self.parts[bs_idx, phase])


JITTER = dict(is_pre_jitter_input=True, jitter_k=8, jitter_sigma=0.01,
              jitter_clip=0.05, calculate_project_jitter_noise_iter=5)
MODES = {
    "jitter_proj_clip": dict(JITTER, is_pro_grad=True, cc_linf=0.02,
                             curv_knn_refresh_every=5),
    "jitter_exact_real_offset": dict(JITTER, is_pro_grad=True,
                                     is_real_offset=True,
                                     is_use_lr_scheduler=True, lr_gamma=0.9),
    "sgd_schedule": dict(optim="sgd", lr=0.001, is_use_lr_scheduler=True,
                         lr_gamma=0.9),
    "partial_var_sgd": dict(is_partial_var=True, knn_range=3, optim="sgd",
                            lr=0.001, partial_reinit_every=5),
    "partial_var_adam": dict(is_partial_var=True, knn_range=4,
                             partial_reinit_every=5, is_use_lr_scheduler=True,
                             lr_gamma=0.9),
}


def _run_port(tfn, pc, nrm, gt, cfg, draws, **kw):
    fn = engine.make_attack_fn(tfn, AttackConfig(**cfg),
                               init_offset=draws.init_offset, draws=draws, **kw)
    return fn(_t(pc), _t(nrm), _t(gt), _t(gt))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_side_mode_matches_jax(setup, mode):  # noqa: F811
    jfn, tfn, pc, nrm, gt = setup
    cfg = dict(CFG, binary_max_steps=BS, iter_max_steps=ITERS, **MODES[mode])
    key = jax.random.PRNGKey(11)
    want = jengine.make_attack_fn(jfn, JConfig(**cfg))(
        jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(gt), jnp.asarray(gt), key
    )
    got = _run_port(tfn, pc, nrm, gt, cfg, JaxDraws(key, JConfig(**cfg)))

    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.best_attack_bs_idx.numpy(),
                                  np.asarray(want.best_attack_bs_idx))
    # 20 optimiser steps carry the per-step float32 differences (sums in
    # other orders, the eigensolvers' ~1e-6 on the jitter); the tolerances
    # are those of tests/test_torch_attack.py's whole-attack test
    np.testing.assert_allclose(got.all_loss.numpy(), np.asarray(want.all_loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.best_loss.numpy(), np.asarray(want.best_loss),
                               rtol=5e-3)
    np.testing.assert_allclose(got.best_attack.numpy(), np.asarray(want.best_attack),
                               rtol=0, atol=5e-3)


def _visited(tfn, store):
    """An eval victim that records every cloud the loop judges."""
    def eval_fn(x):
        store.append(x.clone())
        return tfn(x)
    return eval_fn


def test_clip_bounds_every_offset_row(setup):  # noqa: F811
    _, tfn, pc, nrm, gt = setup
    cfg = dict(CFG, binary_max_steps=1, iter_max_steps=ITERS, cc_linf=0.01,
               lr=0.05)
    seen, clouds = [], []
    fn = engine.make_attack_fn(tfn, AttackConfig(**cfg), host_binary_loop=True,
                               eval_logits_fn=_visited(tfn, clouds),
                               debug_callback=lambda *a: seen.append(a))
    fn(_t(pc), _t(nrm), _t(gt), _t(gt), torch.Generator().manual_seed(0))
    assert len(clouds) == ITERS
    # every cloud after the first update has been clipped, and the clip bites
    norms = torch.stack([(c - _t(pc)).norm(dim=-1) for c in clouds[1:]])
    assert norms.max() <= 0.01 * (1 + 1e-5)
    assert norms.max() > 0.0099
    # the debug callback saw the search step
    (bs_idx, best_attack, loss_ys), = seen
    assert bs_idx == 0 and best_attack.shape == (B, N, 3)
    assert loss_ys.shape == (ITERS, B)


def test_partial_var_moves_at_most_the_patches(setup):  # noqa: F811
    """Per search step, phases x knn_range rows of a cloud may move; every
    other row of every visited cloud equals the original, and a phase starts
    from the cloud the one before last judged."""
    _, tfn, pc, nrm, gt = setup
    kr, reinit = 3, 5
    cfg = dict(CFG, binary_max_steps=1, iter_max_steps=ITERS, is_partial_var=True,
               knn_range=kr, partial_reinit_every=reinit, optim="sgd")
    clouds = []
    fn = engine.make_attack_fn(tfn, AttackConfig(**cfg),
                               eval_logits_fn=_visited(tfn, clouds))
    res = fn(_t(pc), _t(nrm), _t(gt), _t(gt), torch.Generator().manual_seed(1))
    assert torch.isfinite(res.all_loss).all() and len(clouds) == ITERS
    for step, c in enumerate(clouds):
        moved = ((c - _t(pc)).abs().sum(-1) > 0).sum(-1)  # rows per instance
        phases_so_far = step // reinit + 1
        assert (moved <= phases_so_far * kr).all() and (moved > 0).all()
    # phase 1 keeps phase 0's last cloud outside its own patch
    kept = ((clouds[reinit] - clouds[reinit - 1]).abs().sum(-1) > 0).sum(-1)
    assert (kept <= kr).all()


def test_partial_var_needs_whole_phases():
    with pytest.raises(ValueError, match="partial_reinit_every"):
        engine.make_attack_fn(lambda x: x, AttackConfig(
            is_partial_var=True, iter_max_steps=7, partial_reinit_every=5))


@pytest.mark.parametrize("mode", ["main", "partial_var"])
def test_eval_logits_fn_judges_success(setup, mode):  # noqa: F811
    """The gradient pass keeps logits_fn; success comes from eval_logits_fn:
    an eval victim that always answers the true class never succeeds, and the
    losses do not change."""
    _, tfn, pc, nrm, gt = setup
    cfg = dict(CFG, binary_max_steps=1, iter_max_steps=5)
    if mode == "partial_var":
        cfg.update(is_partial_var=True, partial_reinit_every=5)

    def never_fooled(x):
        return torch.nn.functional.one_hot(_t(gt), CFG["classes"]).float()

    runs = []
    for eval_fn in (None, never_fooled):
        fn = engine.make_attack_fn(tfn, AttackConfig(**cfg), eval_logits_fn=eval_fn)
        runs.append(fn(_t(pc), _t(nrm), _t(gt), _t(gt),
                       torch.Generator().manual_seed(2)))
    assert runs[0].success[1] and not runs[1].success.any()
    assert torch.equal(runs[0].all_loss, runs[1].all_loss)


def test_jitter_draws_are_reproducible(setup):  # noqa: F811
    _, tfn, pc, nrm, gt = setup
    cfg = AttackConfig(**dict(CFG, binary_max_steps=1, iter_max_steps=3, **JITTER))
    fn = engine.make_attack_fn(tfn, cfg)
    runs = [fn(_t(pc), _t(nrm), _t(gt), _t(gt), torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0].all_loss, runs[1].all_loss)
