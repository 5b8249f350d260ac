"""The port's engine side modes against geoa3_tpu.attack.engine on the CPU:
tangent jitter, projection, per-point clipping, SGD and the LR schedule,
partial-variable mode, eval_logits_fn and the debug callback; subsample mode
(clouds of 256 points resampled to 128 every step, a three-fold vote) and the
uniform loss.

Same victim, clouds and labels as tests/test_torch_attack.py (PointNet, 10
classes, b=2, n=128, k=8). The two engines draw from different generators,
so the JAX engine's draws are reproduced from its key splits and injected
into the port: the initial offsets through `init_offset`, the jitter's
gaussians, the patch seed index, the patch offsets and the FPS start indices
through `draws`.
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

    def __init__(self, key, cfg, n=N):
        self.cfg, self.n = cfg, n
        self.offsets, self.jit_keys = [], {}
        self.fps_keys, self.eval_keys = {}, {}
        k = key
        for bs in range(BS):
            k, k_run = jax.random.split(k)
            k_init, ks = jax.random.split(k_run)
            self.offsets.append(np.asarray(
                1e-3 * jax.random.normal(k_init, (B, n, 3), jnp.float32)))
            for step in range(ITERS):
                ks, k_jit, k_fps, k_eval = jax.random.split(ks, 4)
                self.jit_keys[bs, step] = k_jit
                self.fps_keys[bs, step] = k_fps
                self.eval_keys[bs, step] = k_eval
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

    def _start(self, key):
        """geoa3_tpu/ops/sampling.py:_fps_random_start's first pick."""
        return np.array(jax.random.randint(key, (B,), 0, self.n, dtype=jnp.int32))

    def fps_start(self, bs_idx, step):
        return self._start(self.fps_keys[bs_idx, step])

    def eval_starts(self, bs_idx, step):
        keys = jax.random.split(self.eval_keys[bs_idx, step], self.cfg.eval_num)
        return np.stack([self._start(k) for k in keys])

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


SUBSAMPLE = {
    "subsample": dict(is_subsample_opt=True, eval_num=3),
    # exact mode is asked for; no mask is held in subsample mode either way
    "subsample_jitter": dict(JITTER, is_subsample_opt=True, eval_num=3,
                             curv_knn_refresh_every=1),
}


@pytest.fixture(scope="module")
def big_clouds():
    from geoa3_tpu_torch.data.synthetic import sample_shape

    rng = np.random.RandomState(12)
    pcs, nrms = zip(*(sample_shape(i, 2 * N, rng) for i in (2, 7)))
    return np.stack(pcs), np.stack(nrms)


@pytest.mark.parametrize("mode", sorted(SUBSAMPLE))
def test_subsample_mode_matches_jax(setup, big_clouds, mode):  # noqa: F811
    """Clouds of 256 points, resampled to npoint = 128 by random-start FPS on
    every step (one draw for the jitter's source and the loss), success by a
    three-fold resampling vote; the FPS starts are replayed from the JAX
    engine's keys, so both engines see the same point sets."""
    jfn, tfn, _, _, _ = setup
    pc, nrm = big_clouds
    # instance 0 is labelled with its resampled cloud's class, instance 1
    # with another one (it succeeds from the first step)
    pred = np.asarray(jfn(jnp.asarray(pc[:, ::2]))).argmax(-1)
    gt = np.array([pred[0], (pred[1] + 1) % CFG["classes"]], np.int64)
    cfg = dict(CFG, binary_max_steps=BS, iter_max_steps=ITERS, **SUBSAMPLE[mode])
    key = jax.random.PRNGKey(13)
    want = jengine.make_attack_fn(jfn, JConfig(**cfg))(
        jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(gt), jnp.asarray(gt), key
    )
    got = _run_port(tfn, pc, nrm, gt, cfg, JaxDraws(key, JConfig(**cfg), n=2 * N))

    assert got.best_attack.shape == (B, 2 * N, 3)  # the whole cloud is moved
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.best_attack_bs_idx.numpy(),
                                  np.asarray(want.best_attack_bs_idx))
    np.testing.assert_array_equal(got.best_attack_step.numpy(),
                                  np.asarray(want.best_attack_step))
    assert got.success[1]
    # the tolerances of test_side_mode_matches_jax
    np.testing.assert_allclose(got.all_loss.numpy(), np.asarray(want.all_loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.best_loss.numpy(), np.asarray(want.best_loss),
                               rtol=5e-3)
    np.testing.assert_allclose(got.best_attack.numpy(), np.asarray(want.best_attack),
                               rtol=0, atol=5e-3)


def test_ensemble_vote_is_a_majority_with_the_modal_label():
    """Three resamplings, two of which the victim calls class 2: success
    against gt 1 is a 2-of-3 majority and the label is the mode; against gt 2
    a single dissenting vote is no majority."""
    cfg = AttackConfig(**dict(CFG, npoint=4, eval_num=3))
    cloud = torch.arange(8.0).reshape(1, 8, 1).repeat(1, 1, 3)
    starts = torch.tensor([[0], [7], [3]], dtype=torch.int32)

    def victim(x):  # class 5 if the resampling started at point 7, else 2
        started_at_7 = (x[:, 0, 0] == 7.0).long()
        return torch.nn.functional.one_hot(2 + 3 * started_at_7, 10).float()

    for gt, want in ((1, True), (2, False)):
        t = torch.tensor([gt])
        success, label = engine._ensemble_eval(victim, cloud, t, t, cfg, starts)
        assert success.tolist() == [want] and label.tolist() == [2]


def test_uniform_loss_enters_the_constraint(setup, big_clouds):  # noqa: F811
    """forward_losses with uniform_loss_weight on clouds of 256 points (the
    smallest ball then holds 4 samples): constraint and gradient as the JAX
    engine's."""
    from geoa3_tpu import losses as jlosses
    from geoa3_tpu_torch import losses as tlosses

    jfn, tfn, _, _, _ = setup
    pc, nrm = big_clouds
    k = CFG["curv_loss_knn"]
    adv = (pc + 0.01 * np.random.RandomState(14).randn(*pc.shape)).astype(np.float32)
    gt, const = np.array([1, 2], np.int64), np.array([10.0, 3.0], np.float32)
    cfg = dict(CFG, npoint=2 * N, uniform_loss_weight=0.5)
    kap = jlosses.get_kappa_ori(jnp.asarray(pc), jnp.asarray(nrm), k)

    def jloss(x):
        return jengine.forward_losses(
            jfn, jnp.asarray(pc), x, jnp.asarray(nrm), kap, jnp.asarray(gt),
            jnp.asarray(const), JConfig(**cfg))

    (_, jaux), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(adv))
    x = _t(adv).requires_grad_(True)
    tl, taux = engine.forward_losses(
        tfn, _t(pc), x, _t(nrm), tlosses.get_kappa_ori(_t(pc), _t(nrm), k),
        _t(gt), _t(const), AttackConfig(**cfg))
    tl.backward()
    plain = engine.forward_losses(
        tfn, _t(pc), _t(adv), _t(nrm), tlosses.get_kappa_ori(_t(pc), _t(nrm), k),
        _t(gt), _t(const), AttackConfig(**dict(cfg, uniform_loss_weight=0.0)))[1]
    added = (taux.constrain_loss - plain.constrain_loss).detach()
    torch.testing.assert_close(
        added, (0.5 * tlosses.uniform_loss(_t(adv))).expand(2), rtol=1e-5, atol=1e-6)
    # the tolerances of tests/test_torch_attack.py's forward_losses test
    np.testing.assert_allclose(taux.constrain_loss.detach().numpy(),
                               np.asarray(jaux.constrain_loss), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(taux.loss_n.detach().numpy(),
                               np.asarray(jaux.loss_n), rtol=1e-4, atol=1e-6)
    jg = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy(), jg, rtol=1e-3,
                               atol=1e-3 * np.abs(jg).max())


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
