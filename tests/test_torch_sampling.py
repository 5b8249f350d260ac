"""The port's farthest-point sampling and index gathers against the JAX
package, on the CPU.

The FPS kernel's plain PyTorch version (what the port runs on CPU tensors and
what chip_smoke.py holds the CUDA kernel against on the card) is compared with
the Pallas kernel it replaces in TPU interpret mode, and each op of
ops/sampling.py with its geoa3_tpu.ops counterpart (the composed CPU path).
Inputs come from numpy seeds. Indices must be equal, not merely the same
sets: one changed pick changes every later one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geoa3_tpu import ops as jops
from geoa3_tpu.ops.pallas.fps_kernel import fps_pallas
from geoa3_tpu_torch import ops as tops
from geoa3_tpu_torch.ops.kernels import fps_kernel as fk
from geoa3_tpu_torch.ops.kernels import scatter_kernel as sk
from tests.test_torch_ops import _cloud, _t

torch.set_num_threads(1)
B, N, M = 3, 256, 64


def _with_near_origin(c):
    """Points inside the skip radius (|p|^2 <= 1e-3), among them index 0, and
    one cloud that lies inside it entirely."""
    c = c.copy()
    c[:, 0] *= 1e-3
    c[0, 5:40] *= 0.02
    c[2] *= 1e-3
    return c


@pytest.mark.parametrize("near_origin", [False, True])
@pytest.mark.parametrize("skip", [True, False])
def test_plain_matches_pallas_kernel(near_origin, skip):
    c = _cloud(50, B, N)[0]
    if near_origin:
        c = _with_near_origin(c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fps_pallas(jnp.asarray(c), M, skip_near_origin=skip))
    got = fk.fps_plain(_t(c), M, None, skip)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if near_origin and skip:
        assert not got[2].any()  # every point skipped: the argmax of all -1
        assert not np.isin(np.arange(5, 40), got[0].numpy()[1:]).any()


def test_plain_matches_pallas_kernel_from_a_start():
    c, _, rng = _cloud(51, B, N)
    start = rng.randint(0, N, B).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(fps_pallas(jnp.asarray(c), M, start=jnp.asarray(start),
                                     skip_near_origin=False))
    got = fk.fps_plain(_t(c), M, _t(start), False)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[:, 0].numpy(), start)


@pytest.mark.parametrize("near_origin", [False, True])
def test_furthest_point_sampling_matches_jax(near_origin):
    c = _cloud(52, B, N)[0]
    if near_origin:
        c = _with_near_origin(c)
    want = np.asarray(jops.furthest_point_sampling(jnp.asarray(c), M))
    got = tops.furthest_point_sampling(_t(c), M)
    np.testing.assert_array_equal(got.numpy(), want)
    assert fk.fps.launches == 0  # CPU tensors never launch


def test_fps_is_a_prefix_in_m_and_takes_one_pick():
    c = _cloud(53, B, N)[0]
    full = fk.fps(_t(c), M)
    assert torch.equal(fk.fps(_t(c), 9), full[:, :9])
    assert torch.equal(fk.fps(_t(c), 1), torch.zeros(B, 1, dtype=torch.int32))
    with pytest.raises(ValueError, match="m >= 1"):
        fk.fps(_t(c), 0)


def _jax_start(key, b, n):
    """The first pick geoa3_tpu/ops/sampling.py:_fps_random_start draws."""
    return np.asarray(jax.random.randint(key, (b,), 0, n, dtype=jnp.int32))


def test_farthest_points_sample_replays_the_jax_draw():
    c, nrm, _ = _cloud(54, B, N)
    key = jax.random.PRNGKey(3)
    start = _t(_jax_start(key, B, N))
    want = np.asarray(jops.farthest_points_sample(jnp.asarray(c), M, key))
    got = tops.farthest_points_sample(_t(c), M, start=start)
    np.testing.assert_array_equal(got.numpy(), want)
    wpc, wn = jops.farthest_points_sample_with_normal(
        jnp.asarray(c), jnp.asarray(nrm), M, key)
    gpc, gn = tops.farthest_points_sample_with_normal(_t(c), _t(nrm), M, start=start)
    np.testing.assert_array_equal(gpc.numpy(), np.asarray(wpc))
    np.testing.assert_array_equal(gn.numpy(), np.asarray(wn))


def test_farthest_points_sample_draws_from_the_generator():
    c = _t(_cloud(55, B, N)[0])
    runs = [tops.farthest_points_sample(c, M, torch.Generator().manual_seed(4))
            for _ in range(2)]
    other = tops.farthest_points_sample(c, M, torch.Generator().manual_seed(5))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], other)
    # a resampling is a subset of the cloud's rows, without repeats
    rows = {tuple(r) for r in c[0].tolist()}
    picked = [tuple(r) for r in runs[0][0].tolist()]
    assert set(picked) <= rows and len(set(picked)) == M


@pytest.mark.parametrize("c", [3, 5])
def test_gather_points_value_and_grad_match_jax(c):
    rng = np.random.RandomState(56)
    feats = rng.randn(B, N, c).astype(np.float32)
    idx = rng.randint(0, N, (B, M)).astype(np.int32)
    idx[:, 1] = idx[:, 0]  # a repeated row: its cotangents add up
    w = rng.randn(B, M, c).astype(np.float32)
    want = np.asarray(jops.gather_points(jnp.asarray(feats), jnp.asarray(idx)))
    wgrad = np.asarray(jax.grad(lambda f: jnp.sum(
        jops.gather_points(f, jnp.asarray(idx)) * w))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_(True)
    got = tops.gather_points(f, _t(idx))
    (got * _t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # float32 sums of the two cotangents that meet on a repeated row
    np.testing.assert_allclose(f.grad.numpy(), wgrad, rtol=1e-6, atol=1e-6)


def test_farthest_points_sample_is_differentiable_in_the_cloud():
    c = _t(_cloud(57, B, N)[0]).requires_grad_(True)
    start = torch.tensor([3, 1, 4], dtype=torch.int32)
    out = tops.farthest_points_sample(c, M, start=start)
    out.sum().backward()
    idx = fk.fps_plain(c.detach(), M, start, False)
    want = sk.scatter_add_3t_plain(idx, torch.ones(B, M, 3), N)
    assert torch.equal(c.grad, want)  # 1 on the picked rows, 0 elsewhere
