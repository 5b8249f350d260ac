"""The port's geometric losses against geoa3_tpu.losses on the CPU: each
function's value and its gradient with respect to the adversarial cloud.

Inputs come from numpy seeds: b=2 clouds of n=128 points on the unit ball, an
adversarial copy moved by 0.02 N(0, 1), k=8. Both sides select the same
neighbours (exact kNN, lowest index on ties) and compose the same float32
arithmetic; XLA and PyTorch only sum in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu import losses as jl
from geoa3_tpu_torch import losses as tl
from tests.test_torch_ops import _cloud, _t

torch.set_num_threads(1)
B, N, K = 2, 128, 8


@pytest.fixture(scope="module")
def clouds():
    ori, nrm, rng = _cloud(40)
    adv = (ori + 0.02 * rng.randn(*ori.shape)).astype(np.float32)
    kap = np.abs(rng.randn(B, N)).astype(np.float32)
    return adv, ori, nrm, kap


# name -> (function of (module, adv, ori, normal, kappa) -> array, relative
# tolerance of the value, of the gradient against its largest entry)
CASES = {
    "norm_l2_loss": (lambda m, a, o, n, k: m.norm_l2_loss(a, o), 1e-6, 1e-6),
    "chamfer_loss": (lambda m, a, o, n, k: m.chamfer_loss(a, o), 1e-5, 1e-5),
    "pseudo_chamfer_loss": (
        lambda m, a, o, n, k: m.pseudo_chamfer_loss(a, o), 1e-5, 1e-5),
    "hausdorff_loss": (lambda m, a, o, n, k: m.hausdorff_loss(a, o), 1e-5, 1e-5),
    "get_kappa_ori": (lambda m, a, o, n, k: m.get_kappa_ori(a, n, K), 1e-5, 1e-4),
    "get_kappa_adv": (
        lambda m, a, o, n, k: m.get_kappa_adv(a, o, n, K)[0], 1e-5, 1e-4),
    "curvature_loss": (
        lambda m, a, o, n, k: m.curvature_loss(
            a, o, m.get_kappa_adv(a, o, n, K)[0], k), 1e-5, 1e-4),
    "displacement_loss": (
        lambda m, a, o, n, k: m.displacement_loss(a, o, K), 1e-5, 1e-5),
    "corresponding_normal_loss": (
        lambda m, a, o, n, k: m.corresponding_normal_loss(a, n, K), 1e-5, 1e-4),
    "repulsion_loss": (lambda m, a, o, n, k: m.repulsion_loss(a, 4, 0.03), 1e-5, 1e-4),
    "distance_kmean_loss": (
        lambda m, a, o, n, k: m.distance_kmean_loss(a, K), 1e-5, 1e-4),
    "knn_smoothing_loss": (
        lambda m, a, o, n, k: m.knn_smoothing_loss(a, K, 1.05), 1e-5, 1e-4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_value_and_grad_match_jax(clouds, name):
    fn, vtol, gtol = CASES[name]
    adv, ori, nrm, kap = clouds
    rng = np.random.RandomState(41)
    jargs = tuple(jnp.asarray(x) for x in (ori, nrm, kap))
    want = np.asarray(fn(jl, jnp.asarray(adv), *jargs))
    w = rng.randn(*want.shape).astype(np.float32)
    wgrad = np.asarray(jax.grad(
        lambda a: jnp.sum(fn(jl, a, *jargs) * w))(jnp.asarray(adv)))

    a = _t(adv).requires_grad_(True)
    got = fn(tl, a, _t(ori), _t(nrm), _t(kap))
    assert got.shape == want.shape
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=vtol,
                               atol=vtol * np.abs(want).max())
    np.testing.assert_allclose(a.grad.numpy(), wgrad, rtol=gtol,
                               atol=gtol * np.abs(wgrad).max())


def test_get_kappa_adv_borrows_the_nearest_ori_normal(clouds):
    adv, ori, nrm, _ = clouds
    _, want = jl.get_kappa_adv(jnp.asarray(adv), jnp.asarray(ori), jnp.asarray(nrm), K)
    _, got = tl.get_kappa_adv(_t(adv), _t(ori), _t(nrm), K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_knn_smoothing_uses_the_bessel_corrected_std(clouds):
    """A cloud with outliers: the threshold mean + coef * std (n - 1 in the
    denominator) decides which points count, so a population std would move
    the value."""
    adv = clouds[0].copy()
    adv[:, :6] *= 3.0
    want = np.asarray(jl.knn_smoothing_loss(jnp.asarray(adv), K, 1.05))
    got = tl.knn_smoothing_loss(_t(adv), K, 1.05).numpy()
    assert (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_l2normalize_clamps_and_stays_finite_at_zero():
    v = torch.zeros(2, 3, requires_grad=True)
    out = tl._l2normalize(v)
    out.sum().backward()
    assert torch.equal(out, torch.zeros(2, 3)) and torch.isfinite(v.grad).all()
    x = np.random.RandomState(42).randn(5, 3).astype(np.float32)
    np.testing.assert_allclose(tl._l2normalize(_t(x)).numpy(),
                               np.asarray(jl._l2normalize(jnp.asarray(x))),
                               rtol=1e-6)


def test_uniform_loss_is_not_ported():
    """The name dates from when the port refused this loss; it is ported now,
    with the JAX package's signature."""
    import inspect

    assert inspect.signature(tl.uniform_loss).parameters.keys() == (
        inspect.signature(jl.uniform_loss).parameters.keys())
    for name, p in inspect.signature(jl.uniform_loss).parameters.items():
        assert inspect.signature(tl.uniform_loss).parameters[name].default == p.default


@pytest.mark.parametrize("n", [256, 1024])
def test_uniform_loss_value_and_grad_match_jax(n):
    """FPS seeds, five ball queries, grouping and a 3-NN inside every group:
    all indices agree, so value and gradient differ by summation order only.
    At n=256 the balls hold 4 to 12 samples and most are under-full (repeated
    first hits: zero distances under the square root's 1e-12)."""
    adv = _cloud(43, 2, n)[0]
    want, wgrad = jax.jit(jax.value_and_grad(jl.uniform_loss))(jnp.asarray(adv))
    a = _t(adv).requires_grad_(True)
    got = tl.uniform_loss(a)
    got.backward()
    assert got.shape == () and float(want) > 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(a.grad.numpy(), wgrad, rtol=1e-4,
                               atol=1e-4 * np.abs(wgrad).max())


def test_uniform_loss_needs_three_points_a_ball():
    with pytest.raises(ValueError, match="knn takes"):
        tl.uniform_loss(_t(_cloud(44, 2, 128)[0]))  # int(128 * 0.016) = 2 < k + 1
