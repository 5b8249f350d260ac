"""The port's attack/project.py against geoa3_tpu.attack.project on the CPU.

Inputs come from numpy seeds: b=2 clouds of n=128 points, k=8. The clouds are
three-dimensional blobs, so every local covariance has three distinct
eigenvalues: eigenvectors are then defined up to sign, and are compared
through what is sign-free (eigenvalues, v v^T, the normal's line, the jitter
after aligning signs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu.attack import project as jp
from geoa3_tpu_torch.attack import project as tp
from tests.test_torch_ops import _cloud, _t

torch.set_num_threads(1)
B, N, K = 2, 128, 8


@pytest.fixture(scope="module")
def clouds():
    ori, nrm, rng = _cloud(50)
    adv = (ori + 0.02 * rng.randn(*ori.shape)).astype(np.float32)
    adv[:, :10] = ori[:, :10]  # points that did not move
    return adv, ori, nrm, rng


def test_offset_proj_matches_jax(clouds):
    adv, ori, nrm, _ = clouds
    off = adv - ori + np.float32(1e-3)
    want = jp.offset_proj(jnp.asarray(off), jnp.asarray(ori), jnp.asarray(nrm))
    got = tp.offset_proj(_t(off), _t(ori), _t(nrm))
    # the same 1-NN (keyed on the offset coordinates) and float32 arithmetic
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)
    # the result lies along the borrowed normal
    unit = got / got.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    assert ((unit * unit).sum(-1) - 1).abs().max() < 1e-4


def test_find_offset_matches_jax(clouds):
    adv, ori, _, _ = clouds
    want = jp.find_offset(jnp.asarray(ori), jnp.asarray(adv))
    got = tp.find_offset(_t(ori), _t(adv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-8)
    assert torch.equal(got[:, :10], torch.zeros(B, 10, 3))


@pytest.mark.parametrize("cc", [0.01, 0.05])
def test_lp_clip_matches_jax(clouds, cc):
    adv, ori, _, _ = clouds
    off = adv - ori
    off[0, 20] = 0.0  # a zero offset stays zero
    want = jp.lp_clip(jnp.asarray(off), cc)
    got = tp.lp_clip(_t(off), cc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
    assert got.norm(dim=-1).max() <= cc * (1 + 1e-5)
    assert (got.norm(dim=-1) <= _t(off).norm(dim=-1) + 1e-6).all()


def test_jitter_input_is_clamped_and_reproducible():
    like = torch.zeros(B, N, 3)
    a = tp.jitter_input(torch.Generator().manual_seed(3), like, sigma=0.05, clip=0.02)
    b = tp.jitter_input(torch.Generator().manual_seed(3), like, sigma=0.05, clip=0.02)
    assert torch.equal(a, b) and a.shape == like.shape
    assert a.abs().max() <= 0.02 and (a.abs() == 0.02).any()
    with pytest.raises(ValueError):
        tp.jitter_input(None, like, clip=0.0)


def test_local_covariance_eig_matches_jax(clouds):
    adv = clouds[0]
    wval, wvec, wcen = jp._local_covariance_eig(jnp.asarray(adv), K)
    gval, gvec, gcen = tp._local_covariance_eig(_t(adv), K)
    # neighbours bit-equal; their mean sums in another order
    np.testing.assert_allclose(gcen.numpy(), np.asarray(wcen), rtol=0, atol=1e-6)
    wval, wvec = np.asarray(wval), np.asarray(wvec)
    # no degenerate patch: eigenvalue gaps well above float32 noise
    assert (np.diff(wval, axis=-1) > 1e-3 * wval[..., 2:]).all()
    np.testing.assert_allclose(gval.numpy(), wval, rtol=1e-3,
                               atol=1e-5 * wval.max())
    # projectors v v^T are sign-free; their error grows with 1 / gap
    gv = gvec.numpy()
    for col in range(3):
        gp = np.einsum("bnc,bnd->bncd", gv[..., col], gv[..., col])
        wp = np.einsum("bnc,bnd->bncd", wvec[..., col], wvec[..., col])
        np.testing.assert_allclose(gp, wp, atol=2e-3)


def test_estimate_normal_matches_jax(clouds):
    adv = clouds[0]
    want = np.asarray(jp.estimate_normal(jnp.asarray(adv), K))
    got = tp.estimate_normal(_t(adv), K).numpy()
    # the same line everywhere. The sign is not compared: the rule reads the
    # sum of the neighbours centred on their own mean (reference
    # Lib/utility.py:62-64, reproduced by both packages), which is float32
    # rounding noise, so the sign it picks is arbitrary in either library
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-5)
    assert (np.abs((got * want).sum(-1)) > 1 - 1e-4).all()


def test_estimate_normal_via_ori_normal_matches_jax(clouds):
    adv, ori, nrm, _ = clouds
    want = jp.estimate_normal_via_ori_normal(
        jnp.asarray(adv), jnp.asarray(ori), jnp.asarray(nrm), 3
    )
    got = tp.estimate_normal_via_ori_normal(_t(adv), _t(ori), _t(nrm), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    # an unmoved point copies its own normal
    np.testing.assert_array_equal(got[:, :10].numpy(), nrm[:, :10])


def test_estimate_perpendicular_matches_jax_up_to_eigenvector_sign(clouds):
    adv = clouds[0]
    key = jax.random.PRNGKey(5)
    sigma, clip = 0.05, 0.03
    want = np.asarray(jp.estimate_perpendicular(key, jnp.asarray(adv), K, sigma, clip))
    k1, k2 = jax.random.split(key)
    g1 = np.asarray(jax.random.normal(k1, (B, N, 1)))
    g2 = np.asarray(jax.random.normal(k2, (B, N, 1)))
    # align each eigenvector's sign with the JAX side's, then the same draws
    # must give the same jitter
    _, wvec, _ = jp._local_covariance_eig(jnp.asarray(adv), K)
    _, gvec, _ = tp._local_covariance_eig(_t(adv), K)
    s = np.sign((gvec.numpy() * np.asarray(wvec)).sum(-2))  # [b, n, 3]
    got = tp.estimate_perpendicular(
        None, _t(adv), K, sigma, clip,
        gauss=(_t(g1 * s[..., 2:3]), _t(g2 * s[..., 1:2])),
    )
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3 * np.abs(want).max())
    assert np.abs(want).max() <= 2 * clip


def test_estimate_perpendicular_lies_in_the_tangent_plane(clouds):
    adv = clouds[0]
    gen = torch.Generator().manual_seed(6)
    jit = tp.estimate_perpendicular(gen, _t(adv), K, sigma=0.01, clip=1.0)
    normal = tp.estimate_normal(_t(adv), K)
    assert jit.shape == (B, N, 3)
    # unclamped: a combination of the two largest eigenvectors
    assert (jit * normal).sum(-1).abs().max() < 1e-5
    again = tp.estimate_perpendicular(
        torch.Generator().manual_seed(6), _t(adv), K, sigma=0.01, clip=1.0
    )
    assert torch.equal(jit, again)


def test_get_perpendicular_jitter(clouds):
    nrm = clouds[2]
    gen = torch.Generator().manual_seed(7)
    jit = tp.get_perpendicular_jitter(gen, _t(nrm), sigma=0.01, clip=1.0)
    # unclamped cross products are perpendicular to the vector
    assert (jit * _t(nrm)).sum(-1).abs().max() < 1e-6
    clamped = tp.get_perpendicular_jitter(
        torch.Generator().manual_seed(7), _t(nrm), sigma=1.0, clip=0.05
    )
    assert clamped.abs().max() <= 0.1
