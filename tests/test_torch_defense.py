"""The port's defenses, masked PointNet and smoothness metric against the JAX
package, on the CPU.

Inputs are made from numpy seeds at small sizes (b <= 4, n <= 600). The JAX
functions run as tests/test_defense.py runs them (the kNN on its CPU path);
the port runs the kernels' plain versions. Selections are held exactly:
the fixed-count keep also on a cloud whose mean kNN distances tie exactly,
and the random drop on the noise JAX draws for a key. The variance defense
compares a threshold: a point whose mean distance lies within 1e-5
(relative) of mean + alpha * std may fall on either side, and such points
are counted and set aside.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu import defense as jdef
from geoa3_tpu import measurement as jmeas
from geoa3_tpu.models.pointnet import PointNet as JPointNet
from geoa3_tpu_torch import defense, measurement
from geoa3_tpu_torch.data.synthetic import sample_shape
from geoa3_tpu_torch.models import build_model
from geoa3_tpu_torch.models.convert import from_flax_variables
from geoa3_tpu_torch.workload import random_victim
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(1)
NEAR = 1e-5  # relative distance to the variance threshold set aside


def _t(a):
    return torch.from_numpy(np.array(a))


def _outlier_clouds(seed, b=3, n=64, outliers=4):
    rng = np.random.RandomState(seed)
    pc = (0.3 * rng.randn(b, n, 3)).astype(np.float32)
    pc[:, :outliers] += rng.choice([-3.0, 3.0], size=(b, outliers, 3))
    return pc


def _tied_lattice(seed, n=32):
    """Points 0.125 apart on a line, in a random order: the mean distance to
    the two nearest others is exactly 0.125 for every interior point and
    0.1875 at both ends, so the fixed-count keep cuts through a tie."""
    rng = np.random.RandomState(seed)
    pc = np.zeros((1, n, 3), np.float32)
    pc[0, :, 0] = 0.125 * rng.permutation(n)
    return pc


# ------------------------------------------------------------- defenses ----


def test_mean_knn_dist_matches_jax():
    pc = _outlier_clouds(0)
    want = np.asarray(jdef._mean_knn_dist(jnp.asarray(pc), 2))
    got = defense._mean_knn_dist(_t(pc), 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("case", ["outliers", "tied"])
def test_outliers_fix_num_matches_jax(case):
    pc = _outlier_clouds(1) if case == "outliers" else _tied_lattice(2)
    drop = 4
    if case == "tied":
        dis = defense._mean_knn_dist(_t(pc), 2)[0].numpy()
        cut = np.sort(dis)[pc.shape[1] - drop - 1]
        # the keep boundary falls inside a run of exactly equal distances
        assert (dis == cut).sum() > drop
    want = jdef.outliers_fix_num(jnp.asarray(pc), drop, 2)
    got = defense.outliers_fix_num(_t(pc), drop, 2)
    # the points are distinct, so equal clouds are equal kept indices
    assert len(np.unique(pc.reshape(-1, 3), axis=0)) == pc.shape[0] * pc.shape[1]
    np.testing.assert_array_equal(got.pc.numpy(), np.asarray(want.pc))
    np.testing.assert_array_equal(got.num_dropped.numpy(),
                                  np.asarray(want.num_dropped))
    assert got.keep_mask is None and got.num_dropped.dtype == torch.int32


def _variance_keep(dis, alpha):
    thr = dis.mean(-1, keepdims=True) + alpha * dis.std(-1, ddof=1, keepdims=True)
    return dis < thr, np.abs(dis - thr) <= NEAR * np.abs(thr)


@pytest.mark.parametrize("seed", [3, 4])
def test_outliers_variance_matches_jax(seed):
    pc = _outlier_clouds(seed, b=4, n=96)
    alpha = 1.1
    want = jdef.outliers_variance(jnp.asarray(pc), alpha, 2)
    got = defense.outliers_variance(_t(pc), alpha, 2)
    dis = defense._mean_knn_dist(_t(pc), 2).numpy().astype(np.float64)
    keep, near = _variance_keep(dis, alpha)
    set_aside = 0
    for b in range(pc.shape[0]):
        jkeep = np.asarray(want.keep_mask[b])
        pkeep = got.keep_mask[b].numpy()
        if near[b].any():
            set_aside += int(near[b].sum())
            # each side is its own keep set's compaction: the kept points in
            # index order, then the first kept point repeated
            assert abs(int(pkeep.sum()) - int(jkeep.sum())) <= near[b].sum()
            continue
        np.testing.assert_array_equal(pkeep, jkeep)
        np.testing.assert_array_equal(got.pc[b].numpy(), np.asarray(want.pc[b]))
        assert int(got.num_dropped[b]) == int(want.num_dropped[b])
        kept = pc[b][keep[b]]
        assert pkeep.sum() == len(kept)
        np.testing.assert_array_equal(got.pc[b, : len(kept)].numpy(), kept)
        np.testing.assert_array_equal(
            got.pc[b, len(kept):].numpy(), np.repeat(kept[:1], pc.shape[1] - len(kept), 0))
    # these seeds put no point near the threshold: every cloud was compared
    assert set_aside == 0
    assert (got.num_dropped >= 4).all()


def test_random_drop_on_jax_noise_is_exact():
    pc = _outlier_clouds(5, b=2, n=64)
    key = jax.random.PRNGKey(7)
    want = jdef.random_drop(jnp.asarray(pc), 16, key)
    noise = np.asarray(jax.random.uniform(key, (2, 64)))
    got = defense.drop_by_noise(_t(pc), _t(noise), 16)
    np.testing.assert_array_equal(got.pc.numpy(), np.asarray(want.pc))
    np.testing.assert_array_equal(got.num_dropped.numpy(),
                                  np.asarray(want.num_dropped))


def test_random_drop_keeps_a_subset_in_order():
    pc = _outlier_clouds(6, b=2, n=64)
    res = defense.random_drop(_t(pc), 16, torch.Generator().manual_seed(0))
    assert res.pc.shape == (2, 48, 3) and (res.num_dropped == 16).all()
    for b in range(2):
        hit = (res.pc[b].numpy()[:, None, :] == pc[b][None]).all(-1)
        idx = hit.argmax(1)
        assert hit.any(1).all() and (np.diff(idx) > 0).all()


def test_point_removal_dispatch():
    pc = _outlier_clouds(8, b=1, n=32)
    gen = torch.Generator().manual_seed(0)
    shapes = {t: defense.point_removal(_t(pc), t, 4, 1.1, 2, generator=gen).pc.shape
              for t in ("rand_drop", "outliers_fixNum", "outliers_variance")}
    assert shapes == {"rand_drop": (1, 28, 3), "outliers_fixNum": (1, 28, 3),
                      "outliers_variance": (1, 32, 3)}
    for t in ("outliers_fixNum", "outliers_variance"):
        want = jdef.point_removal(jnp.asarray(pc), t, 4, 1.1, 2)
        got = defense.point_removal(_t(pc), t, 4, 1.1, 2)
        np.testing.assert_array_equal(got.pc.numpy(), np.asarray(want.pc))
    with pytest.raises(ValueError, match="Wrong defense type"):
        defense.point_removal(_t(pc), "nope", 4, 1.1, 2)


# ------------------------------------------------------- masked PointNet ----


@pytest.fixture(scope="module")
def jax_pointnet():
    n = 96
    model = JPointNet(classes=10, npoint=n)
    variables = model.init({"params": jax.random.PRNGKey(0)},
                           jnp.zeros((1, n, 3)), train=False)
    rng = np.random.RandomState(1)
    variables = {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng),
    }
    port = build_model("PointNet", classes=10, npoint=n, device="cpu")
    port.load_state_dict(from_flax_variables(variables))
    return model, variables, port


@pytest.mark.parametrize("mask_kind", ["suffix", "scattered"])
def test_masked_pointnet_matches_jax(jax_pointnet, mask_kind):
    model, variables, port = jax_pointnet
    rng = np.random.RandomState(11)
    pc = rng.randn(2, 96, 3).astype(np.float32)
    pc /= np.linalg.norm(pc, axis=-1).max()
    if mask_kind == "suffix":
        mask = np.arange(96)[None, :] < np.array([[80], [61]])
    else:
        mask = rng.rand(2, 96) < 0.7
    want = np.asarray(model.apply(variables, jnp.asarray(pc), train=False,
                                  point_mask=jnp.asarray(mask)))
    with torch.no_grad():
        got = port(_t(pc), point_mask=_t(mask)).numpy()
    assert np.abs(want).max() > 1e-2
    # test_torch_models.py's tolerance for the same model unmasked
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_point_mask_matches_physical_removal():
    """PointNet(point_mask) equals PointNet on the shrunken cloud when the
    removed points sit at the end (the JAX package's test, on the port)."""
    model, _ = random_victim("PointNet", classes=10, npoint=64, device="cpu")
    rng = np.random.RandomState(0)
    pc_small = rng.randn(1, 48, 3).astype(np.float32)
    pc_padded = np.concatenate([pc_small, np.repeat(pc_small[:, :1], 16, 1)], 1)
    mask = np.zeros((1, 64), bool)
    mask[:, :48] = True
    with torch.no_grad():
        want = model(_t(pc_small)).numpy()
        got = model(_t(pc_padded), point_mask=_t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)


def test_point_mask_must_match_the_cloud():
    model, _ = random_victim("PointNet", classes=10, npoint=64, device="cpu")
    with pytest.raises(ValueError, match="point_mask"):
        model(torch.zeros(1, 64, 3), point_mask=torch.ones(1, 63, dtype=torch.bool))


def test_pnpp_padded_variance_matches_shrunk():
    """PointNet++ on the variance defense's padded cloud (no mask) equals
    PointNet++ on the physically shrunken cloud (the JAX package's test, on
    the port): the repeats of the first kept point sit in the suffix, FPS
    starts at index 0 and never picks them, and a ball query pads with the
    first hit, whose coordinates are theirs."""
    model, _ = random_victim("PointNetPP", classes=10, device="cpu")
    rng = np.random.RandomState(0)
    pc = (0.3 * rng.randn(2, 600, 3)).astype(np.float32)
    pc[:, :4] += 4.0
    res = defense.outliers_variance(_t(pc), alpha=1.1, outlier_knn=2)
    assert (res.num_dropped >= 4).all()
    with torch.no_grad():
        got = model(res.pc).numpy()
        for b in range(2):
            kept = int(res.keep_mask[b].sum())
            want = model(res.pc[b : b + 1, :kept]).numpy()[0]
            np.testing.assert_allclose(got[b], want, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ smoothness ----


def _surface_clouds(seed, b=3, n=128):
    rng = np.random.RandomState(seed)
    return np.stack([sample_shape(i % 10, n, rng)[0] for i in range(b)])


@pytest.mark.parametrize("k,k2", [(8, 8), (16, 12)])
def test_smoothness_matches_jax(k, k2):
    pc = _surface_clouds(0)
    want = np.asarray(jmeas.smoothness(jnp.asarray(pc), k=k, k2=k2))
    values, eigval = measurement.point_smoothness(_t(pc), k=k, k2=k2)
    got = measurement.smoothness(_t(pc), k=k, k2=k2).numpy()
    np.testing.assert_array_equal(got, values.amax(-1).numpy())
    # each cloud's largest value comes from a point whose normal is well
    # defined (the two smallest eigenvalues apart), so 1e-4 holds
    top = values.argmax(-1)
    ev = eigval[torch.arange(len(pc)), top]
    assert ((ev[:, 1] - ev[:, 0]) >= 1e-3 * ev[:, 2]).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


def test_smoothness_plane_vs_noise():
    rng = np.random.RandomState(0)
    sheet = np.zeros((1, 128, 3), np.float32)
    sheet[0, :, :2] = rng.randn(128, 2)
    sheet[0, :, 2] = 0.05 * sheet[0, :, 0] ** 2
    blob = rng.randn(1, 128, 3).astype(np.float32)
    s_sheet = float(measurement.smoothness(_t(sheet), k=8, k2=8)[0])
    s_blob = float(measurement.smoothness(_t(blob), k=8, k2=8)[0])
    assert s_sheet < s_blob


def test_smoothness_batched():
    pc = np.random.RandomState(0).randn(3, 64, 3).astype(np.float32)
    s = measurement.smoothness(_t(pc), k=8, k2=8)
    assert s.shape == (3,) and torch.isfinite(s).all()
