"""The port's ball query, grouping, C-channel scatter and grouped-MLP kernels
against the JAX package, on the CPU.

Each kernel's plain PyTorch version (what the port runs on CPU tensors and
what chip_smoke.py holds the CUDA kernel against on the card) is compared with
the Pallas kernel it replaces, run as tests/test_pallas_kernels.py runs it (in
interpret mode, float32-exact products), and each op with its geoa3_tpu.ops
counterpart (the composed CPU path). Inputs come from numpy seeds. Indices
and gathered rows are equal; sums agree to float32 rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geoa3_tpu import ops as jops
from geoa3_tpu_torch import ops as tops
from geoa3_tpu_torch.ops.kernels import ballquery_group_kernel as bk
from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk
from geoa3_tpu_torch.ops.kernels import scatter_kernel as sk
from tests.test_torch_ops import HILO, _t

torch.set_num_threads(1)
B = 2


def _scene(seed, n=256, m=64, cf=0, scale=0.5):
    """A cloud, centres that are members of it (what FPS hands the query) and
    features."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(B, n, 3) * scale).astype(np.float32)
    feats = rng.randn(B, n, cf).astype(np.float32) if cf else None
    return xyz, xyz[:, :m].copy(), feats, rng


def _line_scene(rng, n=256):
    """Over-full balls (a dense cluster) and empty ones (far centres), as
    tests/test_pallas_kernels.py builds them."""
    xyz = np.zeros((1, n, 3), np.float32)
    xyz[0, :, 0] = np.linspace(0.0, 10.0, n)
    xyz[0, :64] = rng.randn(64, 3) * 0.01
    centres = np.concatenate(
        [xyz[:, :16], np.full((1, 16, 3), 100.0, np.float32)], axis=1)
    return xyz, centres


# ------------------------------------------------------------ ball query ----


@pytest.mark.parametrize("n,m,ns,radius", [
    (256, 64, 32, 0.4),  # most balls under-full: padded with the first hit
    (256, 64, 16, 2.0),  # every ball over-full: the first 16 in index order
    (48, 16, 64, 0.5),  # nsample larger than the cloud
])
def test_ball_query_matches_jax(n, m, ns, radius):
    xyz, centres, _, _ = _scene(60, n, m)
    want = np.asarray(jops.ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(centres)))
    got = tops.ball_query(radius, ns, _t(xyz), _t(centres))
    assert got.dtype == torch.int32 and got.shape == (B, m, ns)
    np.testing.assert_array_equal(got.numpy(), want)


def test_ball_query_empty_and_overfull_balls():
    xyz, centres = _line_scene(np.random.RandomState(61))
    want = np.asarray(jops.ball_query(0.3, 16, jnp.asarray(xyz), jnp.asarray(centres)))
    got = tops.ball_query(0.3, 16, _t(xyz), _t(centres)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[0, 16:].any()  # an empty ball holds index 0 in every slot
    assert (got[0, :16] == np.arange(16)).all()  # the cluster's first 16 points


def test_a_centre_hits_itself_at_any_radius():
    """The expansion gives exactly 0 for a member of the cloud, so a centre's
    own index is always in its ball."""
    xyz, centres, _, _ = _scene(62, 256, 256, scale=5.0)
    got = tops.ball_query(1e-6, 4, _t(xyz), _t(centres))
    assert torch.equal(got[..., 0], torch.arange(256, dtype=torch.int32).expand(B, -1))


# ---------------------------------------------------------- group_points ----


@pytest.mark.parametrize("c", [3, 16])
def test_group_points_value_and_grad_match_jax(c):
    rng = np.random.RandomState(63)
    n, m, ns = 128, 32, 8
    feats = rng.randn(B, n, c).astype(np.float32)
    idx = rng.randint(0, n, (B, m, ns)).astype(np.int32)
    idx[:, :, 1] = idx[:, :, 0]  # the padding's repeats
    w = rng.randn(B, m, ns, c).astype(np.float32)
    want = np.asarray(jops.group_points(jnp.asarray(feats), jnp.asarray(idx)))
    wgrad = np.asarray(jax.grad(lambda f: jnp.sum(
        jops.group_points(f, jnp.asarray(idx)) * w))(jnp.asarray(feats)))
    f = _t(feats).requires_grad_(True)
    got = tops.group_points(f, _t(idx))
    (got * _t(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # float32 sums of the cotangents that meet on one source row
    np.testing.assert_allclose(f.grad.numpy(), wgrad, rtol=1e-6, atol=1e-6)


def test_scatter_add_nc_plain_matches_pallas_kernel():
    from geoa3_tpu.ops.pallas.scatter_kernel import scatter_add_nc_pallas

    rng = np.random.RandomState(64)
    S, C, n = 512, 16, 256
    idx = rng.randint(0, 40, (B, S)).astype(np.int32)  # duplicate-heavy
    ct = rng.randn(B, S, C).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_nc_pallas(jnp.asarray(idx), jnp.asarray(ct), n))
    got = sk.scatter_add_nc(_t(idx), _t(ct), n)
    exact = np.zeros((B, n, C))
    np.add.at(exact, (np.arange(B)[:, None], idx), ct.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
    # the TPU kernel's split-bf16 one-hot products: 2^-16 of each summed term,
    # and a row here sums ~13 of them
    np.testing.assert_allclose(got.numpy(), want, rtol=HILO,
                               atol=16 * HILO * np.abs(ct).max())
    assert sk.scatter_add_nc.launches == 0  # CPU tensors never launch


# where the out-of-range entries go: label -> (the entries, their value)
OUTSIDE = {"n itself": (np.s_[:, ::7], 256), "negative": (np.s_[:, 3::11], -1),
           "far past n": (np.s_[:, 5::9], 10**6), "a whole cloud": (np.s_[1], 256)}


@pytest.mark.parametrize("outside", sorted(OUTSIDE))
def test_scatter_add_nc_drops_out_of_range_rows_as_the_pallas_kernel(outside):
    """Indices outside [0, n) are dropped by the wrapper (its plain version,
    on the CPU) as by the Pallas kernel's one-hot product and the CUDA
    kernel."""
    from geoa3_tpu.ops.pallas.scatter_kernel import scatter_add_nc_pallas

    rng = np.random.RandomState(len(outside))
    S, C, n = 500, 16, 256
    idx = rng.randint(0, 40, (B, S)).astype(np.int32)
    where, value = OUTSIDE[outside]
    idx[where] = value
    ct = rng.randn(B, S, C).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_nc_pallas(jnp.asarray(idx), jnp.asarray(ct), n))
    got = sk.scatter_add_nc(_t(idx), _t(ct), n)
    ok = (idx >= 0) & (idx < n)
    exact = np.zeros((B, n, C))
    np.add.at(exact, (np.arange(B)[:, None].repeat(S, 1)[ok], idx[ok]),
              ct[ok].astype(np.float64))
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-5, atol=1e-5)
    # as above: split-bf16 one-hot products
    np.testing.assert_allclose(got.numpy(), want, rtol=HILO,
                               atol=16 * HILO * np.abs(ct).max())
    assert sk.scatter_add_nc.launches == 0


# ------------------------------------------------- ball query + grouping ----


def _planes_to_4d(gxp, m, ns):
    gxp = np.asarray(gxp)
    return gxp[:, :3].reshape(gxp.shape[0], 3, m, ns).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("n,m,ns,cf,radius", [
    (256, 64, 32, 0, 0.4), (256, 32, 16, 128, 0.5)])
def test_ball_query_group_matches_pallas_kernel(n, m, ns, cf, radius):
    from geoa3_tpu.ops.pallas.ballquery_group_kernel import ball_query_group_planes

    xyz, centres, feats, _ = _scene(65, n, m, cf)
    gxp, wgf = ball_query_group_planes(
        radius, ns, True, jnp.asarray(xyz), jnp.asarray(centres),
        None if feats is None else jnp.asarray(feats))
    idx, gx, gf = tops.ball_query_group(
        _t(xyz), _t(centres), None if feats is None else _t(feats), radius, ns)
    np.testing.assert_array_equal(gx.numpy(), _planes_to_4d(gxp, m, ns))
    np.testing.assert_array_equal(
        idx.numpy(),
        np.asarray(jops.ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(centres))))
    if cf:
        np.testing.assert_array_equal(gf.numpy(), np.asarray(wgf))
    else:
        assert gf is None


def test_ball_query_group_empty_and_overfull_balls():
    from geoa3_tpu.ops.pallas.ballquery_group_kernel import ball_query_group_planes

    xyz, centres = _line_scene(np.random.RandomState(66))
    gxp, _ = ball_query_group_planes(0.3, 16, True, jnp.asarray(xyz),
                                     jnp.asarray(centres), None)
    _, gx, _ = tops.ball_query_group(_t(xyz), _t(centres), None, 0.3, 16)
    np.testing.assert_array_equal(gx.numpy(), _planes_to_4d(gxp, 32, 16))


def test_ball_query_group_grad_matches_pallas_kernel():
    from geoa3_tpu.ops.pallas.ballquery_group_kernel import ball_query_group_planes

    n, m, ns, cf = 256, 32, 16, 128
    xyz, centres, feats, rng = _scene(67, n, m, cf)
    wx = rng.randn(B, m, ns, 3).astype(np.float32)
    wf = rng.randn(B, m, ns, cf).astype(np.float32)
    wxp = np.zeros((B, 8, m * ns), np.float32)
    wxp[:, :3] = wx.transpose(0, 3, 1, 2).reshape(B, 3, m * ns)

    def jloss(x, c, f):
        gxp, gf = ball_query_group_planes(0.5, ns, True, x, c, f)
        return jnp.sum(gxp * wxp) + jnp.sum(gf * wf)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(xyz), jnp.asarray(centres), jnp.asarray(feats))
    args = [_t(a).requires_grad_(True) for a in (xyz, centres, feats)]
    _, gx, gf = tops.ball_query_group(*args, 0.5, ns)
    ((gx * _t(wx)).sum() + (gf * _t(wf)).sum()).backward()
    for a, w, tag in zip(args, want, ("xyz", "centres", "feats")):
        # the TPU backward scatters in split-bf16 passes (the tolerance of
        # tests/test_pallas_kernels.py's own gradient test)
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4, err_msg=tag)


def test_ballquery_group_bwd_plain_is_the_forwards_gradient():
    """The backward the CUDA kernel is held against on the card equals
    autograd through the plain forward."""
    n, m, ns, cf = 128, 16, 8, 5
    xyz, centres, feats, rng = _scene(68, n, m, cf)
    args = [_t(a).requires_grad_(True) for a in (xyz, centres, feats)]
    idx, gx, gf = bk.ballquery_group_plain(*args, 0.4, ns)
    dgx, dgf = _t(rng.randn(*gx.shape).astype(np.float32)), _t(
        rng.randn(*gf.shape).astype(np.float32))
    ((gx * dgx).sum() + (gf * dgf).sum()).backward()
    got = bk.ballquery_group_bwd_plain(idx, dgx, dgf, n)
    for a, g in zip(args, got):
        torch.testing.assert_close(g, a.grad, rtol=1e-6, atol=1e-6)
    assert bk.ballquery_group_bwd_plain(idx, dgx, None, n)[2] is None


def test_repeated_rows_return_the_whole_cotangent_to_their_source():
    """An under-full ball repeats its first hit; the grouped MLP splits a
    pooled cotangent evenly among those tied rows, and the grouping's scatter
    adds the shares up again on the one source point."""
    rng = np.random.RandomState(69)
    xyz = np.zeros((1, 8, 3), np.float32)
    xyz[0, 1:] = 10.0 + rng.randn(7, 3)  # only point 0 lies in the ball
    p = _random_mlp(rng, 0, (8, 8, 16))
    x = _t(xyz).requires_grad_(True)
    centre = _t(xyz[:, :1])
    idx, gx, _ = tops.ball_query_group(x, centre, None, 0.5, 4)
    assert not idx.any()  # four copies of point 0
    pooled = tops.group_mlp_maxpool(gx, None, p)
    w = _t(rng.randn(*pooled.shape).astype(np.float32))
    (pooled * w).sum().backward()
    single = _t(xyz).requires_grad_(True)
    one = tops.group_mlp_maxpool(single[:, None, :1] - centre[:, :, None], None, p)
    # (a 1-row and a 4-row product may round differently in the last bit)
    torch.testing.assert_close(one, pooled, rtol=1e-6, atol=1e-7)
    (one * w).sum().backward()
    torch.testing.assert_close(x.grad[0, 0], single.grad[0, 0], rtol=1e-5, atol=1e-7)
    assert not x.grad[0, 1:].any()


# ----------------------------------------------------------- grouped MLP ----


def _random_mlp(rng, cf, widths):
    parts, cin = [], 3 + cf
    for w in widths:
        # 0.3 keeps the narrow layers' activations near 1; past 512 inputs
        # He's scale does (0.3 would grow them ~10x a layer)
        scale = 0.3 if cin <= 512 else (2.0 / cin) ** 0.5
        parts.append(_t((rng.randn(cin, w) * scale).astype(np.float32)))
        parts.append(_t((rng.randn(w) * 0.1).astype(np.float32)))
        cin = w
    return tops.fold_mlp(*parts)


def _jax_ws(p):
    return tuple(jnp.asarray(t.numpy()) if i % 2 == 0 else jnp.asarray(t.numpy())[None]
                 for i, t in enumerate(p[:6]))


def _planes(gx4):
    b, m, ns, _ = gx4.shape
    gxp = gx4.transpose(0, 3, 1, 2).reshape(b, 3, m * ns)
    return jnp.concatenate([gxp, jnp.zeros((b, 5, m * ns), gxp.dtype)], axis=1)


# (m, ns, cf, widths, ties): ties is None, "pairs" (every odd row repeats
# the even row before it) or rows that repeat row 0
GROUP_MLP_CASES = {
    "SA1-like": (16, 8, 0, (16, 16, 32), None),
    "SA2-like": (8, 8, 128, (32, 32, 64), None),
    "GroupAll-like": (1, 16, 128, (32, 64, 128), None),
    "ties": (8, 8, 0, (16, 16, 32), "pairs"),
    # one cloud, rows tied across its halves: the tied rows' equal shares
    # of the gradient, on the CPU against Pallas (the card's split over
    # blocks is held on the CPU by test_torch_group_mlp_emulated.py's
    # "ns=200 split" and SA3 cases)
    "GroupAll-split": (1, 64, 128, (32, 64, 128), (31, 32, 63)),
}


@pytest.mark.parametrize("case", sorted(GROUP_MLP_CASES))
def test_group_mlp_value_and_grad_match_pallas_kernel(case):
    from geoa3_tpu.ops.pallas.group_mlp_kernel import group_mlp_maxpool

    m, ns, cf, widths, ties = GROUP_MLP_CASES[case]
    rng = np.random.RandomState(70)
    gx = rng.randn(B, m, ns, 3).astype(np.float32)
    gf = rng.randn(B, m, ns, cf).astype(np.float32) if cf else None
    if ties == "pairs":
        gx[:, :, 1::2] = gx[:, :, ::2]
    elif ties:
        gx[:, :, list(ties)] = gx[:, :, :1]
        gf[:, :, list(ties)] = gf[:, :, :1]
    p = _random_mlp(rng, cf, widths)
    ws = _jax_ws(p)
    tgt = rng.randn(B, m, widths[-1]).astype(np.float32)

    def jloss(x, f):
        out = group_mlp_maxpool(_planes(x), f, ns, True, ws)
        return jnp.sum((out - tgt) ** 2), out

    jargs = (jnp.asarray(gx), None if gf is None else jnp.asarray(gf))
    (_, want), wgrads = jax.value_and_grad(
        jloss, argnums=(0, 1) if cf else (0,), has_aux=True)(*jargs)

    x = _t(gx).requires_grad_(True)
    f = _t(gf).requires_grad_(True) if cf else None
    got = tops.group_mlp_maxpool(x, f, p)
    ((got - _t(tgt)) ** 2).sum().backward()
    # three layers of float32 products in other summation orders (the TPU
    # kernel: three bf16 passes a product)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    for a, w in zip((x, f) if cf else (x,), wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    if ties == "pairs":
        # tied rows share a maximum's cotangent evenly
        np.testing.assert_array_equal(x.grad[:, :, 1::2].numpy(),
                                      x.grad[:, :, ::2].numpy())
    elif ties:
        rows = list(ties)
        assert (got.detach() == tops.group_mlp_maxpool(
            x[:, :, :1].detach(), f[:, :, :1].detach(), p)).any()
        for a in (x, f):
            np.testing.assert_array_equal(
                a.grad[:, :, rows].numpy(),
                np.broadcast_to(a.grad[:, :, :1].numpy(), a.grad[:, :, rows].shape))


def _off_near_ties(a3, out, tgt):
    """tgt where each pooled maximum is clear, `out` itself where the
    maximum lies within rounding (1e-5 of the largest entry) of a runner-up
    without an exact tie, or of 0: there float32 sums in another order may
    rightly pick another row, so no cotangent is sent (a3 [..., ns, c],
    out = its max over ns)."""
    top2 = torch.topk(a3, 2, dim=-2).values
    gap = top2[..., 0, :] - top2[..., 1, :]
    tol = 1e-5 * out.abs().max()
    fragile = ((gap > 0) & (gap < tol)) | (top2[..., 0, :] < tol)
    return np.where(fragile.numpy(), out.numpy(), tgt).astype(np.float32)


def test_group_mlp_at_groupall_cf2048_matches_pallas_kernel():
    """GroupAll past the whole input's limit of the card's kernels (which
    stage layer 1's input in slices there), with rows tied across the
    card's 32-row parts, against the JAX kernel (interpret mode). K = 2051
    float32 products a layer-1 sum in other orders than the TPU kernel's
    split bf16: values held to 1e-4 of the largest entry, gradients to 1e-3
    (as tests/test_torch_sa_fused.py holds the whole-scale op), with the
    cotangent kept off maxima within rounding of a runner-up."""
    from geoa3_tpu.ops.pallas.group_mlp_kernel import group_mlp_maxpool

    cf, ns, widths = 2048, 128, (256, 512, 1024)
    rng = np.random.RandomState(73)
    gx = rng.randn(B, 1, ns, 3).astype(np.float32)
    gf = rng.randn(B, 1, ns, cf).astype(np.float32)
    gx[:, :, [31, 32, 127]] = gx[:, :, :1]
    gf[:, :, [31, 32, 127]] = gf[:, :, :1]
    p = _random_mlp(rng, cf, widths)
    with torch.no_grad():
        a = torch.relu(_t(gx) @ p.w1[:3] + _t(gf) @ p.w1[3:] + p.b1)
        a = torch.relu(torch.relu(a @ p.w2 + p.b2) @ p.w3 + p.b3)
    tgt = _off_near_ties(a, a.amax(dim=2), rng.randn(B, 1, widths[-1]))
    ws = _jax_ws(p)

    def jloss(x, f):
        out = group_mlp_maxpool(_planes(x), f, ns, True, ws)
        return jnp.sum((out - tgt) ** 2), out

    (_, want), wgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(gx), jnp.asarray(gf))
    x, f = _t(gx).requires_grad_(True), _t(gf).requires_grad_(True)
    got = tops.group_mlp_maxpool(x, f, p)
    ((got - _t(tgt)) ** 2).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    for a_, w in zip((x, f), wgrads):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(a_.grad.numpy(), w, rtol=0,
                                   atol=1e-3 * np.abs(w).max())
    # the rows tied to row 0 share its cotangent evenly
    for a_ in (x, f):
        np.testing.assert_array_equal(
            a_.grad[:, :, [31, 32, 127]].numpy(),
            np.broadcast_to(a_.grad[:, :, :1].numpy(), (B, 1, 3, a_.shape[-1])))


# (cf, widths, nsample) of every grouped MLP the SSG and MSG victims run
# through group_mlp: SSG SA1-SA3, MSG SA1's three scales and GroupAll, with
# the forward's tile height and split at each, and its shared memory there
FWD_SHAPES = {
    "SSG SA1": (0, (64, 64, 128), 64, (128, 1), 90112),
    "SSG SA2": (128, (128, 128, 256), 64, (64, 1), 115712),
    "SSG SA3": (256, (256, 512, 1024), 128, (32, 4), 196608),
    "MSG SA1 ns=16": (0, (32, 32, 64), 16, (128, 1), 45056),
    "MSG SA1 ns=32": (0, (64, 64, 128), 32, (128, 1), 90112),
    "MSG SA1 ns=128": (0, (64, 96, 128), 128, (128, 1), 106496),
    "MSG GroupAll": (640, (256, 512, 1024), 128, (32, 4), 213504),
}


@pytest.mark.parametrize("shape", sorted(FWD_SHAPES))
def test_group_mlp_forward_plan_fits_every_victim_shape(shape):
    cf, widths, ns, plan, smem = FWD_SHAPES[shape]
    assert gk.fwd_plan(ns, cf, widths) == plan
    assert gk.fwd_smem_bytes(cf, widths, plan[0]) == smem <= gk._SMEM_MAX
    assert gk.fwd_smem_bytes(cf, widths, 32) <= gk._SMEM_MAX  # the 32-row need


@pytest.mark.parametrize("cf, smem", [(896, 172288), (1536, 213248)])
def test_group_mlp_forward_takes_wide_groupall_on_16_row_tiles(cf, smem):
    # past 32-row tiles (246,272 bytes at cf = 896): 16 rows, 8 parts a cloud
    widths = (256, 512, 1024)
    assert gk.fwd_smem_bytes(cf, widths, 32) > gk._SMEM_MAX
    assert gk.fwd_plan(128, cf, widths) == (16, 8)
    assert gk.fwd_smem_bytes(cf, widths) == smem


# the backward's tile height and split at the same shapes, its shared
# memory there (ring stages of 32 weight rows above 16-row tiles; dz3 as
# hit bits and cotangent shares where ns >= 64), and GroupAll at cf = 1557
BWD_SHAPES = {
    "SSG SA1": (0, (64, 64, 128), 64, (256, 1), 161792),
    "SSG SA2": (128, (128, 128, 256), 64, (128, 1), 188416),
    "SSG SA3": (256, (256, 512, 1024), 128, (32, 4), 204800),
    "MSG SA1 ns=16": (0, (32, 32, 64), 16, (256, 1), 155648),
    "MSG SA1 ns=32": (0, (64, 64, 128), 32, (128, 1), 180224),
    "MSG SA1 ns=128": (0, (64, 96, 128), 128, (256, 1), 193536),
    "MSG GroupAll": (640, (256, 512, 1024), 128, (32, 4), 221696),
    "GroupAll cf=1557": (1557, (256, 512, 1024), 128, (16, 8), 220672),
}


@pytest.mark.parametrize("shape", sorted(BWD_SHAPES))
def test_group_mlp_backward_plan_fits_every_victim_shape(shape):
    cf, widths, ns, plan, smem = BWD_SHAPES[shape]
    assert gk.bwd_plan(ns, cf, widths) == plan
    assert gk.bwd_smem_bytes(ns, cf, widths, plan[0]) == smem <= gk._SMEM_MAX
    gk.fwd_plan(ns, cf, widths)  # the forward takes it too


def test_group_mlp_forward_refuses_what_cannot_fit():
    # GroupAll's widths fit the forward's 16-row tiles with the whole input
    # up to cf = 1837 and the backward's up to cf = 1741 (its hit bits and
    # cotangent shares take 6,144 bytes more), each then taking all of a
    # block; past those layer 1's input is staged in slices, so cf sets no
    # limit (test_group_mlp_takes_any_cf_at_groupall_widths)
    widths = (256, 512, 1024)
    assert gk.fwd_smem_bytes(1837, widths) == gk._SMEM_MAX
    assert gk.fwd_smem_bytes(1838, widths) == 232704
    assert gk.bwd_smem_bytes(128, 1741, widths) == gk._SMEM_MAX
    assert gk.bwd_smem_bytes(128, 1742, widths) == 232704
    assert gk.tile_plan(128, 1837, widths, False) == (16, 8, 16, 0, gk._SMEM_MAX)
    assert gk.tile_plan(128, 1741, widths, True) == (16, 8, 16, 0, gk._SMEM_MAX)
    # what cannot fit is a pair of widths: the forward's 16-row tile with
    # 16-channel input slices takes c1 + max(c2, 16) <= 2096
    assert gk.tile_plan(16, 0, (1040, 1056, 16), False) == (16, 1, 16, 0, gk._SMEM_MAX)
    with pytest.raises(ValueError, match="forward's 16-row tile needs 232704 bytes"):
        gk.fwd_plan(16, 0, (1040, 1060, 16))
    rng = np.random.RandomState(72)
    p = _random_mlp(rng, 0, (1040, 1060, 16))
    with pytest.raises(ValueError, match="forward's 16-row tile needs 232704 bytes"):
        gk.group_mlp_fwd(torch.zeros(1, 1, 16, 3), None, p)
    # the backward's limit (8-channel slices, hit bits, 8-row ring stages)
    # lies past the forward's at any c1 + c2, in c3: 8200 columns fit the
    # forward but not the backward (183,392 bytes past the ring's 49,152),
    # and the wrapper refuses the pair
    assert gk.fwd_plan(16, 0, (1040, 1056, 8200)) == (16, 1)
    with pytest.raises(ValueError, match="backward's 16-row tile needs 232544 bytes"):
        gk.bwd_plan(16, 0, (1040, 1056, 8200))
    p = _random_mlp(rng, 0, (1040, 1056, 8200))
    with pytest.raises(ValueError, match="backward's 16-row tile needs 232544 bytes"):
        gk.group_mlp_fwd(torch.zeros(1, 1, 16, 3), None, p)
    # layer 2 of 1024 columns beside 640 features, refused by the backward
    # until dz3 went to hit bits: both kernels now take it on 16-row tiles
    widths = (256, 1024, 1024)
    assert gk.fwd_plan(128, 640, widths) == gk.bwd_plan(128, 640, widths) == (16, 8)
    assert gk.fwd_smem_bytes(640, widths) == 180224
    assert gk.bwd_smem_bytes(128, 640, widths) == 186368


# GroupAll's widths past the whole input's limits: 32-row tiles (4 parts a
# cloud) with layer 1's input in the widest slices that fit, a multiple of
# 16 channels (both kernels' ring depth), at cf = 1838 (the forward's first
# sliced cf), 1901 (the scalar staging path), 2048 and 4096
@pytest.mark.parametrize("cf", [1838, 1901, 2048, 4096])
def test_group_mlp_takes_any_cf_at_groupall_widths(cf):
    widths = (256, 512, 1024)
    assert gk.tile_plan(128, cf, widths, False) == (32, 4, 16, 784, 231424)
    assert gk.tile_plan(128, cf, widths, True) == (32, 4, 16, 720, 231424)
    assert gk._smem_bytes(128, cf, widths, 32, False, kin=784) == 231424
    assert gk._smem_bytes(128, cf, widths, 32, False, kin=800) > gk._SMEM_MAX


# widths of 1024, which the JAX package's gate admits: the forward keeps the
# whole input to cf = 1021; the backward takes dz3 as hit bits and 8-row
# ring stages on 16-row tiles (dz3 as [c3][R] and the 16-row ring need
# 295,936 bytes at cf = 1024)
@pytest.mark.parametrize("ns, cf, fwd, bwd", [
    (16, 1024, (16, 1, 16, 0, 229632), (16, 1, 8, 0, 186624)),
    (128, 1024, (16, 8, 16, 0, 229632), (16, 8, 8, 0, 186624)),
    (4, 0, (16, 1, 16, 0, 229376), (16, 1, 8, 0, 190464)),
    (32, 2000, (16, 2, 16, 1072, 232448), (16, 2, 8, 1744, 232448)),
])
def test_group_mlp_takes_widths_of_1024(ns, cf, fwd, bwd):
    widths = (1024, 1024, 1024)
    assert gk.tile_plan(ns, cf, widths, False) == fwd
    assert gk.tile_plan(ns, cf, widths, True) == bwd


def test_group_mlp_checks_its_weights():
    rng = np.random.RandomState(71)
    p = _random_mlp(rng, 0, (8, 8, 16))
    gx = torch.zeros(1, 2, 4, 3)
    assert tops.group_mlp_maxpool(gx, None, p).shape == (1, 2, 16)
    assert p.w1t.shape == (8, 4) and not p.w1t[:, 3].any()  # padded to 4 columns
    assert gk.group_mlp_fwd.launches == gk.group_mlp_bwd.launches == 0


# ------------------------------------------- k-neighbour 3-channel scatter ----


def test_scatter_add_3_plain_matches_pallas_kernel():
    """idx [b, n, k] into m rows, as tests/test_pallas_kernels.py's
    TestScatterKernel runs the JAX kernel (interpret mode)."""
    from geoa3_tpu.ops.pallas.scatter_kernel import scatter_add_pallas

    rng = np.random.RandomState(90)
    b, n, k, m = 2, 64, 5, 256
    idx = rng.randint(0, m, (b, n, k)).astype(np.int32)
    ct = rng.randn(b, n, k, 3).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(scatter_add_pallas(jnp.asarray(idx), jnp.asarray(ct), m))
    got = tops.scatter_add_3(_t(idx), _t(ct), m)
    # the TPU kernel sums split-bf16 products (hi + lo, ~2^-16 relative)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    # rows outside [0, m) are dropped, as the one-hot product drops them
    bad = idx.copy()
    bad[:, :, 0] = m
    bad[:, :, 1] = -1
    keep = np.zeros_like(ct)
    keep[:, :, 2:] = ct[:, :, 2:]
    np.testing.assert_array_equal(tops.scatter_add_3(_t(bad), _t(ct), m).numpy(),
                                  tops.scatter_add_3(_t(idx), _t(keep), m).numpy())
    assert sk.scatter_add_3.launches == 0


# ------------------------------------------------- 3-NN interpolation ----


def test_three_nn_matches_jax():
    rng = np.random.RandomState(91)
    unknown = rng.randn(B, 128, 3).astype(np.float32)
    known = rng.randn(B, 32, 3).astype(np.float32)
    known[:, 5] = known[:, 9]  # a tie: the lower index comes first
    wd, wi = jops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    d, i = tops.three_nn(_t(unknown), _t(known))
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
    # the same squared differences summed in the same order, then sqrt
    np.testing.assert_allclose(d.numpy(), np.asarray(wd), rtol=1e-6, atol=0)
    assert not d.requires_grad


def test_three_interpolate_value_and_grads_match_jax():
    rng = np.random.RandomState(92)
    feats = rng.randn(B, 32, 24).astype(np.float32)
    idx = rng.randint(0, 32, (B, 128, 3)).astype(np.int32)
    weight = rng.rand(B, 128, 3).astype(np.float32)
    ct = rng.randn(B, 128, 24).astype(np.float32)

    def jloss(f, w):
        out = jops.three_interpolate(f, jnp.asarray(idx), w)
        return jnp.sum(out * ct), out

    (_, want), (wf, ww) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feats), jnp.asarray(weight))
    f, w = _t(feats).requires_grad_(True), _t(weight).requires_grad_(True)
    got = tops.three_interpolate(f, _t(idx), w)
    (got * _t(ct)).sum().backward()
    # three products summed per entry; the gather's backward sums colliding
    # rows in another order
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(wf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(ww), rtol=1e-5, atol=1e-5)


def _fp_state_dict(variables):
    """The JAX FP module's {params, batch_stats} -> the port's state_dict
    (`mlp.{3k}` Conv2d, `mlp.{3k+1}` BatchNorm2d)."""
    params, stats = variables["params"]["mlp"], variables["batch_stats"]["mlp"]
    sd = {}
    for k in range(len([c for c in params if c.startswith("conv")])):
        sd[f"mlp.{3 * k}.weight"] = _t(np.asarray(params[f"conv{k}"]["kernel"]).T[..., None, None].copy())
        bn, st = params[f"bn{k}"], stats[f"bn{k}"]
        sd[f"mlp.{3 * k + 1}.weight"] = _t(np.asarray(bn["scale"]))
        sd[f"mlp.{3 * k + 1}.bias"] = _t(np.asarray(bn["bias"]))
        sd[f"mlp.{3 * k + 1}.running_mean"] = _t(np.asarray(st["mean"]))
        sd[f"mlp.{3 * k + 1}.running_var"] = _t(np.asarray(st["var"]))
        sd[f"mlp.{3 * k + 1}.num_batches_tracked"] = torch.tensor(0)
    return sd


@pytest.mark.parametrize("with_known", [True, False])
def test_fp_module_value_and_grads_match_jax(with_known):
    """PointnetFPModule (two layers, non-pooled) against the JAX module's
    CPU path, with random BatchNorm statistics: interpolated from 3 known
    points, or (no known points) one broadcast feature row."""
    from geoa3_tpu.models.pointnetpp import PointnetFPModule as JFP
    from geoa3_tpu_torch.models.pointnetpp import PointnetFPModule
    from tests.test_torch_models import _randomise_bn

    rng = np.random.RandomState(93)
    n, m, c1, c2 = 96, 24 if with_known else 1, 8, 16
    unknown = rng.randn(B, n, 3).astype(np.float32)
    known = rng.randn(B, m, 3).astype(np.float32) if with_known else None
    ufeats = rng.randn(B, n, c1).astype(np.float32)
    kfeats = rng.randn(B, m, c2).astype(np.float32)
    ct = rng.randn(B, n, 32).astype(np.float32)
    jmod = JFP(mlp=(32, 32))
    jargs = [jnp.asarray(unknown), None if known is None else jnp.asarray(known),
             jnp.asarray(ufeats), jnp.asarray(kfeats)]
    variables = jmod.init({"params": jax.random.PRNGKey(3)}, *jargs, train=False)
    variables = {"params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
                 "batch_stats": _randomise_bn(
                     jax.tree.map(np.asarray, variables["batch_stats"]), rng)}

    def jloss(uf, kf):
        out = jmod.apply(variables, jargs[0], jargs[1], uf, kf, train=False)
        return jnp.sum(out * ct), out

    (_, want), wgrads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jargs[2], jargs[3])
    mod = PointnetFPModule([c2 + c1, 32, 32]).eval()
    mod.load_state_dict(_fp_state_dict(variables))
    uf, kf = _t(ufeats).requires_grad_(True), _t(kfeats).requires_grad_(True)
    got = mod(_t(unknown), None if known is None else _t(known), uf, kf)
    (got * _t(ct)).sum().backward()
    # two float32 layers in other summation orders
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    for g, w in zip((uf.grad, kf.grad), wgrads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
