"""The port's whole-scale set-abstraction op (`ops.sa_query_group_mlp`)
against the JAX package's Pallas kernel, on the CPU.

The port's plain version (what it runs on CPU tensors and what chip_smoke.py
holds the CUDA kernels against on the card) is compared with
geoa3_tpu/ops/pallas/sa_fused_kernel.py:sa_query_group_mlp run as
tests/test_pallas_kernels.py runs it: in interpret mode with float32-exact
products (f32_exact=True). Shapes are the JAX tests' (SSG SA1-like, SSG
SA2-like, MSG SA2-like with 320 feature channels), plus empty and over-full
balls and balls of one repeated point. Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geoa3_tpu.ops.pallas.sa_fused_kernel import sa_query_group_mlp as jsa
from geoa3_tpu_torch import ops as tops
from geoa3_tpu_torch.ops.kernels import sa_fused_kernel as sf
from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs
from tests.test_torch_grouping import _jax_ws, _line_scene, _off_near_ties, _random_mlp
from tests.test_torch_ops import _t

torch.set_num_threads(1)
B = 2


def _scene(seed, n, m, cf):
    """A cloud, centres that are members of it (what FPS hands the query),
    features, and the rng for what follows."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(B, n, 3) * 0.5).astype(np.float32)
    feats = rng.randn(B, n, cf).astype(np.float32) if cf else None
    return xyz, xyz[:, :m].copy(), feats, rng


def _jax(radius, ns, xyz, cen, feats, p, tgt):
    """The JAX kernel's pooled output and the gradients of
    sum((out - tgt)^2) in xyz, the centres and (with features) feats."""
    ws = _jax_ws(p)

    def loss(x, c, f):
        out = jsa(radius, ns, True, x, c, f, ws)
        return jnp.sum((out - tgt) ** 2), out

    args = (jnp.asarray(xyz), jnp.asarray(cen),
            None if feats is None else jnp.asarray(feats))
    with pltpu.force_tpu_interpret_mode():
        (_, out), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2) if feats is not None else (0, 1),
            has_aux=True)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port(radius, ns, xyz, cen, feats, p, tgt):
    ins = [_t(xyz).requires_grad_(True), _t(cen).requires_grad_(True)]
    if feats is not None:
        ins.append(_t(feats).requires_grad_(True))
    out = tops.sa_query_group_mlp(ins[0], ins[1], ins[2] if feats is not None else None,
                                  radius, ns, p)
    ((out - _t(tgt)) ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ins]


def _compare(got, want):
    (out, grads), (wout, wgrads) = got, want
    # values: layer 1 from per-point projections (the JAX kernel gathers them
    # with exact three-way bf16 splits), two more float32 layers in other
    # summation orders: held to 1e-4 of the largest entry
    np.testing.assert_allclose(out, wout, rtol=0, atol=1e-4 * np.abs(wout).max())
    # gradients: the same, plus the scatter's summation order and ReLU or
    # maximum switches within rounding: held to 1e-3 of the largest entry
    for g, w, what in zip(grads, wgrads, ("xyz", "new_xyz", "feats")):
        assert np.abs(w).max() > 0, what
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                   err_msg=what)


@pytest.mark.parametrize("n,m,ns,cf,widths,radius", [
    (256, 64, 32, 0, (16, 16, 32), 0.4),  # SSG SA1-like
    (256, 32, 16, 128, (32, 32, 64), 0.5),  # SSG SA2-like
    (256, 32, 16, 320, (32, 32, 64), 0.5),  # MSG SA2-like (cf % 128 != 0)
])
def test_value_and_grads_match_pallas_kernel(n, m, ns, cf, widths, radius):
    xyz, cen, feats, rng = _scene(80 + cf, n, m, cf)
    p = _random_mlp(rng, cf, widths)
    tgt = rng.randn(B, m, widths[-1]).astype(np.float32)
    _compare(_port(radius, ns, xyz, cen, feats, p, tgt),
             _jax(radius, ns, xyz, cen, feats, p, tgt))


def test_widths_of_1024_match_pallas_kernel():
    """The widest MLP the JAX package's gate admits (the card's backward
    takes it on 16-row tiles with 8-row ring stages and hit bits), held as
    the shapes above, with the cotangent kept off maxima within rounding
    of a runner-up and off the balls whose rows hold a hidden unit within
    rounding of 0 (1e-6 of its layer's largest pre-activation: sums of 1024
    float32 products in other orders differ by about that much): among
    1024 channels and 2048 hidden units a row, some lie that close, and the
    two versions may rightly take either side."""
    widths = (1024, 1024, 1024)
    xyz, cen, feats, rng = _scene(84, 256, 16, 64)
    p = _random_mlp(rng, 64, widths)
    x, c, f = _t(xyz), _t(cen), _t(feats)
    idx = tops.ball_query(0.5, 16, x, c)
    with torch.no_grad():
        prj = x @ p.w1[:3] + f @ p.w1[3:]
        z1 = (gather_nbrs(prj, idx) - (c @ p.w1[:3])[:, :, None]) + p.b1
        z2 = torch.relu(z1) @ p.w2 + p.b2
        a = torch.relu(torch.relu(z2) @ p.w3 + p.b3)
        fragile = torch.zeros(B, 16, dtype=torch.bool)
        for z in (z1, z2):
            fragile |= (z.abs() < 1e-6 * z.abs().max()).any(-1).any(-1)
    out = a.amax(dim=2)
    tgt = _off_near_ties(a, out, rng.randn(B, 16, widths[-1]))
    tgt = np.where(fragile[..., None].numpy(), out.numpy(), tgt)
    assert fragile.sum() <= 8  # most balls carry a cotangent
    _compare(_port(0.5, 16, xyz, cen, feats, p, tgt),
             _jax(0.5, 16, xyz, cen, feats, p, tgt))


def test_empty_and_overfull_balls_match_pallas_kernel():
    """A dense cluster (over-full balls: the first 16 hits in index order)
    and far centres (empty balls: every slot holds point 0)."""
    rng = np.random.RandomState(81)
    xyz, cen = _line_scene(rng)
    p = _random_mlp(rng, 0, (16, 16, 32))
    tgt = rng.randn(1, 32, 32).astype(np.float32)
    got, want = (f(0.3, 16, xyz, cen, None, p, tgt) for f in (_port, _jax))
    _compare(got, want)
    # an empty ball holds point 0 in every slot and pools its row, centred
    # on the far centre (here as a ball of one slot around that centre)
    far = _t(cen[:, 16:17])
    assert not tops.ball_query(0.3, 16, _t(xyz), far).any()
    empty = sf.sa_query_group_mlp_plain(_t(xyz), far, None, 0.3, 16, p)
    first = sf.sa_query_group_mlp_plain(_t(xyz), far, None, 1e3, 1, p)
    # the same rows through matrix products of 16 rows and of 1
    torch.testing.assert_close(empty, first, rtol=0,
                               atol=1e-6 * first.abs().max().item())


def test_balls_of_one_repeated_point_match_pallas_kernel():
    """A tight radius around isolated points: most balls hold only their
    centre, every other slot a padded repeat of it, so every maximum is a
    tie; the shares of a tie all go back to the one point."""
    rng = np.random.RandomState(82)
    xyz = (rng.randn(1, 256, 3) * 5.0).astype(np.float32)
    cen = xyz[:, :16].copy()
    p = _random_mlp(rng, 0, (16, 16, 32))
    tgt = np.zeros((1, 16, 32), np.float32)
    _compare(_port(0.1, 16, xyz, cen, None, p, tgt),
             _jax(0.1, 16, xyz, cen, None, p, tgt))


def test_plain_version_is_the_grouped_mlp_of_the_ball_query():
    """The projected association (P[idx] - Yc) + b1 equals layer 1 of the
    gathered, centred rows to float32 rounding: the split pair (ball query +
    grouping, then the grouped MLP) gives the same pooled output."""
    xyz, cen, feats, rng = _scene(83, 256, 32, 5)
    p = _random_mlp(rng, 5, (8, 8, 16))
    x, c, f = _t(xyz), _t(cen), _t(feats)
    _, gx, gf = tops.ball_query_group(x, c, f, 0.5, 16)
    want = tops.group_mlp_maxpool(gx, gf, p)
    got = tops.sa_query_group_mlp(x, c, f, 0.5, 16, p)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    assert sf.sa_fused_fwd.launches == sf.sa_fused_bwd.launches == 0  # CPU: plain


def test_balls_the_card_splits_match_pallas_kernel():
    """nsample = 96 at MSG SA2's widths and features: the card's forward
    takes 64-row tiles there (`fwd_plan`), so each ball is two parts, the
    second half padding, whose partials a finishing kernel merges. On the
    CPU the port's plain version, held as the shapes above."""
    widths = (128, 128, 256)
    assert sf.fwd_plan(96, widths)[:2] == (64, 2)
    xyz, cen, feats, rng = _scene(85, 256, 16, 320)
    p = _random_mlp(rng, 320, widths)
    tgt = rng.randn(B, 16, widths[-1]).astype(np.float32)
    _compare(_port(0.8, 96, xyz, cen, feats, p, tgt),
             _jax(0.8, 96, xyz, cen, feats, p, tgt))


def test_features_past_2902_channels_match_the_split_pair():
    """cf = 3000, past the 2902 channels the projections' old whole-input
    tile took: the wrapper's plan takes it, and the port's op agrees with
    the split pair (ball query + grouping, then the grouped MLP) as at cf = 5
    above. The JAX package's gate stops at cf = 1024, so the split pair is
    the reference here; the emulated kernel test runs the CUDA source at
    this cf."""
    xyz, cen, feats, rng = _scene(86, 128, 16, 3000)
    p = _random_mlp(rng, 3000, (32, 32, 64))
    x, c, f = _t(xyz), _t(cen), _t(feats)
    _, gx, gf = tops.ball_query_group(x, c, f, 0.5, 16)
    want = tops.group_mlp_maxpool(gx, gf, p)
    got = tops.sa_query_group_mlp(x, c, f, 0.5, 16, p)
    assert want.abs().max() > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())


def test_shared_memory_check_follows_the_kernels():
    """The wrapper's check takes the forward's plan (csrc/sa_fused.cu
    sa_fwd_plan: tile_loop.cuh pick_fwd) and the backward's (sa_bwd_plan):
    MSG SA2's scales
    and SA1 with normals fit, and so does every shape the JAX package's
    gate admits, up to widths of 1024 and cf = 1024 (the forward on 16-row
    tiles, each ball in ns / 16 parts; the backward on 16-row tiles with
    8-row ring stages and hit bits). No nsample is refused: a ball of 60000
    rows is 469 parts of 128. The forward refuses c1 + c2 > 2095; the
    projections stream their input in k-slices, so no cf is refused."""
    # the forward: 64-row tiles (two blocks an SM) past 64 channels at MSG
    # SA2, ns = 128 in two parts; 128-row tiles at SA1 with normals
    assert sf.fwd_plan(32, (64, 64, 128)) == (128, 1, 90624)
    assert sf.fwd_plan(64, (128, 128, 256)) == (64, 1, 114944)
    assert sf.fwd_plan(128, (128, 128, 256)) == (64, 2, 114944)
    assert sf.fwd_plan(16, (32, 32, 64)) == (128, 1, 45568)
    assert sf.fwd_plan(32, (64, 64, 128)) == (128, 1, 90624)
    assert sf.fwd_plan(128, (64, 96, 128)) == (128, 1, 107008)
    assert sf.fwd_plan(60000, (32, 32, 64)) == (128, 469, 45568)
    assert sf.bwd_plan(60000, (32, 32, 64))[4] <= sf._SMEM_MAX
    # the limits: 16-row tiles take c1 + c2 <= 2095; cf does not enter (the
    # projections take any cf: the cf = 3000 tests here and emulated)
    assert sf.fwd_plan(16, (1044, 1048, 64)) == (16, 1, 232256)
    with pytest.raises(ValueError, match="shared memory"):
        sf.fwd_plan(16, (1048, 1048, 64))
    # MSG SA2's scales: 128-row tiles, 32-row ring stages, hit bits at 64+
    assert sf.bwd_plan(32, (64, 64, 128)) == (128, 1, 32, False, 180736)
    assert sf.bwd_plan(64, (128, 128, 256)) == (128, 1, 32, True, 186880)
    assert sf.bwd_plan(128, (128, 128, 256)) == (128, 1, 32, True, 185856)
    widths = (1024, 1024, 1024)
    for ns in (16, 32, 64, 128):
        assert sf.fwd_plan(ns, widths) == (16, max(1, ns // 16), 229440)
        rows, parts, depth, sparse, smem = sf.bwd_plan(ns, widths)
        assert (rows, depth, sparse) == (16, 8, True) and smem <= sf._SMEM_MAX
        assert parts == max(1, ns // 16)
    # dz3 as [c3][R] and 16-row ring stages would take 294,976 bytes
    assert sf._bwd_smem(16, widths, 16, 16, False) == 294976
