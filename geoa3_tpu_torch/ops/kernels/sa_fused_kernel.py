"""One whole set-abstraction scale (ball query, grouping, a three-layer MLP
and the max over each ball): CUDA kernel wrappers and their plain version.

Replaces geoa3_tpu/ops/pallas/sa_fused_kernel.py:_fwd_kernel and
:_bwd_kernel (`sa_query_group_mlp`). Source: csrc/sa_fused.cu (its own
projection tiles), with the ball query of csrc/ballquery.cuh and the tile
loop of csrc/tile_loop.cuh (row 16's) for the forward's and the backward's
layers.

Layer 1 is linear, so it is projected once a point and once a centre:
P = xyz @ W1x + feats @ W1f [b, n, c1], Yc = new_xyz @ W1x [b, m, c1], and a
grouped row's pre-activation is z1 = (P[idx] - Yc) + b1, in that
association (the plain version fixes it, the kernels follow it). Two more
folded-BatchNorm affine+ReLU layers and the max over the ns slots follow
(ties split evenly, ReLU'(0) = 0). The grouped rows never reach device
memory, and a gathered row is c1 floats wide instead of 3 + cf.

The forward runs the ball queries in a pass of their own (one warp a
centre, into idx), then tiles of whole balls, or of one part of a ball
larger than the tile, on the loop: a1 gathered from P, Yc and idx into
shared memory, w2 and w3 streamed through the weight ring, the maximum and
its tie count reduced in registers and by shuffles; a split ball's parts
write partials that a finishing kernel merges exactly (a maximum and an
integer sum). The backward recomputes a tile's layers from the forward's
idx, P and Yc with the same gather on the same loop (bitwise the forward's
activations), scatters dz1 (c1 wide) over idx into dP [b, n, c1] by float4
atomics and sums dYc = -sum_s dz1 per centre, then projects back once:
dxyz = dP @ W1x^T, dfeats = dP @ W1f^T, dnew_xyz = dYc @ W1x^T. Weights are
a frozen victim's and indices carry no gradient; dP, and dYc where a ball
is split over tiles, sum in atomic order, so their last bits vary between
calls.

Bound on the H100: operations (the projections, 2 b m ns (c1 c2 + c2 c3)
forward; backward the recompute of layers 2-3, dz3 @ w3t over dz3's nonzero
entries and d2 @ w2t over the rows that carry a cotangent, the
back-projections). The kernels are float32 (no TF32): the victim's numerics
stay those of the CPU reference. One launch of `sa_fused_fwd` runs three
device kernels (the point and centre projections together, the ball
queries, the tiles), and a finishing kernel where balls are split; one of
`sa_fused_bwd` runs two (the recompute + scatter, then the
back-projections of dP and dYc together), and a memset of dYc where balls
are split. The projections stream their input through a ring of k-slices,
so they take any cf.

Limits: the three widths are multiples of 4; n >= 1; ns and cf are any
size. The forward's tiles (`fwd_plan`) need (c1 + c2) 64 + 98,368 bytes of
shared memory at 16 rows, so c1 + c2 <= 2095; the backward's plan
(`bwd_plan`) takes every shape whose widths are at most 1024, on 16-row
tiles with 8-row ring stages and dz3 as hit bits where nothing else fits.
Every shape the JAX package's gate admits (widths and cf of at most 1024)
runs.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from geoa3_tpu_torch.ops.kernels import _build
from geoa3_tpu_torch.ops.kernels.ballquery_group_kernel import _r2, ball_query_plain
from geoa3_tpu_torch.ops.kernels.group_mlp_kernel import (
    _BK,
    _SMEM_MAX,
    _STAGES,
    FoldedMLP,
    _groups_a_tile,
    _pick_bwd,
    _pick_fwd,
    _tile_cols,
)
from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs


def sa_query_group_mlp_plain(xyz, new_xyz, feats, radius, nsample, p: FoldedMLP):
    """Plain PyTorch version of `sa_query_group_mlp`: `ball_query_plain`,
    the projections, `torch.gather`, three matrix products and torch.amax
    (which splits the gradient evenly among tied maxima, as the kernel
    does). Differentiable in xyz, new_xyz and feats by autograd."""
    idx = ball_query_plain(xyz.detach(), new_xyz.detach(), radius, nsample)
    proj = xyz @ p.w1[:3]
    if feats is not None:
        proj = proj + feats @ p.w1[3:]
    yc = new_xyz @ p.w1[:3]
    z1 = (gather_nbrs(proj, idx) - yc[:, :, None, :]) + p.b1
    a = torch.relu(z1)
    a = torch.relu(a @ p.w2 + p.b2)
    a = torch.relu(a @ p.w3 + p.b3)
    return torch.amax(a, dim=2)


def _fwd_smem(widths, rows) -> int:
    """csrc/sa_fused.cu sa_fwd_make's shared memory: a2 and a1 [channel][row],
    the weight ring (16 weight rows a stage, w2's or w3's round, the wider)
    and each row's point."""
    c1, c2, c3 = widths
    stage = _BK * max(_tile_cols(rows, c) for c in (c2, c3))
    return ((c2 + c1) * rows + _STAGES * stage + rows) * 4


@lru_cache(maxsize=64)
def fwd_plan(ns, widths):
    """(tile rows, parts a ball is split into, shared memory) of the
    forward's tiles as its C entry picks them (tile_loop.cuh pick_fwd at one
    level: the largest of 128, 64 and 32 rows that leaves room for two
    blocks an SM, else the largest of 128 .. 16 that fits one); a ball of
    more rows than the tile is split into ceil(ns / rows) parts. Raises
    where nothing fits. The tiles gather projected rows, so cf does not
    enter it (the projections take any cf)."""
    widths = tuple(widths)
    found = _pick_fwd(lambda rows, level, limit: (_fwd_smem(widths, rows),), 1)
    if found is None:
        raise ValueError(
            f"the sa_fused forward's 16-row tiles need "
            f"{_fwd_smem(widths, 16)} bytes of shared memory for widths "
            f"{widths}; a block has {_SMEM_MAX}")
    rows, (smem,) = found
    return rows, (ns + rows - 1) // rows if ns > rows else 1, smem


def _bwd_smem(ns, widths, rows, bk, sparse) -> int:
    """csrc/sa_fused.cu sa_bwd_make's shared memory: region X (a2, then d2,
    and dz3 after them where dz3 @ w3t runs on the ring), a1, the weight
    ring (its widest round, bk weight rows a stage), the hit bits and
    cotangent shares where dz3 is sparse, and each row's point."""
    c1, c2, c3 = widths
    stage = bk * max(_tile_cols(rows, c) for c in (c1, c2, c3))
    top = c2 if sparse else c2 + c3
    words = (top + c1) * rows + _STAGES * stage + rows
    if sparse:
        words += (c3 + 31) // 32 * rows + _groups_a_tile(ns, rows) * c3
    return words * 4


@lru_cache(maxsize=64)
def bwd_plan(ns, widths):
    """(tile rows, parts a ball is split into, weight rows a ring stage,
    whether dz3 is hit bits, shared memory) of the backward as its C entry
    picks them (group_mlp_kernel._pick_bwd: the tallest of 256 .. 16 rows
    that fits one block an SM; hit bits where ns >= 64 or where nothing
    else fits, then 8-row ring stages on 16-row tiles); raises where
    nothing fits."""
    def fit(rows, bk, level):
        sparse = ns >= 64 or level >= 2
        return _bwd_smem(ns, widths, rows, bk, sparse), sparse

    found = _pick_bwd(fit)
    if found is None:
        raise ValueError(
            f"the sa_fused backward's 16-row tile needs "
            f"{_bwd_smem(ns, widths, 16, _BK // 2, True)} bytes of shared "
            f"memory for nsample={ns}, widths {tuple(widths)}; a block has "
            f"{_SMEM_MAX}")
    rows, depth, (smem, sparse) = found
    return rows, (ns + rows - 1) // rows if ns > rows else 1, depth, sparse, smem


def _check(xyz, new_xyz, feats, nsample, p: FoldedMLP):
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    cf = 0 if feats is None else feats.shape[-1]
    c0, c1 = p.w1.shape
    c2, c3 = p.w3.shape
    if c0 != 3 + cf or p.w2.shape != (c1, c2):
        raise ValueError(
            f"sa_fused: weights {tuple(p.w1.shape)}, {tuple(p.w2.shape)}, "
            f"{tuple(p.w3.shape)} do not chain from 3 + cf = {3 + cf} inputs")
    if c1 % 4 or c2 % 4 or c3 % 4:
        raise ValueError(
            f"the sa_fused kernels take widths that are multiples of 4, got "
            f"{(c1, c2, c3)}")
    if n < 1 or nsample < 1:
        raise ValueError(f"sa_fused: needs n >= 1 and nsample >= 1, got "
                         f"n={n}, nsample={nsample}")
    # raise where either pass cannot fit
    fwd_plan(nsample, (c1, c2, c3))
    bwd_plan(nsample, (c1, c2, c3))
    _build.check_cuda(xyz, "xyz", torch.float32, (b, n, 3))
    _build.check_cuda(new_xyz, "new_xyz", torch.float32, (b, m, 3))
    if feats is not None:
        _build.check_cuda(feats, "feats", torch.float32, (b, n, cf))
    c0p = (c0 + 3) // 4 * 4
    shapes = ((c0, c1), (c1,), (c1, c2), (c2,), (c2, c3), (c3,), (c1, c0p),
              (c2, c1), (c3, c2))
    for name, t, shape in zip(FoldedMLP._fields, p, shapes):
        _build.check_cuda(t, name, torch.float32, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"sa_fused: {name} is not 16-byte aligned")
    return b, n, m, cf, c1, c2, c3


def sa_fused_fwd(xyz, new_xyz, feats, radius, nsample, p: FoldedMLP):
    """CUDA kernels: xyz [b, n, 3], new_xyz [b, m, 3], feats [b, n, cf] or
    None -> (pooled [b, m, c3], tie count of each maximum [b, m, c3] int32,
    idx [b, m, ns] int32, P [b, n, c1], Yc [b, m, c1]); the last four are
    what the backward takes."""
    b, n, m, cf, c1, c2, c3 = _check(xyz, new_xyz, feats, nsample, p)
    dev = xyz.device
    proj = torch.empty(b, n, c1, dtype=torch.float32, device=dev)
    yc = torch.empty(b, m, c1, dtype=torch.float32, device=dev)
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=dev)
    pooled = torch.empty(b, m, c3, dtype=torch.float32, device=dev)
    cnt = torch.empty(b, m, c3, dtype=torch.int32, device=dev)
    # a split ball's partial maxima and counts, one pair a part
    parts = fwd_plan(nsample, (c1, c2, c3))[1]
    scratch = (torch.empty(2 * b * m * parts * c3, dtype=torch.int32, device=dev)
               if parts > 1 else None)
    _build.launch("geoa3_sa_fused_fwd", xyz, new_xyz, feats if cf else None,
                  p.w1, p.b1, p.w2, p.b2, p.w3, p.b3, b, n, m, nsample, cf,
                  c1, c2, c3, _r2(radius), proj, yc, idx, pooled, cnt, scratch)
    sa_fused_fwd.launches += 1
    return pooled, cnt, idx, proj, yc


def sa_fused_bwd(g, p: FoldedMLP, cf, pooled, cnt, idx, proj, yc):
    """CUDA kernels: the cotangents of xyz, new_xyz and feats for the
    pooled cotangent g [b, m, c3], from the forward's pooled, cnt, idx, P and
    Yc -> (dxyz [b, n, 3], dnew_xyz [b, m, 3], dfeats [b, n, cf] or None)."""
    b, n, c1 = proj.shape
    m, ns = idx.shape[1:]
    c2, c3 = p.w3.shape
    _build.check_cuda(g, "g", torch.float32, (b, m, c3))
    _build.check_cuda(pooled, "pooled", torch.float32, (b, m, c3))
    _build.check_cuda(cnt, "cnt", torch.int32, (b, m, c3))
    _build.check_cuda(idx, "idx", torch.int32, (b, m, ns))
    _build.check_cuda(yc, "yc", torch.float32, (b, m, c1))
    if p.w1.shape != (3 + cf, c1) or p.w2.shape != (c1, c2):
        raise ValueError("sa_fused_bwd: the weights do not match the forward's")
    dev = proj.device
    dproj = torch.zeros(b, n, c1, dtype=torch.float32, device=dev)
    dyc = torch.empty(b, m, c1, dtype=torch.float32, device=dev)
    dxyz = torch.empty(b, n, 3, dtype=torch.float32, device=dev)
    dnew = torch.empty(b, m, 3, dtype=torch.float32, device=dev)
    dfeats = (torch.empty(b, n, cf, dtype=torch.float32, device=dev)
              if cf else None)
    _build.launch("geoa3_sa_fused_bwd", proj, yc, idx, p.b1, p.w2, p.b2, p.w3,
                  p.b3, p.w1t, p.w2t, p.w3t, pooled, cnt, g, b, n, m, ns, cf,
                  c1, c2, c3, dproj, dyc, dxyz, dnew, dfeats)
    sa_fused_bwd.launches += 1
    return dxyz, dnew, dfeats


class _SAQueryGroupMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, new_xyz, feats, radius, nsample, p):
        pooled, cnt, idx, proj, yc = sa_fused_fwd(xyz, new_xyz, feats, radius,
                                                  nsample, p)
        ctx.save_for_backward(pooled, cnt, idx, proj, yc)
        ctx.p = p
        ctx.cf = 0 if feats is None else feats.shape[-1]
        return pooled

    @staticmethod
    def backward(ctx, g):
        pooled, cnt, idx, proj, yc = ctx.saved_tensors
        dxyz, dnew, dfeats = sa_fused_bwd(g.contiguous(), ctx.p, ctx.cf, pooled,
                                          cnt, idx, proj, yc)
        return dxyz, dnew, dfeats, None, None, None


def sa_query_group_mlp(xyz, new_xyz, feats: Optional[torch.Tensor], radius,
                       nsample, p: FoldedMLP):
    """One set-abstraction scale: xyz [b, n, 3], new_xyz [b, m, 3] centres,
    feats [b, n, cf] or None, p from `fold_mlp` -> pooled [b, m, c3] (the
    relu-MLP of each ball's [x - centre, f] rows, max over the ball).
    Differentiable in xyz, new_xyz and feats. CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    if not xyz.is_cuda:
        return sa_query_group_mlp_plain(xyz, new_xyz, feats, radius, nsample, p)
    return _SAQueryGroupMLP.apply(
        xyz.contiguous(), new_xyz.contiguous(),
        None if feats is None else feats.contiguous(), radius, nsample, p)


sa_fused_fwd.launches = 0
sa_fused_bwd.launches = 0
