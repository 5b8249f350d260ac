"""Ball query fused with the centred grouping: CUDA kernel wrappers and their
plain versions.

Replaces geoa3_tpu/ops/pallas/ballquery_group_kernel.py:_fwd_kernel and
:_bwd_kernel (`ball_query_group_planes`). Source: csrc/ballquery_group.cu.

For centres [b, m, 3] in xyz [b, n, 3]: slot s of a centre holds the
(s+1)-th point in index order with d^2 < r^2, an under-full ball repeats its
first hit, an empty ball holds index 0 (reference ball_query_gpu.cu:9-54).
d^2 is `pairwise_sqdist`'s expansion rounded step by step, so a centre that
is a member of xyz hits itself at exactly 0 and kernel and plain version
select bitwise the same points. The grouped coordinates are [b, m, ns, 3]
(the TPU's 8-row planes are a layout of that machine).

Bound on the H100: bytes (the gathered feature rows written once are the
largest term). Forward: a block of 8 warps stages its cloud in shared memory
as float4 (x, y, z, |x|^2) where it fits (every engine path's n <= 2048; past
that the walk reads device memory), and one warp a centre walks it 128
points a round, ballots the hits and places each by the popcount of the
hits before it; gf is copied by float4s. Backward: one launch (after the
outputs' memsets), one warp a centre: dcentre = -sum_s dgx by a fixed-order
shuffle tree, and the scatter over the saved indices, a ball's first hit
and its padding repeats summed in registers and sent as one row, feature
rows by float4 atomics.

Limit: nsample <= 1536 (a block keeps 8 index rows in 48 KB of shared
memory).
"""

from __future__ import annotations

import numpy as np
import torch

from geoa3_tpu_torch.ops.distance import pairwise_sqdist
from geoa3_tpu_torch.ops.kernels import _build
from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs
from geoa3_tpu_torch.ops.kernels.scatter_kernel import scatter_add_rows_plain

MAX_NSAMPLE = 1536


def _r2(radius: float) -> float:
    """r^2 as the float32 both versions compare against."""
    return float(np.float32(radius * radius))


def ball_query_plain(xyz, centres, radius, nsample):
    """Plain PyTorch version of the index search -> idx [b, m, nsample]
    int32: the nsample smallest of where(hit, index, n), padded with the
    first (geoa3_tpu/ops/ball_query.py)."""
    return first_hits(pairwise_sqdist(centres, xyz) < _r2(radius), nsample)


def first_hits(hit, nsample):
    """hit [b, m, n] bool -> idx [b, m, nsample] int32: the nsample smallest
    of where(hit, index, n), padded with the first hit; a centre without a
    hit gets index 0 in every slot."""
    n = hit.shape[-1]
    key = torch.where(hit, torch.arange(n, device=hit.device), n)
    k_eff = min(nsample, n)
    idx = torch.topk(key, k_eff, dim=-1, largest=False, sorted=True).values
    if k_eff < nsample:
        idx = torch.cat(
            [idx, idx[..., :1].expand(-1, -1, nsample - k_eff)], dim=-1)
    idx = torch.where(idx >= n, idx[..., :1], idx)  # pad with the first hit
    idx = torch.where(idx >= n, 0, idx)  # empty ball
    return idx.to(torch.int32)


def ballquery_group_plain(xyz, centres, feats, radius, nsample):
    """Plain PyTorch version of `ball_query_group` -> (idx, gx, gf),
    differentiable in xyz, centres and feats through torch.gather."""
    idx = ball_query_plain(xyz.detach(), centres.detach(), radius, nsample)
    gx = gather_nbrs(xyz, idx) - centres[:, :, None, :]
    gf = gather_nbrs(feats, idx) if feats is not None else None
    return idx, gx, gf


def ballquery_group_bwd_plain(idx, dgx, dgf, n):
    """Plain PyTorch version of `ballquery_group_bwd`."""
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns)
    dxyz = scatter_add_rows_plain(flat, dgx.reshape(b, m * ns, 3), n)
    dcentre = -dgx.sum(dim=2)
    dfeats = None
    if dgf is not None:
        dfeats = scatter_add_rows_plain(flat, dgf.reshape(b, m * ns, -1), n)
    return dxyz, dcentre, dfeats


def ballquery_group_fwd(xyz, centres, feats, radius, nsample, gather=True):
    """CUDA kernel: xyz [b, n, 3], centres [b, m, 3], feats [b, n, cf] or
    None -> (idx [b, m, ns] int32, gx [b, m, ns, 3] = xyz[idx] - centre,
    gf [b, m, ns, cf] = feats[idx] or None). With gather=False the copies are
    compiled out and only idx is made: (idx, None, None)."""
    b, n, _ = xyz.shape
    m = centres.shape[1]
    if not 1 <= nsample <= MAX_NSAMPLE:
        raise ValueError(
            f"the ball query kernel takes 1 <= nsample <= {MAX_NSAMPLE}, "
            f"got {nsample}")
    _build.check_cuda(xyz, "xyz", torch.float32, (b, n, 3))
    _build.check_cuda(centres, "centres", torch.float32, (b, m, 3))
    dev = xyz.device
    idx = torch.empty(b, m, nsample, dtype=torch.int32, device=dev)
    if not gather:
        _build.launch("geoa3_ball_query", xyz, centres, b, n, m, nsample,
                      _r2(radius), idx)
        ballquery_group_fwd.launches += 1
        return idx, None, None
    cf = 0 if feats is None else feats.shape[-1]
    if feats is not None:
        _build.check_cuda(feats, "feats", torch.float32, (b, n, cf))
    gx = torch.empty(b, m, nsample, 3, dtype=torch.float32, device=dev)
    gf = (torch.empty(b, m, nsample, cf, dtype=torch.float32, device=dev)
          if cf else None)
    _build.launch("geoa3_ballquery_group_fwd", xyz, centres,
                  feats if cf else None, b, n, m, nsample, cf, _r2(radius),
                  idx, gx, gf)
    ballquery_group_fwd.launches += 1
    return idx, gx, gf


def ballquery_group_bwd(idx, dgx, dgf, n):
    """CUDA kernel: idx [b, m, ns], cotangents dgx [b, m, ns, 3] and dgf
    [b, m, ns, cf] or None -> (dxyz [b, n, 3], dcentre [b, m, 3], dfeats
    [b, n, cf] or None): dgx and dgf scattered over idx, and
    dcentre = -sum_s dgx."""
    b, m, ns = idx.shape
    _build.check_cuda(idx, "idx", torch.int32, (b, m, ns))
    _build.check_cuda(dgx, "dgx", torch.float32, (b, m, ns, 3))
    cf = 0 if dgf is None else dgf.shape[-1]
    if cf:
        _build.check_cuda(dgf, "dgf", torch.float32, (b, m, ns, cf))
    dev = idx.device
    # the C entry zeroes dxyz and dfeats
    dxyz = torch.empty(b, n, 3, dtype=torch.float32, device=dev)
    dcentre = torch.empty(b, m, 3, dtype=torch.float32, device=dev)
    dfeats = (torch.empty(b, n, cf, dtype=torch.float32, device=dev)
              if cf else None)
    _build.launch("geoa3_ballquery_group_bwd", idx, dgx, dgf if cf else None,
                  b, n, m, ns, cf, dxyz, dcentre, dfeats)
    ballquery_group_bwd.launches += 1
    return dxyz, dcentre, dfeats


class _BallQueryGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xyz, centres, feats, radius, nsample):
        idx, gx, gf = ballquery_group_fwd(
            xyz.contiguous(), centres.contiguous(),
            None if feats is None else feats.contiguous(), radius, nsample)
        ctx.save_for_backward(idx)
        ctx.n = xyz.shape[1]
        ctx.has_feats = feats is not None
        ctx.mark_non_differentiable(idx)
        if gf is None:
            return idx, gx
        return idx, gx, gf

    @staticmethod
    def backward(ctx, _didx, dgx, dgf=None):
        (idx,) = ctx.saved_tensors
        if dgx is None:  # only the grouped features were used
            dgx = dgf.new_zeros(*idx.shape, 3)
        dxyz, dcentre, dfeats = ballquery_group_bwd(
            idx, dgx.contiguous(),
            dgf.contiguous() if ctx.has_feats and dgf is not None else None,
            ctx.n)
        return dxyz, dcentre, dfeats, None, None


def ball_query_group(xyz, centres, feats, radius, nsample):
    """Ball query, centred coordinate gather and feature gather in one:
    xyz [b, n, 3], centres [b, m, 3], feats [b, n, cf] or None ->
    (idx [b, m, ns] int32, gx [b, m, ns, 3], gf [b, m, ns, cf] or None).
    Differentiable in xyz, centres and feats (the indices carry no gradient).
    CPU tensors take the plain version; CUDA tensors launch the kernels."""
    if not xyz.is_cuda:
        return ballquery_group_plain(xyz, centres, feats, radius, nsample)
    out = _BallQueryGroup.apply(xyz, centres, feats, radius, nsample)
    return out if len(out) == 3 else (out[0], out[1], None)


def ball_query(xyz, centres, radius, nsample):
    """Index output only: xyz [b, n, 3], centres [b, m, 3] -> idx
    [b, m, ns] int32. Not differentiable. CPU tensors take the plain
    version; CUDA tensors launch the kernel with the gathers compiled out."""
    xyz, centres = xyz.detach(), centres.detach()
    if not xyz.is_cuda:
        return ball_query_plain(xyz, centres, radius, nsample)
    return ballquery_group_fwd(xyz.contiguous(), centres.contiguous(), None,
                               radius, nsample, gather=False)[0]


ballquery_group_fwd.launches = 0
ballquery_group_bwd.launches = 0
