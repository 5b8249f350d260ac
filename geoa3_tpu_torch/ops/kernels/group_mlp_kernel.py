"""Grouped three-layer MLP with the max over nsample: CUDA kernel wrappers
and their plain version.

Replaces geoa3_tpu/ops/pallas/group_mlp_kernel.py:_fwd_kernel and
:_bwd_kernel (`group_mlp_maxpool`). Source: csrc/group_mlp.cu.

Three folded-BatchNorm affine+ReLU layers run over the grouped rows
[b, m, ns, 3 (+ cf)] and each group's ns rows are max-pooled, without the
activations ever reaching device memory. Layer 1 is
gx @ w1[:3] + gf @ w1[3:] + b1: the coordinate and feature parts are never
concatenated in device memory. The backward recomputes a tile's activations,
splits each pooled cotangent evenly among the rows that tie for the maximum
(under-full balls repeat their first hit, so ties are routine), takes
ReLU'(0) = 0, and returns the cotangents of gx and gf only: the weights are
a frozen victim's.

Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) forward,
twice that backward: the recompute and one dz @ w^T product a layer, no
weight gradients). A block takes 64, 32 or 16 rows through all
three layers in float32 with activations transposed in shared memory and
weights streamed from L2; every thread holds a 4x4 output tile; layer 3 is
made 64 columns at a time and pooled at once. A block owns whole groups, so
the forward needs no atomics and also leaves every maximum's tie count.

Limits: the three widths are multiples of 4; cf is any size >= 0; the
tiles must fit a block's shared memory at 16 rows, the smallest the kernels
take (16-row tiles are taken only where 32 do not fit):
(round4(3 + cf) + c1 + 2 c2 + 64 + (c1 if c1 > c2)) * 20 * 4 <= 232448 bytes
for the backward, ((max(3 + cf, c2) + c1) * 20 + 16 * 65) * 4 for the
forward. MSG's GroupAll (cf = 640, widths 256/512/1024) takes 16 rows
backward (159,040 bytes; 286,272 at 32) and 32 forward.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoa3_tpu_torch.ops.kernels import _build

_SMEM_MAX = 232448  # bytes of shared memory one block may use on Hopper


class FoldedMLP(NamedTuple):
    """A frozen three-layer MLP with BatchNorm folded in: w_i [c_{i-1}, c_i]
    row-major, b_i [c_i], and the transposed copies the backward streams
    (w1t's 3 + cf columns zero-padded to a multiple of 4)."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    w1t: torch.Tensor
    w2t: torch.Tensor
    w3t: torch.Tensor


def fold_mlp(w1, b1, w2, b2, w3, b3) -> FoldedMLP:
    """Make the contiguous float32 tensors the kernels take, with the
    backward's transposed copies."""
    ws = [t.detach().to(torch.float32).contiguous()
          for t in (w1, b1, w2, b2, w3, b3)]
    c0, c1 = ws[0].shape
    w1t = ws[0].new_zeros(c1, (c0 + 3) // 4 * 4)
    w1t[:, :c0] = ws[0].t()
    return FoldedMLP(*ws, w1t, ws[2].t().contiguous(), ws[4].t().contiguous())


def group_mlp_maxpool_plain(gx, gf, p: FoldedMLP):
    """Plain PyTorch version of `group_mlp_maxpool`: three matrix products
    and torch.amax, which splits the gradient evenly among tied maxima as
    the kernel does. Differentiable in gx and gf."""
    z = gx @ p.w1[:3] + p.b1
    if gf is not None:
        z = z + gf @ p.w1[3:]
    a = torch.relu(z)
    a = torch.relu(a @ p.w2 + p.b2)
    a = torch.relu(a @ p.w3 + p.b3)
    return torch.amax(a, dim=2)


def _check(gx, gf, p: FoldedMLP):
    b, m, ns, _ = gx.shape
    cf = 0 if gf is None else gf.shape[-1]
    c0, c1 = p.w1.shape
    c2, c3 = p.w3.shape
    if c0 != 3 + cf or p.w2.shape != (c1, c2):
        raise ValueError(
            f"group_mlp: weights {tuple(p.w1.shape)}, {tuple(p.w2.shape)}, "
            f"{tuple(p.w3.shape)} do not chain from 3 + cf = {3 + cf} inputs")
    if c1 % 4 or c2 % 4 or c3 % 4:
        raise ValueError(
            f"the group_mlp kernel takes widths that are multiples of 4, got "
            f"{(c1, c2, c3)}")
    c0p = (c0 + 3) // 4 * 4
    need = max((c0p + c1 + 2 * c2 + 64 + (c1 if c1 > c2 else 0)) * 20 * 4,
               ((max(c0, c2) + c1) * 20 + 16 * 65) * 4)
    if need > _SMEM_MAX:
        raise ValueError(
            f"the group_mlp kernels' 16-row tiles need {need} bytes of "
            f"shared memory for cf={cf}, widths {(c1, c2, c3)}; a block has "
            f"{_SMEM_MAX}")
    _build.check_cuda(gx, "gx", torch.float32, (b, m, ns, 3))
    if gf is not None:
        _build.check_cuda(gf, "gf", torch.float32, (b, m, ns, cf))
    shapes = ((c0, c1), (c1,), (c1, c2), (c2,), (c2, c3), (c3,), (c1, c0p),
              (c2, c1), (c3, c2))
    for name, t, shape in zip(FoldedMLP._fields, p, shapes):
        _build.check_cuda(t, name, torch.float32, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"group_mlp: {name} is not 16-byte aligned")
    return b * m, ns, cf, c1, c2, c3


def group_mlp_fwd(gx, gf, p: FoldedMLP):
    """CUDA kernel: gx [b, m, ns, 3], gf [b, m, ns, cf] or None -> (pooled
    [b, m, c3], tie count of each maximum [b, m, c3] int32)."""
    groups, ns, cf, c1, c2, c3 = _check(gx, gf, p)
    b, m = gx.shape[:2]
    pooled = torch.empty(b, m, c3, dtype=torch.float32, device=gx.device)
    cnt = torch.empty(b, m, c3, dtype=torch.int32, device=gx.device)
    _build.launch("geoa3_group_mlp_fwd", gx, gf, p.w1, p.b1, p.w2, p.b2, p.w3,
                  p.b3, groups, ns, cf, c1, c2, c3, pooled, cnt)
    group_mlp_fwd.launches += 1
    return pooled, cnt


def group_mlp_bwd(g, gx, gf, p: FoldedMLP, pooled, cnt):
    """CUDA kernel: the cotangents of gx and gf for the pooled cotangent g
    [b, m, c3] -> (dgx [b, m, ns, 3], dgf [b, m, ns, cf] or None)."""
    groups, ns, cf, c1, c2, c3 = _check(gx, gf, p)
    b, m = gx.shape[:2]
    _build.check_cuda(g, "g", torch.float32, (b, m, c3))
    _build.check_cuda(pooled, "pooled", torch.float32, (b, m, c3))
    _build.check_cuda(cnt, "cnt", torch.int32, (b, m, c3))
    dgx = torch.empty_like(gx)
    dgf = torch.empty_like(gf) if gf is not None else None
    _build.launch("geoa3_group_mlp_bwd", gx, gf, p.w1, p.b1, p.w2, p.b2, p.w3,
                  p.b3, p.w1t, p.w2t, p.w3t, pooled, cnt, g, groups, ns, cf,
                  c1, c2, c3, dgx, dgf)
    group_mlp_bwd.launches += 1
    return dgx, dgf


class _GroupMLPMaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gx, gf, p):
        pooled, cnt = group_mlp_fwd(gx, gf, p)
        ctx.save_for_backward(gx, gf, pooled, cnt)
        ctx.p = p
        return pooled

    @staticmethod
    def backward(ctx, g):
        gx, gf, pooled, cnt = ctx.saved_tensors
        dgx, dgf = group_mlp_bwd(g.contiguous(), gx, gf, ctx.p, pooled, cnt)
        return dgx, dgf, None


def group_mlp_maxpool(gx, gf: Optional[torch.Tensor], p: FoldedMLP):
    """relu-MLP over grouped rows, max over nsample: gx [b, m, ns, 3] centred
    coordinates, gf [b, m, ns, cf] features or None, p from `fold_mlp` ->
    [b, m, c3]. Differentiable in gx and gf only. CPU tensors take the plain
    version; CUDA tensors launch the kernels."""
    if not gx.is_cuda:
        return group_mlp_maxpool_plain(gx, gf, p)
    return _GroupMLPMaxPool.apply(
        gx.contiguous(), None if gf is None else gf.contiguous(), p)


group_mlp_fwd.launches = 0
group_mlp_bwd.launches = 0
