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
weight gradients). Every activation is one float32 fmaf chain from 0, k
ascending, then + bias, then the ReLU, in both kernels, so the backward's
recompute equals the forward's bitwise. The forward takes tiles of 128, 64
or 32 rows (transposed in shared memory) on persistent blocks of 256
threads, each thread 8 rows x 8 (or 4) columns, with each layer's weights
streamed through a three-stage cp.async ring in shared memory; the pool
reduces (maximum, tie count) in registers and merges by shuffles. A group
larger than a tile (GroupAll) is split over blocks that write partials to a
scratch, merged by a finishing kernel. The backward takes 64, 32 or 16 rows
through all three layers with weights streamed from L2 and a 4x4 output
tile a thread; it splits each pooled cotangent evenly among the rows the
forward counted as tied.

Limits: the three widths are multiples of 4; cf is any size >= 0; each
kernel's tiles must fit a block's 232,448 bytes of shared memory at their
smallest height: the forward's need is `fwd_smem_bytes` (32 rows), the
backward's (round4(3 + cf) + c1 + 2 c2 + 64 + (c1 if c1 > c2)) * 20 * 4
bytes (16 rows). MSG's GroupAll (cf = 640, widths 256/512/1024) takes
213,504 bytes forward (32 rows) and 159,040 backward (16 rows). The
forward's limit is the narrower: with those widths it takes cf <= 789, the
backward cf <= 1557, so a GroupAll of 790 to 1557 features is refused.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoa3_tpu_torch.ops.kernels import _build

_SMEM_MAX = 232448  # bytes of shared memory one block may use on Hopper
_SMEM_HALF = 113 * 1024  # a block's share where two fit an SM
_FWD_ROWS = (128, 64, 32)  # the forward's tile heights, largest first
_FWD_BK, _FWD_STAGES = 16, 3  # weight rows a ring stage, ring depth


def _fwd_cols(rows: int, cout: int) -> int:
    """Columns one round of a forward layer covers (csrc fwd_cw): 2048/rows
    column groups of 8 columns, or of 4 where 8 would idle threads or cout
    is not a multiple of 8."""
    groups = 2048 // rows
    return groups * (8 if cout % 8 == 0 and cout >= groups * 8 else 4)


def fwd_smem_bytes(cf: int, widths, rows: int = 32) -> int:
    """Shared memory of the forward kernel's block at a tile of `rows` rows
    (csrc/group_mlp.cu fwd_plan): the input / layer-2 buffer and layer 1's,
    [channel][row], and the weight ring. At 32 rows, the smallest tile, it
    is what a shape needs."""
    c1, c2, c3 = widths
    c0p = (3 + cf + 3) // 4 * 4
    stage = _FWD_BK * max(_fwd_cols(rows, c) for c in (c1, c2, c3))
    return ((max(c0p, c2) + c1) * rows + _FWD_STAGES * stage) * 4


def fwd_plan(ns: int, cf: int, widths):
    """(tile rows, parts a group is split into) as the forward's C entry
    picks them: the largest tile whose block leaves room for two an SM,
    else the largest that fits; a group of more rows than the tile is split
    into ceil(ns / rows) parts, one a block."""
    fits = [r for r in _FWD_ROWS if fwd_smem_bytes(cf, widths, r) <= _SMEM_HALF]
    fits = fits or [r for r in _FWD_ROWS
                    if fwd_smem_bytes(cf, widths, r) <= _SMEM_MAX]
    if not fits:
        raise ValueError(
            f"the group_mlp forward's 32-row tile needs "
            f"{fwd_smem_bytes(cf, widths)} bytes of shared memory for "
            f"cf={cf}, widths {tuple(widths)}; a block has {_SMEM_MAX}")
    rows = fits[0]
    return rows, (ns + rows - 1) // rows if ns > rows else 1


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
    fwd_plan(ns, cf, (c1, c2, c3))  # raises where the forward cannot fit
    need = (c0p + c1 + 2 * c2 + 64 + (c1 if c1 > c2 else 0)) * 20 * 4
    if need > _SMEM_MAX:
        raise ValueError(
            f"the group_mlp backward's 16-row tiles need {need} bytes of "
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
    # a split group's partial maxima and counts (parts <= ceil(ns / 32))
    scratch = (torch.empty(2 * groups * -(-ns // 32) * c3, dtype=torch.int32,
                           device=gx.device) if ns > 32 else None)
    _build.launch("geoa3_group_mlp_fwd", gx, gf, p.w1, p.b1, p.w2, p.b2, p.w3,
                  p.b3, groups, ns, cf, c1, c2, c3, pooled, cnt, scratch)
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
