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

Bound on the H100: operations (2 * rows * (c0*c1 + c1*c2 + c2*c3) forward;
backward, the same recompute, plus 2 * c2 for each nonzero entry of dz3 and
2 * (c2*c1 + c1*c0) for each row that carries a cotangent, no weight
gradients). Every activation is one float32 fmaf chain from 0, k
ascending, then + bias, then the ReLU, in both kernels, so the backward's
recompute equals the forward's bitwise. Both kernels run one loop: tiles of
rows transposed in shared memory on persistent blocks of 256 threads, each
thread 8 rows x 8 (or 4) columns, with each layer's weights streamed
through a three-stage cp.async ring in shared memory. The forward takes
tiles of 128, 64, 32 or 16 rows, two blocks an SM where they fit; it is
three layers, its pool reduces (maximum, tie count) in registers and merges
by shuffles, and a group larger than a tile (GroupAll) is split over blocks
that write partials to a scratch, merged by a finishing kernel. The
backward takes the tallest of 256 .. 16 rows that fits one block an SM; it
is six layers: the three recomputes, then dz3 @ w3t, d2 @ w2t and d1 @ w1t,
with dz3 the pooled cotangent split evenly among the rows the forward
counted as tied; a split group needs no merge. Where groups hold 64 rows
or more, dz3 @ w3t runs off the ring, each thread over the columns whose
maximum its 8 rows hold (hit bits); where cf <= 1, so does d1 @ w1t.

Limits: the three widths are multiples of 4; cf is any size >= 0. Layer
1's input sits whole in shared memory where some tile height takes it so;
where none does, it is staged in slices of its channels (csrc/group_mlp.cu),
so cf sets no limit: a shape is refused only for its widths, where even a
16-row tile does not fit a block's 232,448 bytes with the input in the
narrowest slices: the forward needs c1 + max(c2, 16) <= 2096; the backward,
with 8-channel slices, dz3 as hit bits and 8-row ring stages,
64 (max(c2, 8) + c1) + 64 ceil(c3 / 32) + 4 gpt c3 <= 183,296 bytes (gpt = 2
where ns <= 8, else 1). Every shape whose three widths are at most 1024
runs. MSG's GroupAll (cf = 640, widths 256/512/1024) takes 213,504 bytes
forward (32 rows) and 221,696 backward (32 rows), its whole input in shared
memory; from cf = 1838 on the forward, 1742 on the backward, the input is
sliced (32-row tiles at cf = 2048: 784 channels a slice forward, 720
backward).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional

import torch

from geoa3_tpu_torch.ops.kernels import _build

_SMEM_MAX = 232448  # bytes of shared memory one block may use on Hopper
_SMEM_HALF = 113 * 1024  # a block's share where two fit an SM
_TILE_ROWS = (128, 64, 32, 16)  # the forward's tile heights, largest first
_BWD_ROWS = (256,) + _TILE_ROWS  # the backward's
_BK, _STAGES = 16, 3  # weight rows a ring stage, ring depth


def _tile_cols(rows: int, cout: int) -> int:
    """Columns one round of a layer covers (csrc tile_cw): 2048/rows column
    groups of 8 columns where cout is a multiple of 8 wider than a round of
    4, else of 4, and always of 4 at 16 rows."""
    groups = 2048 // rows
    wide = rows > 16 and cout % 8 == 0 and cout > groups * 4
    return groups * (8 if wide else 4)


def _smem_bytes(ns: int, cf: int, widths, rows: int, bwd: bool,
                bk: int = _BK, kin: int = 0, sparse: Optional[bool] = None) -> int:
    """csrc/group_mlp.cu make_plan's shared memory: region X (layer 1's
    input, whole or `kin` channels of it, then layer 2's activations and,
    where the backward's layer 4 runs on the ring, dz3 after them), layer
    1's activations, [channel][row], the weight ring (bk weight rows a stage,
    its widest round), and where layer 4 runs off the ring (`sparse`, by
    default ns >= 64), dz3 as a hit bit a (row, column) and each of the
    tile's groups' cotangent shares."""
    c1, c2, c3 = widths
    c0p = (3 + cf + 3) // 4 * 4
    couts = (c1, c2, c3, c0p) if bwd else (c1, c2, c3)
    stage = bk * max(_tile_cols(rows, c) for c in couts)
    if sparse is None:
        sparse = bwd and ns >= 64
    top = c2 + c3 if bwd and not sparse else c2
    words = (max(kin or c0p, top) + c1) * rows + _STAGES * stage
    if sparse:
        words += (c3 + 31) // 32 * rows + _groups_a_tile(ns, rows) * c3
    return words * 4


def _groups_a_tile(ns: int, rows: int) -> int:
    """Groups a tile of `rows` rows holds: rows / (ns padded to a power of
    two >= 8), or 1 where a group is split over tiles."""
    slot = max(8, 1 << (ns - 1).bit_length())
    return rows // slot if ns <= rows else 1


def fwd_smem_bytes(cf: int, widths, rows: int = 16) -> int:
    """Shared memory of the forward kernel's block at a tile of `rows` rows
    with layer 1's whole input in it."""
    return _smem_bytes(1, cf, widths, rows, False)


def bwd_smem_bytes(ns: int, cf: int, widths, rows: int = 16) -> int:
    """Shared memory of the backward kernel's block for groups of ns rows at
    a tile of `rows` rows with layer 1's whole input in it, with ring stages
    of 32 weight rows where they fit (above 16 rows), else 16."""
    deep = _smem_bytes(ns, cf, widths, rows, True, 2 * _BK)
    if rows > 16 and deep <= _SMEM_MAX:
        return deep
    return _smem_bytes(ns, cf, widths, rows, True)


def _fit(ns, cf, widths, rows, bwd, bk, level, limit):
    """(shared memory, kin) of csrc fit_plan: the plan at a level of
    `pick_bwd`'s: dz3 as hit bits where ns >= 64 or from level 2 on; layer
    1's whole input at level 0 or where it fits `limit`, else its widest
    slices (kin, a multiple of bk channels) that fit."""
    sparse = bwd and (ns >= 64 or level >= 2)
    whole = _smem_bytes(ns, cf, widths, rows, bwd, bk, 0, sparse)
    if level == 0 or whole <= limit:
        return whole, 0
    c1, c2, c3 = widths
    top = c2 + c3 if bwd and not sparse else c2
    rest = whole - max((3 + cf + 3) // 4 * 4, top) * rows * 4
    kin = (limit - rest) // (rows * 4) // bk * bk if rest < limit else 0
    if kin < bk:
        return whole, 0
    return _smem_bytes(ns, cf, widths, rows, bwd, bk, kin, sparse), kin


_LEVELS = 4  # csrc tile_loop.cuh kLevels


def _pick_bwd(fit):
    """csrc tile_loop.cuh pick_bwd: (rows, depth, fit(rows, depth, level))
    of a backward's plan, fit's result led by its shared memory: the tallest
    of 256 .. 16 rows whose plan at 16-row ring stages fits one block an SM,
    at the lowest level that has one, with 32-row stages where that plan
    still fits (above 16 rows, below level 3; level 3: 16-row tiles with
    8-row stages); None where nothing fits."""
    for level in range(_LEVELS):
        bk = _BK // 2 if level == 3 else _BK
        for rows in (_BWD_ROWS[-1:] if level == 3 else _BWD_ROWS):
            got = fit(rows, bk, level)
            if got[0] > _SMEM_MAX:
                continue
            if level < 3 and rows > 16:
                deep = fit(rows, 2 * _BK, level)
                if deep[0] <= _SMEM_MAX:
                    return rows, 2 * _BK, deep
            return rows, bk, got
    return None


def _pick_fwd(fit, levels):
    """csrc tile_loop.cuh pick_fwd: (rows, fit(rows, level, limit)) of a
    forward's plan, fit's result led by its shared memory: the largest of
    128, 64 and 32 rows whose block leaves room for two an SM, else the
    largest of 128 .. 16 that fits one, at the lowest of `levels` levels
    that has one; None where nothing fits."""
    for level in range(levels):
        for limit, heights in ((_SMEM_HALF, _TILE_ROWS[:-1]),
                               (_SMEM_MAX, _TILE_ROWS)):
            for rows in heights:
                got = fit(rows, level, limit)
                if got[0] <= limit:
                    return rows, got
    return None


class TilePlan(NamedTuple):
    """A kernel's plan as its C entry picks it: tile rows, parts a group is
    split into, weight rows a ring stage, layer-1 input channels a slice (0:
    the whole input) and shared memory (bytes)."""

    rows: int
    parts: int
    depth: int
    kin: int
    smem: int


@lru_cache(maxsize=256)
def tile_plan(ns: int, cf: int, widths, bwd: bool) -> TilePlan:
    """The forward's (bwd False) or the backward's plan, as csrc/group_mlp.cu
    fwd_tile_plan / bwd_tile_plan pick it; raises where nothing fits."""
    widths = tuple(widths)
    if not bwd:
        got = _pick_fwd(lambda rows, level, limit: _fit(
            ns, cf, widths, rows, False, _BK, level, limit), 2)
        found = None if got is None else (got[0], _BK, got[1])
    else:
        found = _pick_bwd(lambda rows, bk, level: _fit(
            ns, cf, widths, rows, True, bk, level, _SMEM_MAX))
    if found is None:
        need = (_smem_bytes(ns, cf, widths, 16, True, _BK // 2, _BK // 2, True)
                if bwd else _smem_bytes(ns, cf, widths, 16, False, _BK, _BK))
        raise ValueError(
            f"the group_mlp {'backward' if bwd else 'forward'}'s 16-row tile "
            f"needs {need} bytes of shared memory with layer 1's input in "
            f"the narrowest slices, for widths {widths}; a block has "
            f"{_SMEM_MAX}")
    rows, depth, (smem, kin) = found
    return TilePlan(rows, (ns + rows - 1) // rows if ns > rows else 1, depth,
                    kin, smem)


def fwd_plan(ns: int, cf: int, widths):
    """(tile rows, parts a group is split into) as the forward's C entry
    picks them: the largest tile of 32 rows or more whose block leaves room
    for two an SM, else the largest that fits (16 rows only where 32 do
    not), with layer 1's whole input where some height takes it so, else by
    the same rule in slices; a group of more rows than the tile is split
    into ceil(ns / rows) parts, one a block."""
    return tile_plan(ns, cf, tuple(widths), False)[:2]


def bwd_plan(ns: int, cf: int, widths):
    """(tile rows, parts a group is split into) as the backward's C entry
    picks them: the largest of 256, 128, 64, 32 and 16 rows that fits one
    block an SM (`_pick_bwd`), split as the forward's."""
    return tile_plan(ns, cf, tuple(widths), True)[:2]


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
    # raise where either kernel cannot fit
    fwd_plan(ns, cf, (c1, c2, c3))
    bwd_plan(ns, cf, (c1, c2, c3))
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
    # a split group's partial maxima and counts, one pair a part
    parts = fwd_plan(ns, cf, (c1, c2, c3))[1]
    scratch = (torch.empty(2 * groups * parts * c3, dtype=torch.int32,
                           device=gx.device) if parts > 1 else None)
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
