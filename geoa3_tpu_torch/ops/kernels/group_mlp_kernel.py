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

A bf16 victim (`--victim_dtype bfloat16`) runs the TPU kernel's single-pass
mode (`f32_exact=False`) instead, wherever the JAX package's gate
(`group_mlp_available`, ported below, since whether JAX fuses decides the
numbers) admits the shape: `group_mlp_fwd_bf16` / `group_mlp_bwd_bf16`
(csrc/group_mlp_bf16.cu, on the tensor cores). Every product's operands are
bf16 (the bf16 inputs and weights, a1 and a2 rounded after their ReLU), the
products exact and the sums float32; layer 1 is (gx @ w1[:3] + gf @ w1[3:])
+ b1. The maxima are float32; the model takes them rounded to bf16. The
backward splits g evenly among the tied rows and rounds each layer's
cotangent to bf16 before its product (g / cnt, then d2 and d1 after their
ReLU masks); dgx and dgf come back float32 and the model takes them rounded
to bf16. Bound: operations at 989 TFLOP/s of bf16.
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


class Bf16Plan(NamedTuple):
    """A bf16 kernel's plan as its C entry picks it: tile rows, parts a
    group is split into, the weights' stages (0 for the resident kernels,
    the ring's 32 KB stages for the streamed ones, 32 k rows a stage for
    the staged ones), shared memory (bytes) and the kernel: "resident",
    "wgmma" (streamed) or "tiles" (staged)."""

    rows: int
    parts: int
    depth: int
    smem: int
    kind: str


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


# ------------------------------------------------ the single-pass bf16 mode

# csrc/group_mlp_bf16.cu: k rows of a weight stage, output columns a pass,
# tile heights largest first
_BF16_KS, _BF16_NCH = 32, 128
_BF16_ROWS = (128, 64, 32, 16)
# its streamed kernels: a tile's rows, a ring stage's bytes, the mbarriers,
# the passes a plan may hold
_W_ROWS, _W_STAGE, _W_BARS, _W_MAX_PASSES = 64, 32768, 128, 48


def _pad16(c: int) -> int:
    return (c + 15) // 16 * 16


def _pad128(c: int) -> int:
    return (c + 127) // 128 * 128


class WPass(NamedTuple):
    """A pass of the streamed kernels: output columns [n0, n0 + nb) of a
    product over k rows of `src` (a weight of `FoldedMLPBf16`), its weights
    streamed as slabs of ks rows."""

    src: str
    n0: int
    nb: int
    k: int
    ks: int


def _w_passes(src: str, n: int, k: int) -> list:
    """Passes over n output columns, 256 or 128 wide, largest first, in
    slabs of 32 KB (csrc/group_mlp_bf16.cu `add_passes`)."""
    out, n0 = [], 0
    while n0 < n:
        nb = 256 if n - n0 >= 256 else 128
        out.append(WPass(src, n0, nb, k, 16384 // nb))
        n0 += nb
    return out


def bf16_wgmma_passes(cf: int, widths, bwd: bool):
    """The streamed kernels' passes in the order a block runs them
    (csrc/group_mlp_bf16.cu `wgmma_plan`): (those read from the forward's
    stream: layers 1, 2 and 3; those from the backward's: W2^T, then W1^T,
    after dz2 = dz3 W3^T by dz3's hits), or None where the backward's dz2
    (its columns padded to 128) is wider than 512 or dz3 than 1024."""
    c1q, c2q, c3q = (_pad128(c) for c in widths)
    k1 = 16 + cf
    if bwd and (c2q > 512 or c3q > 1024):
        return None
    pf = (_w_passes("kw1", c1q, k1) + _w_passes("kw2", c2q, c1q)
          + _w_passes("kw3", c3q, c2q))
    if not bwd:
        return pf, []
    return pf, _w_passes("kw2t", c1q, c2q) + _w_passes("kw1t", _pad128(k1), c1q)


def _pack_passes(p, passes) -> torch.Tensor:
    """The passes' weights as the streamed kernels read them, one after
    another: each pass's first k rows (zero past the weight and up to a
    multiple of ks) and columns n0 .. n0 + nb (zero past the weight), in
    wgmma's K-major no-swizzle layout [k / 8][nb][8] (bf16)."""
    out = []
    for ps in passes:
        m = getattr(p, ps.src)
        kp = -(-ps.k // ps.ks) * ps.ks
        block = m.new_zeros(kp, ps.nb)
        rr = min(m.shape[0], ps.k)
        cc = max(0, min(m.shape[1] - ps.n0, ps.nb))
        block[:rr, :cc] = m[:rr, ps.n0:ps.n0 + cc]
        out.append(block.view(kp // 8, 8, ps.nb).transpose(1, 2).reshape(-1))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.bfloat16)


class FoldedMLPBf16(NamedTuple):
    """A bf16 victim's frozen three-layer MLP with BatchNorm folded in: the
    plain version's w_i [c_{i-1}, c_i] and b_i [c_i] (bf16, as the fold made
    them), and the kernels' copies: kw1 [16 + cf, c1p] (rows 0-2 the
    coordinates', 3-15 zero, then the features'), kw2 [c1p, c2p], kw3
    [c2p, c3p] in bf16 with every width zero-padded to a multiple of 16,
    their transposes kw1t, kw2t, kw3t for the backward, kb_i [c_ip]
    float32 (bf16 values, zero-padded), and the streamed kernels' weights
    packed in the order they read them (`bf16_wgmma_passes`): kpf the
    forward's (whose first passes the backward reads too), kpb the rest of
    the backward's (empty where it has none). Every MLP is packed: the fold
    does not know ns, which with the widths decides whether a call's plan
    is the streamed one (`bf16_plan`), and the packed copies of the
    victims' SA1 and SA2 MLPs, which the resident kernels serve, take a few
    hundred KB."""

    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    w3: torch.Tensor
    b3: torch.Tensor
    kw1: torch.Tensor
    kb1: torch.Tensor
    kw2: torch.Tensor
    kb2: torch.Tensor
    kw3: torch.Tensor
    kb3: torch.Tensor
    kw1t: torch.Tensor
    kw2t: torch.Tensor
    kw3t: torch.Tensor
    kpf: torch.Tensor
    kpb: torch.Tensor


def fold_mlp_bf16(w1, b1, w2, b2, w3, b3) -> FoldedMLPBf16:
    """The bf16 tensors both versions take, from a bf16 fold: w_i [c_{i-1},
    c_i], b_i [c_i]."""
    ws = [t.detach().to(torch.bfloat16).contiguous() for t in (w1, b1, w2, b2, w3, b3)]
    c0, c1 = ws[0].shape
    c2, c3 = ws[4].shape
    c1p, c2p, c3p = _pad16(c1), _pad16(c2), _pad16(c3)
    kw1 = ws[0].new_zeros(16 + c0 - 3, c1p)
    kw1[:3, :c1] = ws[0][:3]
    kw1[16:, :c1] = ws[0][3:]
    kw2 = ws[2].new_zeros(c1p, c2p)
    kw2[:c1, :c2] = ws[2]
    kw3 = ws[4].new_zeros(c2p, c3p)
    kw3[:c2, :c3] = ws[4]

    def bias(b, cp):
        out = b.new_zeros(cp, dtype=torch.float32)
        out[:b.shape[0]] = b.float()
        return out

    p = FoldedMLPBf16(*ws, kw1, bias(ws[1], c1p), kw2, bias(ws[3], c2p), kw3,
                      bias(ws[5], c3p), kw1.t().contiguous(), kw2.t().contiguous(),
                      kw3.t().contiguous(), None, None)
    pf, _ = bf16_wgmma_passes(c0 - 3, (c1, c2, c3), False)
    bwd = bf16_wgmma_passes(c0 - 3, (c1, c2, c3), True)
    return p._replace(kpf=_pack_passes(p, pf).to(kw1.device),
                      kpb=_pack_passes(p, bwd[1] if bwd else []).to(kw1.device))


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bf16 (to nearest even), held as float32."""
    return t.to(torch.bfloat16).float()


def mlp_bf16_plain(gx, gf, p: FoldedMLPBf16):
    """z1, z2, z3 of the single-pass mode, as the TPU kernel's
    `_tile_forward` computes them: bf16 operands, exact products, float32
    sums, layer 1 (x part + feature part) + b1, each layer's ReLU output
    rounded to bf16 before the next product."""
    z1 = _bf16(gx) @ p.w1[:3].float()
    if gf is not None:
        z1 = z1 + _bf16(gf) @ p.w1[3:].float()
    z1 = z1 + p.b1.float()
    z2 = _bf16(torch.relu(z1)) @ p.w2.float() + p.b2.float()
    z3 = _bf16(torch.relu(z2)) @ p.w3.float() + p.b3.float()
    return z1, z2, z3


def group_mlp_fwd_bf16_plain(gx, gf, p: FoldedMLPBf16):
    """Plain PyTorch version of `group_mlp_fwd_bf16`: (pooled [b, m, c3]
    float32, the tie count of each maximum [b, m, c3] int32)."""
    a3 = torch.relu(mlp_bf16_plain(gx, gf, p)[2])
    pooled = a3.amax(dim=2)
    return pooled, (a3 == pooled[:, :, None]).sum(dim=2, dtype=torch.int32)


def group_mlp_bwd_bf16_plain(g, gx, gf, p: FoldedMLPBf16, pooled, cnt):
    """Plain PyTorch version of `group_mlp_bwd_bf16`: (dgx, dgf or None),
    float32, for the pooled cotangent g [b, m, c3] float32, as the TPU
    kernel's `_bwd_kernel` takes them in the single-pass mode: dz3 = g /
    cnt on the rows tied at the maximum where z3 > 0, each layer's
    cotangent rounded to bf16 before its product with the bf16 weights."""
    z1, z2, z3 = mlp_bf16_plain(gx, gf, p)
    eq = (torch.relu(z3) == pooled[:, :, None]) & (z3 > 0)
    dz = _bf16(torch.where(eq, (g / cnt)[:, :, None], 0.0))
    dz = _bf16(torch.where(z2 > 0, dz @ p.w3.float().T, 0.0))
    dz = _bf16(torch.where(z1 > 0, dz @ p.w2.float().T, 0.0))
    w1 = p.w1.float()
    dgf = dz @ w1[3:].T if gf is not None else None
    return dz @ w1[:3].T, dgf


def _check_bf16(gx, gf, p: FoldedMLPBf16):
    b, m, ns, _ = gx.shape
    cf = 0 if gf is None else gf.shape[-1]
    c0, c1 = p.w1.shape
    c2, c3 = p.w3.shape
    if c0 != 3 + cf or p.w2.shape != (c1, c2):
        raise ValueError(
            f"group_mlp_bf16: weights {tuple(p.w1.shape)}, {tuple(p.w2.shape)}, "
            f"{tuple(p.w3.shape)} do not chain from 3 + cf = {3 + cf} inputs")
    if cf % 16:
        raise ValueError(f"the bf16 group_mlp kernel copies features in 16-byte "
                         f"pieces and takes cf % 16 == 0, got cf={cf}")
    bf16_plan(ns, cf, (c1, c2, c3), False)  # raise where a kernel cannot fit
    bf16_plan(ns, cf, (c1, c2, c3), True)
    _build.check_cuda(gx, "gx", torch.bfloat16, (b, m, ns, 3))
    if gf is not None:
        _build.check_cuda(gf, "gf", torch.bfloat16, (b, m, ns, cf))
        if gf.data_ptr() % 16:
            raise ValueError("group_mlp_bf16: gf is not 16-byte aligned")
    c1p, c2p, c3p = _pad16(c1), _pad16(c2), _pad16(c3)
    shapes = {"kw1": (16 + cf, c1p), "kb1": (c1p,), "kw2": (c1p, c2p), "kb2": (c2p,),
              "kw3": (c2p, c3p), "kb3": (c3p,), "kw1t": (c1p, 16 + cf),
              "kw2t": (c2p, c1p), "kw3t": (c3p, c2p)}
    pf, pb = bf16_wgmma_passes(cf, (c1, c2, c3), False)[0], (
        bf16_wgmma_passes(cf, (c1, c2, c3), True) or ((), ()))[1]
    shapes["kpf"] = (sum(-(-ps.k // ps.ks) * ps.ks * ps.nb for ps in pf),)
    shapes["kpb"] = (sum(-(-ps.k // ps.ks) * ps.ks * ps.nb for ps in pb),)
    for name, shape in shapes.items():
        t = getattr(p, name)
        _build.check_cuda(t, name, torch.float32 if name.startswith("kb")
                          else torch.bfloat16, shape)
        if t.data_ptr() % 16:
            raise ValueError(f"group_mlp_bf16: {name} is not 16-byte aligned")
    return b * m, ns, cf, c1, c2, c3


def bf16_smem_bytes(widths, rows: int, bwd: bool) -> int:
    """Shared memory of a bf16 kernel's block at tiles of `rows` rows
    (csrc/group_mlp_bf16.cu `fwd_smem` / `bwd_smem`): a1 and a2 (and in
    the backward dz3) as bf16 rows of the padded width + 8, the forward's
    float32 rows of a pass's output for the pool, and two stages of layer
    1's streamed input ([rows][32 + 8] bf16) and of the weights ([32][128 +
    8] bf16)."""
    c1p, c2p, c3p = (_pad16(c) for c in widths)
    stages = 2 * (rows * (_BF16_KS + 8) * 2 + _BF16_KS * (_BF16_NCH + 8) * 2)
    if bwd:
        return rows * (c1p + c2p + c3p + 24) * 2 + stages
    return rows * (c1p + c2p + 16) * 2 + rows * (_BF16_NCH + 4) * 4 + stages


def bf16_resident_bytes(ns: int, cf: int, widths, rows: int) -> int:
    """Shared memory of the backward with resident weights at tiles of
    `rows` rows (csrc/group_mlp_bf16.cu `res_layout`), each region rounded
    up to 16 bytes: W1, W2, W3 as bf16 rows of the padded width + 8, the
    float32 biases, a1 and a2 (bf16 rows of the padded width + 8), U (the
    larger of layer 1's input [rows][16 + cf + 8] and dz3 [rows][c3p + 8],
    grown where dgf's and dgx's float32 rows, [rows][cf + 8] and [rows][3],
    staged over a2 and U, need more), the landing buffer (gx's and gf's
    rows, then pooled, the cotangent and cnt of the tile's groups) and two
    mbarriers."""
    c1p, c2p, c3p = (_pad16(c) for c in widths)
    k1, gpt = 16 + cf, 1 if ns > rows else rows // ns
    a2 = rows * (c2p + 8) * 2
    u = max(rows * (k1 + 8) * 2, rows * (c3p + 8) * 2,
            rows * 12 + (rows * (cf + 8) * 4 if cf else 0) - a2)
    gd = _pad16(gpt * widths[2] * 4)
    regions = (k1 * (c1p + 8) * 2, c1p * (c2p + 8) * 2, c2p * (c3p + 8) * 2,
               (c1p + c2p + c3p) * 4, rows * (c1p + 8) * 2, a2, u,
               rows * 6 + rows * cf * 2 + 3 * gd, 16)
    return sum(_pad16(b) for b in regions)


def bf16_resident_fwd_bytes(ns: int, cf: int, widths, rows: int) -> int:
    """Shared memory of the forward with resident weights at tiles of
    `rows` rows (csrc/group_mlp_bf16.cu `res_layout`), each region rounded
    up to 16 bytes: W1, W2, W3 and the biases as the backward holds them,
    a1 (grown where the pool's partials, laid over it, need more: [rows /
    16][c3p + 4] float32 maxima and int32 counts where groups lie on m16
    tiles or are split, else [rows][c3p + 4] float32 row values), a2,
    layer 1's input [rows][16 + cf + 8] (bf16), the landing buffer (gx's and
    gf's rows) and two mbarriers."""
    c1p, c2p, c3p = (_pad16(c) for c in widths)
    k1, lp = 16 + cf, c3p + 4
    pool = rows // 16 * lp * 8 if ns > rows or ns % 16 == 0 else rows * lp * 4
    regions = (k1 * (c1p + 8) * 2, c1p * (c2p + 8) * 2, c2p * (c3p + 8) * 2,
               (c1p + c2p + c3p) * 4, max(rows * (c1p + 8) * 2, pool),
               rows * (c2p + 8) * 2, rows * (k1 + 8) * 2, rows * 6 + rows * cf * 2, 16)
    return sum(_pad16(b) for b in regions)


def bf16_wgmma_plan(ns: int, cf: int, widths, bwd: bool) -> Optional[Bf16Plan]:
    """The streamed kernel's plan (csrc/group_mlp_bf16.cu `wgmma_plan`), or
    None where it does not fit: 64-row tiles (a group of more rows split
    into ceil(ns / 64) parts, whose maxima the forward merges in a finishing
    kernel), the ring's stages (depth: 4, 3 or 2 of 32 KB, the most that
    fit) and the shared memory: the ring and its mbarriers, a1 and a2 (bf16
    rows of the width padded to 128, + 8), then the forward's pool partials
    (two warpgroups' [4][lp] maxima and counts, lp half the widest layer-3
    pass) or the backward's dz3 hit bits ([64][c3 padded to 128] bits) and
    its tile's groups' maxima and g / cnt ([groups a tile][c3 padded to
    128] float32 each);
    layer 1's input ([64][cf] bf16) lands over a2 and what follows, which
    grow where it needs more; the biases (float32, the padded widths) after
    the mbarriers. Past 48 passes, none."""
    passes = bf16_wgmma_passes(cf, widths, bwd)
    if passes is None or len(passes[0]) + len(passes[1]) > _W_MAX_PASSES:
        return None
    c1q, c2q, c3q = (_pad128(c) for c in widths)
    gpt = 1 if ns > _W_ROWS else _W_ROWS // _pad16(ns)
    if bwd:
        aux = _W_ROWS * c3q // 8 + 2 * gpt * c3q * 4
    else:
        lp = max(ps.nb // 2 for ps in passes[0] if ps.src == "kw3")
        aux = 2 * 4 * lp * 8
    rest = (_W_BARS + (c1q + c2q + c3q) * 4 + _W_ROWS * (c1q + 8) * 2
            + max(_W_ROWS * (c2q + 8) * 2 + aux, _W_ROWS * cf * 2))
    for stages in (4, 3, 2):
        if stages * _W_STAGE + rest <= _SMEM_MAX:
            return Bf16Plan(_W_ROWS, -(-ns // _W_ROWS) if ns > _W_ROWS else 1, stages,
                            stages * _W_STAGE + rest, "wgmma")
    return None


def bf16_wgmma_grid(groups: int, ns: int, cf: int, widths, bwd: bool, sms: int) -> int:
    """The streamed kernel's blocks: one a tile, and the forward splits
    layer 3's passes over up to sms / tiles blocks a tile."""
    tiles = (groups * -(-ns // _W_ROWS) if ns > _W_ROWS
             else -(-groups // (_W_ROWS // _pad16(ns))))
    if bwd:
        return tiles
    l3 = sum(ps.src == "kw3" for ps in bf16_wgmma_passes(cf, widths, False)[0])
    return tiles * max(1, min(l3, sms // tiles))


def bf16_kernel(ns: int, cf: int, widths, bwd: bool) -> str:
    """The device kernel a direction's C entry runs at this shape:
    gmlp_bf16_{fwd,bwd}_resident, _wgmma (streamed) or _tiles (staged)."""
    kind = bf16_plan(ns, cf, tuple(widths), bwd).kind
    return f"gmlp_bf16_{'bwd' if bwd else 'fwd'}_{kind}"


@lru_cache(maxsize=256)
def bf16_plan(ns: int, cf: int, widths, bwd: bool) -> Bf16Plan:
    """A bf16 kernel's plan as its C entry picks it. The kernel with
    resident weights where its rule finds a height (the largest of 128, 64
    and 32 rows whose block leaves room for two an SM, else the largest of
    128 .. 16 that fits one; `bf16_resident_bytes`,
    `bf16_resident_fwd_bytes`; depth 0: no weight stages); else the
    streamed one where it fits (`bf16_wgmma_plan`; depth: its ring's
    stages); else the staged one (`bf16_smem_bytes`, depth 32), which
    streams layer 1's input in slices, so cf sets it no limit. A group of
    more rows than the tile is split into ceil(ns / rows) parts (the
    forward merges their maxima in a finishing kernel). Raises where no
    height fits (widths past ~2000)."""
    widths = tuple(widths)
    resident = bf16_resident_bytes if bwd else bf16_resident_fwd_bytes
    staged = False
    for need in (lambda rows: resident(ns, cf, widths, rows),
                 lambda rows: bf16_smem_bytes(widths, rows, bwd)):
        for limit, heights in ((_SMEM_HALF, _BF16_ROWS[:-1]), (_SMEM_MAX, _BF16_ROWS)):
            for rows in heights:
                smem = need(rows)
                if smem <= limit:
                    return Bf16Plan(rows, (ns + rows - 1) // rows if ns > rows else 1,
                                    _BF16_KS if staged else 0, smem,
                                    "tiles" if staged else "resident")
        if not staged:
            plan = bf16_wgmma_plan(ns, cf, widths, bwd)
            if plan is not None:
                return plan
        staged = True
    raise ValueError(
        f"the bf16 group_mlp {'backward' if bwd else 'forward'}'s 16-row tile "
        f"needs {bf16_smem_bytes(widths, 16, bwd)} bytes of shared memory for "
        f"widths {widths}; a block has {_SMEM_MAX}")


def group_mlp_fwd_bf16(gx, gf, p: FoldedMLPBf16):
    """CUDA kernel, the single-pass bf16 mode: gx [b, m, ns, 3] bf16, gf
    [b, m, ns, cf] bf16 or None -> (pooled [b, m, c3] float32, tie count of
    each maximum [b, m, c3] int32)."""
    groups, ns, cf, c1, c2, c3 = _check_bf16(gx, gf, p)
    b, m = gx.shape[:2]
    pooled = torch.empty(b, m, c3, dtype=torch.float32, device=gx.device)
    cnt = torch.empty(b, m, c3, dtype=torch.int32, device=gx.device)
    # a split group's partial maxima and counts, one pair a part
    parts = bf16_plan(ns, cf, (c1, c2, c3), False).parts
    scratch = (torch.empty(2 * groups * parts * c3, dtype=torch.int32,
                           device=gx.device) if parts > 1 else None)
    _build.launch("geoa3_group_mlp_fwd_bf16", gx, gf, p.kw1, p.kb1, p.kw2, p.kb2,
                  p.kw3, p.kb3, p.kpf, groups, ns, cf, c1, c2, c3, pooled, cnt, scratch)
    group_mlp_fwd_bf16.launches += 1
    return pooled, cnt


def group_mlp_bwd_bf16(g, gx, gf, p: FoldedMLPBf16, pooled, cnt):
    """CUDA kernel: the cotangents of gx and gf for the pooled cotangent g
    [b, m, c3] float32 -> (dgx [b, m, ns, 3], dgf [b, m, ns, cf] or None),
    float32."""
    groups, ns, cf, c1, c2, c3 = _check_bf16(gx, gf, p)
    b, m = gx.shape[:2]
    _build.check_cuda(g, "g", torch.float32, (b, m, c3))
    _build.check_cuda(pooled, "pooled", torch.float32, (b, m, c3))
    _build.check_cuda(cnt, "cnt", torch.int32, (b, m, c3))
    dgx = torch.empty(b, m, ns, 3, dtype=torch.float32, device=gx.device)
    dgf = (torch.empty(b, m, ns, cf, dtype=torch.float32, device=gx.device)
           if gf is not None else None)
    _build.launch("geoa3_group_mlp_bwd_bf16", gx, gf, p.kw1, p.kb1, p.kw2, p.kb2,
                  p.kw3, p.kb3, p.kw1t, p.kw2t, p.kw3t, p.kpf, p.kpb, pooled, cnt, g,
                  groups, ns, cf, c1, c2, c3, dgx, dgf)
    group_mlp_bwd_bf16.launches += 1
    return dgx, dgf


class _GroupMLPMaxPoolBf16(torch.autograd.Function):
    """The single-pass bf16 grouped MLP: the kernels on CUDA tensors, the
    plain versions on CPU ones. The forward returns the maxima rounded to
    bf16 and keeps the float32 ones and their tie counts for the
    backward."""

    @staticmethod
    def forward(ctx, gx, gf, p):
        if gx.is_cuda:
            pooled, cnt = group_mlp_fwd_bf16(gx, gf, p)
        else:
            pooled, cnt = group_mlp_fwd_bf16_plain(gx, gf, p)
        ctx.save_for_backward(gx, gf, pooled, cnt)
        ctx.p = p
        return pooled.to(torch.bfloat16)

    @staticmethod
    def backward(ctx, g):
        gx, gf, pooled, cnt = ctx.saved_tensors
        g = g.float().contiguous()
        if gx.is_cuda:
            dgx, dgf = group_mlp_bwd_bf16(g, gx, gf, ctx.p, pooled, cnt)
        else:
            dgx, dgf = group_mlp_bwd_bf16_plain(g, gx, gf, ctx.p, pooled, cnt)
        return dgx.to(gx.dtype), None if dgf is None else dgf.to(gf.dtype), None


def group_mlp_maxpool_bf16(gx, gf: Optional[torch.Tensor], p: FoldedMLPBf16):
    """`group_mlp_maxpool` in the TPU kernel's single-pass bf16 mode: gx
    [b, m, ns, 3] and gf [b, m, ns, cf] (or None) in bf16, p from
    `fold_mlp_bf16` -> [b, m, c3] bf16. Differentiable in gx and gf only,
    whose cotangents come back in bf16. CPU tensors take the plain
    versions; CUDA tensors launch the kernels."""
    return _GroupMLPMaxPoolBf16.apply(
        gx.contiguous(), None if gf is None else gf.contiguous(), p)


def _pick_gpt(m: int, ns: int, cf: int, widths) -> int:
    """Groups a tile of the TPU kernel (geoa3_tpu/ops/pallas/
    group_mlp_kernel.py:_pick_gpt): a VMEM budget of rows, at most 8192,
    down to a divisor of m."""
    per_row = 4 * (8 + cf + 2 * sum(widths))
    r_target = min((24 << 20) // per_row, 8192)
    gpt = max(1, min(m, r_target // ns))
    while m % gpt:
        gpt -= 1
    return max(gpt, 1)


def group_mlp_available(ns: int, m: int, widths, cf: int) -> bool:
    """The JAX package's gate for its fused grouped MLP
    (geoa3_tpu/ops/pallas/group_mlp_kernel.py:group_mlp_available, with
    SharedMLP._can_fuse's ns > 1), which decides the bf16 victim's route:
    fused (this module's single-pass kernels) or the layers one by one in
    bf16. Three widths of at most 1024, a tile of at most 8192 rows that is
    a multiple of 128 unless it holds all of m, cf 0 or a multiple of
    128."""
    if len(widths) != 3 or ns <= 1:
        return False
    gpt = _pick_gpt(m, ns, cf, widths)
    if ns * gpt > 8192 or ((ns * gpt) % 128 and m != gpt):
        return False
    if cf % 128:
        return False
    return all(w <= 1024 for w in widths)


group_mlp_fwd_bf16.launches = 0
group_mlp_bwd_bf16.launches = 0
