"""Folded-BN affine + global max-pool: CUDA kernel wrappers, plain version.

Replaces geoa3_tpu/ops/pallas/pool_matmul_kernel.py:_fwd_kernel and
_bwd_kernel (`pool_affine_max` with one global segment), which PointNet's
three global pools run in eval mode. Source: csrc/pool_matmul.cu.

Bound on the H100: operations (25.8 GFLOP of float32 for the kernel-3 conv5
pool at [32, 1024, 128] -> 1024, 8.6 for each 1x1 T-Net pool). The forward
is a float32 product on the FMA units (no tensor cores, no TF32): a block
owns 128 channels of a cloud and walks its point tiles of 128, 8 x 8 outputs
a thread, the tile's x rows staged once in shared memory for every tap and
the weights streamed through a four-stage cp.async ring. Its epilogue takes
the max over points in registers (shuffles and ballots), so the [b, n, 1024]
activation never reaches device memory, and records each column's tie count
and first `MAX_TIES` tied rows (ascending, 0 past the count); the backward
adds g/cnt * w3[t, :, c] at those rows (shifted by tap) and needs no second
product. Each output is one fmaf chain from 0 in (tap, k) order plus the
bias, which the backward's recompute of a column with more ties repeats. The
TPU kernel runs split-bf16 products; this one stays float32 like the victim.

The bf16 victim (`models.registry.make_eval_fn(..., dtype=torch.bfloat16)`)
runs the TPU kernel's single-pass mode (`f32_exact=False`) instead:
`pool_fwd_bf16` / `pool_bwd_bf16` (csrc/pool_matmul_bf16.cu) on the tensor
cores. x (bf16 or float32) and w3 are rounded to bf16, the products are
exact and the sums float32; the backward rounds the cotangent g / cnt to
bf16 before its product with w3, and returns dx in x's type. Bound:
operations at 989 TFLOP/s of bf16. The forward is warp-specialised and
swaps the operands (z^T = W^T x^T): each consumer warp keeps its channels'
weights in registers (wgmma's A), the producer warpgroup bulk-copies
(TMA) the cloud's 64-point tiles and writes them as bf16 (float32 x
rounded by cvt.rn) in wgmma's K-major layout (B), two or four consumer
warpgroups of 64 channels run wgmma on each tile, then find each
channel's maximum, tie count and first `MAX_TIES` tied rows in registers,
with no block-wide barrier past the weights (`bf16_plan` mirrors the
plan); the backward's recompute of a column with more ties replays the
chain with mma.sync on the same operands.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.kernels import _build

MAX_TIES = 4  # kMaxTies in csrc/pool_matmul.cu
BLOCK_COUT = 128  # BN in csrc/pool_matmul.cu
BLOCK_CIN = 16  # BK in csrc/pool_matmul.cu
# the x slab (130 rows of cin + 4 floats) beside the weight ring and the
# column states must fit a block's 232,448 bytes of shared memory
MAX_CIN = 368
SMEM_MAX = 232448  # a block's opt-in shared memory on the H100


def affine_plain(x, w3, bias):
    """The pre-pool activations [B, n, cout]: sum_t x[p + t - taps//2] @ w3[t]
    + bias, with zero rows outside the cloud."""
    if w3.shape[0] == 1:
        return x @ w3[0] + bias
    zero = x.new_zeros(x.shape[0], 1, x.shape[2])
    xm1 = torch.cat([zero, x[:, :-1]], dim=1)
    xp1 = torch.cat([x[:, 1:], zero], dim=1)
    return xm1 @ w3[0] + x @ w3[1] + xp1 @ w3[2] + bias


def pool_affine_max_plain(x, w3, bias):
    """Plain PyTorch version: the max over points of `affine_plain`.
    Differentiable in x; torch.amax splits the gradient evenly among tied
    maxima, as the kernel does."""
    return torch.amax(affine_plain(x, w3, bias), dim=1)


def max_ties(z):
    """z [B, n, cout] -> (max over points [B, cout], tie count [B, cout]
    int32, first MAX_TIES rows holding the max [B, cout, MAX_TIES] int32,
    ascending, 0 past the count): the forward kernel's whole output for
    these activations."""
    B, n, cout = z.shape
    pooled = torch.amax(z, dim=1)
    tied = z == pooled[:, None]
    row = torch.arange(n, dtype=torch.int32, device=z.device)[None, :, None]
    key = torch.where(tied, row, n).transpose(1, 2)  # [B, cout, n]
    first = torch.topk(key, min(MAX_TIES, n), dim=2, largest=False).values
    first = torch.where(first < n, first, 0)
    rows = first.new_zeros(B, cout, MAX_TIES)
    rows[..., :first.shape[2]] = first
    return pooled, tied.sum(1, dtype=torch.int32), rows


def pool_ties_plain(x, w3, bias):
    """Plain PyTorch version of `pool_fwd`'s whole output: (pooled, cnt,
    rows) of `affine_plain`."""
    return max_ties(affine_plain(x, w3, bias))


def _check(x, w3, bias):
    B, n, cin = x.shape
    taps, _, cout = w3.shape
    _build.check_cuda(x, "x", torch.float32, (B, n, cin))
    _build.check_cuda(w3, "w3", torch.float32, (taps, cin, cout))
    _build.check_cuda(bias, "bias", torch.float32, (cout,))
    if taps not in (1, 3):
        raise ValueError(f"taps must be 1 or 3, got {taps}")
    if cin % BLOCK_CIN or cin > MAX_CIN or cout % BLOCK_COUT:
        raise ValueError(
            f"the pool kernel takes cin % {BLOCK_CIN} == 0, cin <= {MAX_CIN} "
            f"and cout % {BLOCK_COUT} == 0, got cin={cin}, cout={cout}"
        )
    if x.data_ptr() % 16 or w3.data_ptr() % 16:
        raise ValueError("the pool kernel copies x and w3 in 16-byte pieces: "
                         "both must start on a 16-byte boundary")
    return B, n, cin, cout, taps


def pool_fwd(x, w3, bias):
    """CUDA kernel: x [B, n, cin], w3 [taps, cin, cout], bias [cout] ->
    (pooled [B, cout], tie count [B, cout] int32, first tied rows
    [B, cout, MAX_TIES] int32)."""
    B, n, cin, cout, taps = _check(x, w3, bias)
    dev = x.device
    pooled = torch.empty(B, cout, dtype=torch.float32, device=dev)
    cnt = torch.empty(B, cout, dtype=torch.int32, device=dev)
    rows = torch.empty(B, cout, MAX_TIES, dtype=torch.int32, device=dev)
    _build.launch("geoa3_pool_fwd", x, w3, bias, B, n, cin, cout, taps,
                  pooled, cnt, rows)
    pool_fwd.launches += 1
    return pooled, cnt, rows


def pool_bwd(g, x, w3, w3t, bias, pooled, cnt, rows):
    """CUDA kernel: the input cotangent of `pool_fwd` for the pooled
    cotangent g [B, cout] -> dx [B, n, cin]. w3t is w3 laid out as
    [taps, cout, cin], so that a column's weights are one row."""
    B, n, cin, cout, taps = _check(x, w3, bias)
    _build.check_cuda(w3t, "w3t", torch.float32, (taps, cout, cin))
    _build.check_cuda(g, "g", torch.float32, (B, cout))
    _build.check_cuda(pooled, "pooled", torch.float32, (B, cout))
    _build.check_cuda(cnt, "cnt", torch.int32, (B, cout))
    _build.check_cuda(rows, "rows", torch.int32, (B, cout, MAX_TIES))
    dx = torch.zeros(B, n, cin, dtype=torch.float32, device=x.device)
    _build.launch("geoa3_pool_bwd", w3t, g, cnt, rows, x, bias, pooled, w3,
                  B, n, cin, cout, taps, dx)
    pool_bwd.launches += 1
    return dx


class _PoolAffineMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w3, w3t, bias):
        pooled, cnt, rows = pool_fwd(x, w3, bias)
        ctx.save_for_backward(x, w3, w3t, bias, pooled, cnt, rows)
        return pooled

    @staticmethod
    def backward(ctx, g):
        x, w3, w3t, bias, pooled, cnt, rows = ctx.saved_tensors
        dx = pool_bwd(g.contiguous(), x, w3, w3t, bias, pooled, cnt, rows)
        return dx, None, None, None


def pool_affine_max(x, w3, bias, w3t=None):
    """x [B, n, cin], w3 [taps, cin, cout] (taps 1 or 3; tap t sees row
    p + t - taps//2, zero outside), bias [cout] -> max over points [B, cout].
    Differentiable in x only (w3 and bias are frozen victim weights). w3t,
    w3 as [taps, cout, cin] for the backward, is made here unless the caller
    keeps one. CPU tensors take the plain version; CUDA tensors launch the
    kernels."""
    if not x.is_cuda:
        return pool_affine_max_plain(x, w3, bias)
    if w3t is None:
        w3t = w3.transpose(1, 2).contiguous()
    return _PoolAffineMax.apply(x, w3, w3t, bias)


def affine_bf16_plain(x, w3, bias):
    """The single-pass bf16 mode's pre-pool activations [B, n, cout]:
    `affine_plain` of x and w3 rounded to bf16 (their products are exact in
    float32), with float32 sums and the float32 bias."""
    return affine_plain(x.to(torch.bfloat16).float(),
                        w3.to(torch.bfloat16).float(), bias.float())


def pool_affine_max_bf16_plain(x, w3, bias):
    """Plain PyTorch version of the single-pass bf16 pool: the max over
    points of `affine_bf16_plain` [B, cout], float32."""
    return torch.amax(affine_bf16_plain(x, w3, bias), dim=1)


def pool_ties_bf16_plain(x, w3, bias):
    """Plain PyTorch version of `pool_fwd_bf16`'s whole output: (pooled,
    cnt, rows) of `affine_bf16_plain`."""
    return max_ties(affine_bf16_plain(x, w3, bias))


def pool_bwd_bf16_plain(g, x, w3, bias, pooled):
    """Plain PyTorch version of `pool_bwd_bf16`: dx [B, n, cin] in x's type
    for the pooled cotangent g [B, cout], as the TPU kernel's backward takes
    it in the single-pass mode: the rows tied at `pooled` share g / cnt,
    rounded to bf16, whose product with the bf16 weights is exact; float32
    sums, shifted by tap."""
    z = affine_bf16_plain(x, w3, bias)
    eq = z == pooled[:, None]
    cnt = eq.sum(1, keepdim=True, dtype=torch.float32)
    m = torch.where(eq, g[:, None] / cnt, 0.0).to(torch.bfloat16).float()
    w = w3.to(torch.bfloat16).float()
    if w.shape[0] == 1:
        dx = m @ w[0].T
    else:
        # z[p] read x[p - 1] through tap 0 and x[p + 1] through tap 2
        dx = m @ w[1].T
        dx[:, :-1] += m[:, 1:] @ w[0].T
        dx[:, 1:] += m[:, :-1] @ w[2].T
    return dx.to(x.dtype)


def bf16_plan(cin: int, cout: int, taps: int, xbytes: int):
    """The forward's plan (csrc/pool_matmul_bf16.cu `pool_bf16_plan`):
    (consumer warpgroups of 64 channels a block, shared memory in bytes),
    or None where no plan fits a block. Four (256 channels) at taps 1
    where cout >= 256 and it fits (the last block takes 128 where cout %
    256 == 128), else two; the mbarriers, the block's weights (rows of its
    channels + 8), and two landing buffers of a tile's 64 rows (66 at taps
    3) in x's type beside two operand buffers of the same rows in bf16."""
    rows = 64 + (2 if taps == 3 else 0)
    for nwg in (4, 2):
        if nwg == 4 and (taps != 1 or cout < 256):
            continue
        smem = 64 + taps * cin * (128 * nwg + 16) + 2 * rows * cin * (xbytes + 2)
        if smem <= SMEM_MAX:
            return nwg, smem
    return None


def _check_bf16(x, w3, bias):
    B, n, cin = x.shape
    taps, _, cout = w3.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x: expected float32 or bfloat16, got {x.dtype}")
    _build.check_cuda(x, "x", x.dtype, (B, n, cin))
    _build.check_cuda(w3, "w3", torch.bfloat16, (taps, cin, cout))
    _build.check_cuda(bias, "bias", torch.float32, (cout,))
    if taps not in (1, 3):
        raise ValueError(f"taps must be 1 or 3, got {taps}")
    if cin % BLOCK_CIN or cout % BLOCK_COUT or (
            bf16_plan(cin, cout, taps, x.element_size()) is None):
        raise ValueError(
            f"the bf16 pool kernel takes cin % {BLOCK_CIN} == 0, cout % "
            f"{BLOCK_COUT} == 0 and a block within {SMEM_MAX} bytes of shared "
            f"memory, got cin={cin}, cout={cout}, taps={taps}, x {x.dtype}")
    if x.data_ptr() % 16 or w3.data_ptr() % 16:
        raise ValueError("the bf16 pool kernel copies x and w3 in 16-byte "
                         "pieces: both must start on a 16-byte boundary")
    return B, n, cin, cout, taps


def pool_fwd_bf16(x, w3, bias):
    """CUDA kernel, the single-pass bf16 mode: x [B, n, cin] (bf16 or
    float32), w3 [taps, cin, cout] bf16, bias [cout] float32 -> (pooled
    [B, cout] float32, tie count [B, cout] int32, first tied rows
    [B, cout, MAX_TIES] int32)."""
    B, n, cin, cout, taps = _check_bf16(x, w3, bias)
    dev = x.device
    pooled = torch.empty(B, cout, dtype=torch.float32, device=dev)
    cnt = torch.empty(B, cout, dtype=torch.int32, device=dev)
    rows = torch.empty(B, cout, MAX_TIES, dtype=torch.int32, device=dev)
    _build.launch("geoa3_pool_fwd_bf16", x, w3, bias, B, n, cin, cout, taps,
                  int(x.dtype == torch.bfloat16), pooled, cnt, rows)
    pool_fwd_bf16.launches += 1
    return pooled, cnt, rows


def pool_bwd_bf16(g, x, w3, w3t, bias, pooled, cnt, rows):
    """CUDA kernel: the input cotangent of `pool_fwd_bf16` for the pooled
    cotangent g [B, cout] -> dx [B, n, cin] in x's type (summed in float32).
    w3t is w3 as [taps, cout, cin] bf16."""
    B, n, cin, cout, taps = _check_bf16(x, w3, bias)
    _build.check_cuda(w3t, "w3t", torch.bfloat16, (taps, cout, cin))
    _build.check_cuda(g, "g", torch.float32, (B, cout))
    _build.check_cuda(pooled, "pooled", torch.float32, (B, cout))
    _build.check_cuda(cnt, "cnt", torch.int32, (B, cout))
    _build.check_cuda(rows, "rows", torch.int32, (B, cout, MAX_TIES))
    dx = torch.empty(B, n, cin, dtype=torch.float32, device=x.device)
    _build.launch("geoa3_pool_bwd_bf16", w3t, g, cnt, rows, x, bias, pooled,
                  w3, B, n, cin, cout, taps, int(x.dtype == torch.bfloat16), dx)
    pool_bwd_bf16.launches += 1
    return dx.to(x.dtype)


class _PoolAffineMaxBf16(torch.autograd.Function):
    """The single-pass bf16 pool: the kernels on CUDA tensors, the plain
    versions on CPU ones."""

    @staticmethod
    def forward(ctx, x, w3, w3t, bias):
        if x.is_cuda:
            pooled, cnt, rows = pool_fwd_bf16(x, w3, bias)
        else:
            pooled, cnt, rows = pool_affine_max_bf16_plain(x, w3, bias), None, None
        ctx.save_for_backward(x, w3, w3t, bias, pooled, cnt, rows)
        return pooled

    @staticmethod
    def backward(ctx, g):
        x, w3, w3t, bias, pooled, cnt, rows = ctx.saved_tensors
        g = g.contiguous()
        if x.is_cuda:
            dx = pool_bwd_bf16(g, x, w3, w3t, bias, pooled, cnt, rows)
        else:
            dx = pool_bwd_bf16_plain(g, x, w3, bias, pooled)
        return dx, None, None, None


def pool_affine_max_bf16(x, w3, bias, w3t=None):
    """`pool_affine_max` in the TPU kernel's single-pass bf16 mode: x
    [B, n, cin] bf16 or float32, w3 [taps, cin, cout] bf16, bias [cout]
    float32 holding bf16 values -> max over points [B, cout] float32.
    Differentiable in x only; dx comes back in x's type. w3t (w3 as
    [taps, cout, cin]) is made here for a CUDA tensor unless the caller
    keeps one. CPU tensors take the plain versions; CUDA tensors launch the
    kernels."""
    if x.is_cuda and w3t is None:
        w3t = w3.transpose(1, 2).contiguous()
    return _PoolAffineMaxBf16.apply(x, w3, w3t, bias)


pool_fwd.launches = 0
pool_bwd.launches = 0
pool_fwd_bf16.launches = 0
pool_bwd_bf16.launches = 0
