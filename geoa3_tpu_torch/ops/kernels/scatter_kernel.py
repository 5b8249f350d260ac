"""Scatter-adds, 3-channel and C-channel: CUDA kernel wrappers and their
plain versions.

Replaces geoa3_tpu/ops/pallas/scatter_kernel.py:_scatter3t_kernel
(`scatter_add_3t_pallas`), the backward of ops.o2a_coord_planes. Source:
csrc/scatter.cu.

Bound on the H100: bytes (under 1 MB at the main path's [32, 1024]), so a
call's cost is its launches and its host path. The TPU's one-hot matrix
product exists because the TPU has no scattered stores. Here one launch
writes the whole output, so it comes from torch.empty with no fill launch:
clouds of up to `SHARED_ROWS` rows sum in a block's shared memory (one block
a cloud, shared-memory atomicAdd, one coalesced store of the [n, 3] output);
larger clouds zero the output on the stream and add with global atomicAdd.
The cotangent is read through its strides, so a strided view (the o2a
backward's [b, 8, m] planes seen as [b, m, 3]) needs no copy. The addition
order varies from run to run, so colliding rows agree with the plain version
to float32 rounding, not bitwise.

`scatter_add_3` replaces :_scatter3_kernel (`scatter_add_pallas`): idx
[b, n, k], ct [b, n, k, 3] -> [b, m, 3], the backward of a k-neighbour
gather (a public op; no path of the JAX package calls it either). Its rows
are `scatter_add_3t`'s [b, S] rows with S = n * k, so it launches the same
device kernels. Bound: bytes.

`scatter_add_nc` replaces :_scatter_nc_kernel (`scatter_add_nc_pallas`), the
backward of ops.group_points at C channels: one thread per (source row,
channel), so a warp reads 32 neighbouring cotangents and adds them to 32
neighbouring addresses of one output row. Bound: bytes (the cotangents read
once, the output zeroed and written once). The fused ball query's backward
(csrc/ballquery_group.cu) runs the same device kernel.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.kernels import _build

# kSharedRows in csrc/scatter.cu: the largest cloud whose [n, 3] float32 sums
# fit a block's 232,448 bytes of shared memory on the H100; larger clouds
# take the global-atomic route
SHARED_ROWS = 232448 // 12


def scatter_add_3t_plain(idx, ct, n):
    """Plain PyTorch version of `scatter_add_3t`."""
    out = ct.new_zeros(ct.shape[0], n, 3)
    return out.scatter_add_(1, idx.long()[..., None].expand(-1, -1, 3), ct)


def scatter_add_3t(idx, ct, n):
    """idx [b, S] int32, ct [b, S, 3] (any strides) -> [b, n, 3] with
    out[b, idx[b, s]] += ct[b, s]. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not ct.is_cuda:
        return scatter_add_3t_plain(idx, ct, n)
    b, S = idx.shape
    _build.check_cuda(idx, "idx", torch.int32, (b, S))
    _build.check_cuda(ct, "ct", torch.float32, (b, S, 3), contiguous=False)
    out = torch.empty(b, n, 3, dtype=torch.float32, device=ct.device)
    _build.launch("geoa3_scatter_add_3t", idx, ct, b, S, n, *ct.stride(), out)
    scatter_add_3t.launches += 1
    return out


def scatter_add_3_plain(idx, ct, m):
    """Plain PyTorch version of `scatter_add_3` (out-of-range rows dropped,
    as the kernel and the TPU's one-hot product drop them)."""
    b = ct.shape[0]
    idx = idx.reshape(b, -1).long()
    ok = (idx >= 0) & (idx < m)
    ct = torch.where(ok[..., None], ct.reshape(b, -1, 3), 0.0)
    return scatter_add_3t_plain(torch.where(ok, idx, 0), ct, m)


def scatter_add_3(idx, ct, m):
    """idx [b, n, k] int32, ct [b, n, k, 3] -> [b, m, 3] with
    out[b, idx[b, i, j]] += ct[b, i, j]; indices outside [0, m) are dropped.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not ct.is_cuda:
        return scatter_add_3_plain(idx, ct, m)
    b, n, k = idx.shape
    _build.check_cuda(idx, "idx", torch.int32, (b, n, k))
    _build.check_cuda(ct, "ct", torch.float32, (b, n, k, 3))
    out = torch.empty(b, m, 3, dtype=torch.float32, device=ct.device)
    _build.launch("geoa3_scatter_add_3", idx, ct, b, n, k, m, out)
    scatter_add_3.launches += 1
    return out


def scatter_add_nc_plain(idx, ct, n):
    """Plain PyTorch version of `scatter_add_nc`."""
    c = ct.shape[-1]
    out = ct.new_zeros(ct.shape[0], n, c)
    return out.scatter_add_(1, idx.long()[..., None].expand(-1, -1, c), ct)


def scatter_add_nc(idx, ct, n):
    """idx [b, S] int32, ct [b, S, C] -> [b, n, C] with
    out[b, idx[b, s]] += ct[b, s]. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not ct.is_cuda:
        return scatter_add_nc_plain(idx, ct, n)
    b, S = idx.shape
    c = ct.shape[-1]
    _build.check_cuda(idx, "idx", torch.int32, (b, S))
    _build.check_cuda(ct, "ct", torch.float32, (b, S, c))
    out = torch.zeros(b, n, c, dtype=torch.float32, device=ct.device)
    _build.launch("geoa3_scatter_add_nc", idx, ct, b, S, n, c, out)
    scatter_add_nc.launches += 1
    return out


def scatter_rows(idx, ct, m):
    """The backward of a row gather: idx [b, ...] into m rows, ct [b, ..., c]
    -> [b, m, c]. Coordinates (c == 3) take the 3-channel kernel, as the JAX
    package's backward chooses (geoa3_tpu/ops/grouping.py:56-77)."""
    b, c = ct.shape[0], ct.shape[-1]
    flat = idx.reshape(b, -1).to(torch.int32).contiguous()
    ct = ct.reshape(b, -1, c).contiguous()
    return (scatter_add_3t if c == 3 else scatter_add_nc)(flat, ct, m)


scatter_add_3t.launches = 0
scatter_add_3.launches = 0
scatter_add_nc.launches = 0
