"""3-channel scatter-add: CUDA kernel wrapper and its plain version.

Replaces geoa3_tpu/ops/pallas/scatter_kernel.py:_scatter3t_kernel
(`scatter_add_3t_pallas`), the backward of ops.o2a_coord_planes. Source:
csrc/scatter.cu.

Bound on the H100: bytes (under 1 MB at the main path's [32, 1024]); launch
overhead dominates. The TPU's one-hot matrix product exists because the TPU
has no scattered stores; here one thread per source row adds its three values
with atomicAdd. The addition order varies from run to run, so colliding rows
agree with the plain version to float32 rounding, not bitwise.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.kernels import _build


def scatter_add_3t_plain(idx, ct, n):
    """Plain PyTorch version of `scatter_add_3t`."""
    out = ct.new_zeros(ct.shape[0], n, 3)
    return out.scatter_add_(1, idx.long()[..., None].expand(-1, -1, 3), ct)


def scatter_add_3t(idx, ct, n):
    """idx [b, S] int32, ct [b, S, 3] -> [b, n, 3] with
    out[b, idx[b, s]] += ct[b, s]. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not ct.is_cuda:
        return scatter_add_3t_plain(idx, ct, n)
    b, S = idx.shape
    _build.check_cuda(idx, "idx", torch.int32, (b, S))
    _build.check_cuda(ct, "ct", torch.float32, (b, S, 3))
    out = torch.zeros(b, n, 3, dtype=torch.float32, device=ct.device)
    _build.launch("geoa3_scatter_add_3t", idx, ct, b, S, n, out)
    scatter_add_3t.launches += 1
    return out


scatter_add_3t.launches = 0
