"""Farthest-point sampling: CUDA kernel wrapper and its plain version.

Replaces geoa3_tpu/ops/pallas/fps_kernel.py:_fps_kernel (`fps_pallas`).
Source: csrc/fps.cu.

Bound on the H100: by the roofline rule bytes (the cloud read once, the
indices written once), an empty bound here: the work is m-1 dependent rounds
of a distance update and a block-wide argmax on b of the 132 SMs. One block
owns a cloud; the cloud and its running minimum sit in shared memory; the
argmax runs over 64-bit (minimum-distance bits, ~index) keys so that ties go
to the lowest index. Distances are rounded step by step like the plain
version's, so both pick bitwise the same points.

Limit: n <= 14336 (the block keeps 4 floats a point in shared memory).
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.distance import sqnorm3
from geoa3_tpu_torch.ops.kernels import _build

INIT_DIST = 1e10  # the running minimum's start (reference sampling.cpp:78)
SKIP_MAG2 = 1e-3  # |p|^2 at or below which a point is never a candidate
MAX_N = 14336


def fps_plain(xyz, m, start=None, skip_near_origin=True):
    """Plain PyTorch version of `fps`: m-1 rounds of a minimum update and a
    first-index argmax over the whole batch."""
    b, n, _ = xyz.shape
    dev = xyz.device
    if start is None:
        last = torch.zeros(b, dtype=torch.long, device=dev)
    else:
        last = start.long().clamp(0, n - 1)
    mindist = xyz.new_full((b, n), INIT_DIST)
    ok = None
    if skip_near_origin:
        ok = sqnorm3(xyz) > xyz.new_tensor(SKIP_MAG2)
    idx = torch.empty(b, m, dtype=torch.long, device=dev)
    idx[:, 0] = last
    rows = torch.arange(b, device=dev)
    for j in range(1, m):
        d = sqnorm3(xyz - xyz[rows, last][:, None, :])
        mindist = torch.minimum(mindist, d)
        score = mindist if ok is None else torch.where(
            ok, mindist, mindist.new_tensor(-1.0))
        last = score.argmax(dim=-1)
        idx[:, j] = last
    return idx.to(torch.int32)


def fps(xyz, m, start=None, skip_near_origin=True):
    """xyz [b, n, 3] -> idx [b, m] int32: greedy farthest-point sampling from
    `start` [b] (int32; index 0 when None), running minimum from 1e10, lowest
    index on ties; with `skip_near_origin`, points with |p|^2 <= 1e-3 never
    become candidates (reference sampling_gpu.cu:100-101). Not differentiable.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    b, n, _ = xyz.shape
    if m < 1 or n < 1:
        raise ValueError(f"fps takes m >= 1 and n >= 1, got m={m}, n={n}")
    if not xyz.is_cuda:
        return fps_plain(xyz, m, start, skip_near_origin)
    if n > MAX_N:
        raise ValueError(f"the fps kernel takes n <= {MAX_N}, got {n}")
    _build.check_cuda(xyz, "xyz", torch.float32, (b, n, 3))
    if start is not None:
        _build.check_cuda(start, "start", torch.int32, (b,))
    idx = torch.empty(b, m, dtype=torch.int32, device=xyz.device)
    _build.launch("geoa3_fps", xyz, start, b, n, m, int(skip_near_origin), idx)
    fps.launches += 1
    return idx


fps.launches = 0
