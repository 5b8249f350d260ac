"""Farthest-point sampling: CUDA kernel wrapper and its plain version.

Replaces geoa3_tpu/ops/pallas/fps_kernel.py:_fps_kernel (`fps_pallas`).
Source: csrc/fps.cu.

Bound on the H100: by the roofline rule bytes (the cloud read once, the
indices written once), an empty bound here: the work is m-1 dependent rounds
on b of the 132 SMs, each bound by the latency of its chain and, past ~2048
points, by the instructions its scan issues on one SM. One block owns a
cloud; each thread keeps its points' coordinates and running minima in
registers for all rounds (`fps_plan`); a point's score is its minimum's bits
as a signed int (INT_MIN when skipped), so the update is one integer minimum;
warps take the argmax with two `redux.sync` reductions (maximum score, then
lowest index), every warp reduces the warps' winners after the round's one
barrier and reads the pick's coordinates from a copy of the cloud in shared
memory. Distances are rounded step by step like the plain version's, so both
pick bitwise the same points.

Limit: n <= 14336 (1024 threads of 14 points).
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.distance import sqnorm3
from geoa3_tpu_torch.ops.kernels import _build

INIT_DIST = 1e10  # the running minimum's start (reference sampling.cpp:78)
SKIP_MAG2 = 1e-3  # |p|^2 at or below which a point is never a candidate
MAX_N = 14336
# the plan csrc/fps.cu's fps_plan takes
MAX_THREADS = 1024
PLAN_THREADS = 256  # the block's width wherever it holds the cloud
REG_POINTS = 10  # the most points a thread keeps in registers at 1024 threads
SLOT_BYTES = 2 * 32 * (4 + 4)  # the warps' double-buffered (score, index)


def fps_plan(n):
    """(threads, points a thread, coordinates read from shared memory, shared
    memory bytes) of the kernel's block for clouds of n points: PLAN_THREADS
    threads wherever they hold the cloud at REG_POINTS points a thread (n from
    PLAN_THREADS to 2560), the narrowest power of two from 32 with a point a
    thread below that, and above it the narrowest power of two that holds the
    cloud at REG_POINTS points a thread, at most 1024; P = ceil(n / T) points
    a thread, whose coordinates leave registers for shared memory only where
    P > REG_POINTS (n > 10240). Shared memory holds the warps' slots and a
    float4 copy of the cloud, from which every thread reads each round's
    pick."""
    t = 32
    while t < MAX_THREADS and (t < n if t < PLAN_THREADS else t * REG_POINTS < n):
        t *= 2
    p = -(-n // t)
    return t, p, p > REG_POINTS, SLOT_BYTES + 16 * t * p


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
