"""Exact k nearest neighbours: CUDA kernel wrapper and its plain version.

Replaces geoa3_tpu/ops/pallas/knn_kernel.py:_knn_kernel (`knn_pallas`,
`knn_pallas_planes`). Source: csrc/knn.cu.

Bound on the H100: operations (b*n*m distance evaluations and k passes of
key comparisons over each row, against a few MB of inputs and outputs). One
warp owns a query row: its distances sit in shared memory, and round r takes
the warp-wide minimum over (distance bits, index) keys strictly above round
r-1's, writing that neighbour's distance, index and coordinates, so the
output is ordered and ties go to the lowest index. Distances are rounded step
by step like `pairwise_sqdist`, so the kernel orders bitwise what the plain
version does. A point's own column is not special here: it competes like any
other (the self-first rule belongs to the kappa kernels).

Limits: 1 <= k <= min(m, 64) (ops.knn_points takes k == 1 as an argmin, as
the JAX package does); m <= 4096 (the block keeps 12 rows of m floats in shared
memory); b <= 65535 (the batch is the grid's second axis; the uniform loss
calls with b * npoint / 20 groups as the batch).
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.distance import pairwise_sqdist
from geoa3_tpu_torch.ops.kernels import _build

MAX_K = 64
MAX_M = 4096  # (4 + 8 warps) * m floats of shared memory
MAX_B = 65535  # gridDim.y


def gather_nbrs(points, idx):
    """points [b, m, c], idx [b, n, k] (any integer type) -> [b, n, k, c]."""
    b, n, k = idx.shape
    flat = idx.reshape(b, n * k, 1).long().expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, flat).reshape(b, n, k, points.shape[-1])


def knn_plain(query, points, k):
    """Plain PyTorch version of `knn`: the distance matrix, a stable sort,
    its first k columns, a gather."""
    d = pairwise_sqdist(query, points)
    vals, order = torch.sort(d, dim=-1, stable=True)
    idx = order[..., :k]
    return vals[..., :k].contiguous(), idx.to(torch.int32), gather_nbrs(points, idx)


def _check(m, k):
    if not 1 <= k <= min(m, MAX_K):
        raise ValueError(f"knn takes 1 <= k <= min(m, {MAX_K}), got k={k}, m={m}")
    if m > MAX_M:
        raise ValueError(f"the knn kernel takes m <= {MAX_M}, got {m}")


def knn(query, points, k):
    """query [b, n, 3], points [b, m, 3] -> (dists [b, n, k] f32, idx
    [b, n, k] int32, nbrs [b, n, k, 3] f32): each row's k smallest
    max(|q|^2 + |p|^2 - 2 q.p, 0), ascending, lowest index on ties, with the
    neighbours' coordinates. Not differentiable. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    b, n, _ = query.shape
    m = points.shape[1]
    _check(m, k)
    if not query.is_cuda:
        return knn_plain(query, points, k)
    if b > MAX_B:
        raise ValueError(f"the knn kernel takes a batch <= {MAX_B}, got {b}")
    _build.check_cuda(query, "query", torch.float32, (b, n, 3))
    _build.check_cuda(points, "points", torch.float32, (b, m, 3))
    dev = query.device
    dists = torch.empty(b, n, k, dtype=torch.float32, device=dev)
    idx = torch.empty(b, n, k, dtype=torch.int32, device=dev)
    nbrs = torch.empty(b, n, k, 3, dtype=torch.float32, device=dev)
    _build.launch("geoa3_knn", query, points, b, n, m, k, dists, idx, nbrs)
    knn.launches += 1
    return dists, idx, nbrs


knn.launches = 0
