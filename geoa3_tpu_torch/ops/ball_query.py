"""Ball query with the reference's padding semantics (port of
geoa3_tpu/ops/ball_query.py)."""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.kernels import ballquery_group_kernel


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz [b, n, 3] points, new_xyz [b, m, 3] centres -> idx [b, m, nsample]
    int32 (reference ball_query_gpu.cu:9-54): strictly d^2 < r^2, the first
    `nsample` hits in ascending index order, padded with the first hit; a
    centre with no hit gets index 0 in every slot; `nsample` may exceed n.
    Not differentiable. The fused query+group kernel with its gathers
    compiled out."""
    return ballquery_group_kernel.ball_query(xyz, new_xyz, radius, nsample)
