"""Data-smoothness metric (port of geoa3_tpu/measurement.py; reference
Measurement/compute_data_smoothness.py:30-86).

Per cloud: each point's normal is the smallest eigenvector of the covariance
of its k2 nearest neighbours (no sign fix: the metric takes |.|); a point's
value is the mean over its k nearest neighbours of |<nbr - p, normal>|, and a
cloud's smoothness is the largest point value. The two self-kNNs (k2 + 1 and
k + 1 neighbours) are the kNN kernel on the card; the batched 3x3
eigendecomposition runs in chunks of 4096 matrices (attack.project).
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch import ops
from geoa3_tpu_torch.attack.project import _eigh_batched


def point_smoothness(pc: torch.Tensor, k: int = 16, k2: int = 16):
    """pc [b, n, 3] -> (each point's value [b, n], the eigenvalues of its
    neighbours' covariance [b, n, 3] in ascending order)
    (compute_data_smoothness.py:48-66). The offsets are taken from the point
    itself (the reference's hypothesis that the plane passes through the
    point, :63-64); the covariance divides by k2 - 1, as np.cov does."""
    pc = pc.detach()
    nn2 = ops.knn_points(pc, pc, k=k2 + 1).nbrs[:, :, 1:, :]
    offsets2 = nn2 - pc[:, :, None, :]
    centered = offsets2 - offsets2.mean(dim=2, keepdim=True)
    cov = torch.einsum("bnkc,bnkd->bncd", centered, centered) / (k2 - 1)
    eigval, eigvec = _eigh_batched(cov)
    normal = eigvec[..., :, 0]  # the smallest eigenvalue's direction

    nn = ops.knn_points(pc, pc, k=k + 1).nbrs[:, :, 1:, :]
    offsets = nn - pc[:, :, None, :]
    value = (offsets * normal[:, :, None, :]).sum(dim=-1).abs().mean(dim=-1)
    return value, eigval


def smoothness(pc: torch.Tensor, k: int = 16, k2: int = 16) -> torch.Tensor:
    """pc [b, n, 3] -> smoothness [b]: the largest point value."""
    return point_smoothness(pc, k, k2)[0].amax(dim=-1)
