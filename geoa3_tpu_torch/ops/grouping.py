"""Grouping by index and 3-NN interpolation (port of
geoa3_tpu/ops/grouping.py)."""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.knn import knn_gather, knn_points


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [b, n, c], idx [b, m, ns] -> [b, m, ns, c] (reference
    `grouping_operation`, group_points_gpu.cu:8-75). Differentiable in
    `features`: the backward is the scatter-add kernel over idx (the
    3-channel kernel for coordinates, the C-channel kernel otherwise, as
    geoa3_tpu/ops/grouping.py:56-77 chooses). The same gather as
    `knn_gather`, under the reference's name."""
    return knn_gather(features, idx)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The 3 nearest neighbours of unknown [b, n, 3] in known [b, m, 3] ->
    (dist [b, n, 3], idx [b, n, 3] int32), ascending, lowest index on ties.
    dist is the distance itself, not its square, as the reference's Python
    wrapper takes the root of its kernel's output (pointnet2_utils.py:
    124-125). The kNN kernel at k = 3; not differentiable."""
    res = knn_points(unknown.detach(), known.detach(), 3)
    return torch.sqrt(res.dists), res.idx


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN interpolation: features [b, m, c], idx and weight
    [b, n, 3] -> [b, n, c] = sum_j weight[..., j] features[idx[..., j]]
    (reference interpolate_gpu.cu:72-154). Differentiable in `features`
    (the backward of the gather is the scatter-add kernel) and, as in the
    JAX package, in `weight`."""
    return (knn_gather(features, idx) * weight[..., None]).sum(dim=2)
