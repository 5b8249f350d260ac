"""Grouping by index (port of geoa3_tpu/ops/grouping.py:group_points).

`three_nn` and `three_interpolate` are queued with the feature-propagation
module (ROADMAP.md).
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.knn import knn_gather


def group_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [b, n, c], idx [b, m, ns] -> [b, m, ns, c] (reference
    `grouping_operation`, group_points_gpu.cu:8-75). Differentiable in
    `features`: the backward is the scatter-add kernel over idx (the
    3-channel kernel for coordinates, the C-channel kernel otherwise, as
    geoa3_tpu/ops/grouping.py:56-77 chooses). The same gather as
    `knn_gather`, under the reference's name."""
    return knn_gather(features, idx)
