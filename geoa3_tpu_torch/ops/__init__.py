"""Point-cloud ops of the port (counterpart of geoa3_tpu/ops)."""

from geoa3_tpu_torch.ops.ball_query import ball_query
from geoa3_tpu_torch.ops.grouping import group_points, three_interpolate, three_nn
from geoa3_tpu_torch.ops.kernels.ballquery_group_kernel import ball_query_group
from geoa3_tpu_torch.ops.kernels.group_mlp_kernel import (
    fold_mlp,
    group_mlp_maxpool,
)
from geoa3_tpu_torch.ops.kernels.sa_fused_kernel import sa_query_group_mlp
from geoa3_tpu_torch.ops.kernels.scatter_kernel import scatter_add_3
from geoa3_tpu_torch.ops.knn import (
    KNNPlanes,
    KNNResult,
    curv_term_from_mask,
    gather_rows,
    kappa_select_mask,
    knn_gather,
    knn_kappa,
    knn_kappa_from_mask,
    knn_points,
    knn_points_planes,
    nn1_dual,
    nn1_dual_payload,
    o2a_coord_planes,
    pairwise_sqdist,
)
from geoa3_tpu_torch.ops.sampling import (
    farthest_points_sample,
    farthest_points_sample_with_normal,
    furthest_point_sampling,
    gather_points,
)

__all__ = [
    "KNNPlanes",
    "KNNResult",
    "pairwise_sqdist",
    "knn_points",
    "knn_points_planes",
    "knn_gather",
    "gather_rows",
    "nn1_dual",
    "nn1_dual_payload",
    "o2a_coord_planes",
    "kappa_select_mask",
    "curv_term_from_mask",
    "knn_kappa",
    "knn_kappa_from_mask",
    "furthest_point_sampling",
    "gather_points",
    "farthest_points_sample",
    "farthest_points_sample_with_normal",
    "ball_query",
    "ball_query_group",
    "group_points",
    "fold_mlp",
    "group_mlp_maxpool",
    "sa_query_group_mlp",
    "scatter_add_3",
    "three_nn",
    "three_interpolate",
]
