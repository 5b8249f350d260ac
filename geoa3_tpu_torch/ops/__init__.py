"""Point-cloud ops of the port (counterpart of geoa3_tpu/ops)."""

from geoa3_tpu_torch.ops.knn import (
    KNNPlanes,
    KNNResult,
    curv_term_from_mask,
    gather_rows3,
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

__all__ = [
    "KNNPlanes",
    "KNNResult",
    "pairwise_sqdist",
    "knn_points",
    "knn_points_planes",
    "knn_gather",
    "gather_rows3",
    "nn1_dual",
    "nn1_dual_payload",
    "o2a_coord_planes",
    "kappa_select_mask",
    "curv_term_from_mask",
    "knn_kappa",
    "knn_kappa_from_mask",
]
