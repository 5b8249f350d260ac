"""Point-cloud ops of the port (counterpart of geoa3_tpu/ops)."""

from geoa3_tpu_torch.ops.knn import (
    curv_term_from_mask,
    kappa_select_mask,
    knn_kappa,
    nn1_dual_payload,
    o2a_coord_planes,
    pairwise_sqdist,
)

__all__ = [
    "pairwise_sqdist",
    "nn1_dual_payload",
    "o2a_coord_planes",
    "kappa_select_mask",
    "curv_term_from_mask",
    "knn_kappa",
]
