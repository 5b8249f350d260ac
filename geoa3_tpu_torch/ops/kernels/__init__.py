"""The port's hand-written CUDA kernels (csrc/*.cu), one module per family.

Each wrapper takes its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors, and counts its launches in `<wrapper>.launches`.
Importing this package builds nothing: the first launch builds csrc/ (see
_build.py).
"""

from __future__ import annotations

from geoa3_tpu_torch.ops.kernels import (
    ballquery_group_kernel,
    fps_kernel,
    group_mlp_kernel,
    kappa_kernel,
    knn_kernel,
    nn1_kernel,
    pool_matmul_kernel,
    sa_fused_kernel,
    scatter_kernel,
)

# kernel name -> its launching wrapper
KERNELS = {
    "nn1_payload": nn1_kernel.nn1_dual_payload,
    "scatter_add_3t": scatter_kernel.scatter_add_3t,
    "kappa_selmask": kappa_kernel.kappa_selmask,
    "curv_term": kappa_kernel.curv_term,
    "kappa_fwd": kappa_kernel.kappa_fwd,
    "pool_fwd": pool_matmul_kernel.pool_fwd,
    "pool_bwd": pool_matmul_kernel.pool_bwd,
    "kappa_bwd": kappa_kernel.kappa_bwd,
    "kappa_frommask": kappa_kernel.kappa_frommask,
    "nn1_dual": nn1_kernel.nn1_dual,
    "knn": knn_kernel.knn,
    "fps": fps_kernel.fps,
    "scatter_add_nc": scatter_kernel.scatter_add_nc,
    "ballquery_group_fwd": ballquery_group_kernel.ballquery_group_fwd,
    "ballquery_group_bwd": ballquery_group_kernel.ballquery_group_bwd,
    "group_mlp_fwd": group_mlp_kernel.group_mlp_fwd,
    "group_mlp_bwd": group_mlp_kernel.group_mlp_bwd,
    "scatter_add_3": scatter_kernel.scatter_add_3,
    "sa_fused_fwd": sa_fused_kernel.sa_fused_fwd,
    "sa_fused_bwd": sa_fused_kernel.sa_fused_bwd,
}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
