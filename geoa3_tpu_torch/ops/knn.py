"""Nearest-neighbour ops of the attack's main path (port of
geoa3_tpu/ops/knn.py).

Distances are squared Euclidean (pytorch3d semantics, reference
Lib/loss_utils.py:28-50). Selected indices and masks carry no gradient;
gradients flow through coordinates. Each op goes through its kernel wrapper
in ops/kernels/, which takes the plain PyTorch version for CPU tensors and
the CUDA kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.distance import pairwise_sqdist
from geoa3_tpu_torch.ops.kernels import kappa_kernel, nn1_kernel, scatter_kernel

__all__ = [
    "pairwise_sqdist",
    "nn1_dual_payload",
    "o2a_coord_planes",
    "kappa_select_mask",
    "curv_term_from_mask",
    "knn_kappa",
]


def nn1_dual_payload(adv, ori, payload):
    """Both 1-NN directions plus exact copies at the argmins:
    (a2o [b, n], o2a [b, m], gp [b, 8, n], op [b, 8, m]) with
    gp[b, p, i] = payload[b, p, a2o[b, i]] and op[b, c, j] = adv[b, o2a[b, j], c]
    (rows 3..7 zero). All outputs are constants; `o2a_coord_planes` gives a
    differentiable view of `op`."""
    return nn1_kernel.nn1_dual_payload(
        adv.detach(), ori.detach(), payload.detach()
    )


class _O2ACoordPlanes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx, op):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return op.clone()

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        ct3 = ct[:, :3].transpose(1, 2).contiguous()  # [b, m, 3]
        return scatter_kernel.scatter_add_3t(idx, ct3, ctx.n), None, None


def o2a_coord_planes(points, idx, op):
    """Differentiable view of the o2a coordinate planes: points [b, n, 3],
    idx [b, m] int32 (o2a argmins), op [b, 8, m] (exact copies of points rows
    at idx) -> op; the backward scatter-adds the plane cotangents into the
    rows of `points`. idx and op get no gradient."""
    return _O2ACoordPlanes.apply(points, idx, op.detach())


def kappa_select_mask(cloud, k: int):
    """Self-kNN membership mask: cloud [b, n, 3] -> [b, n, n] int8 with k+1
    ones per row, itself plus its k nearest other points, lowest index on
    ties (reference Lib/loss_utils.py:70-78). Not differentiable."""
    return kappa_kernel.kappa_selmask(cloud.detach(), k)


class _CurvTerm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cloud, normal, ref, mask, k):
        curv, grad = kappa_kernel.curv_term(cloud, normal, ref, mask, k)
        ctx.save_for_backward(grad)
        return curv

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None, None] * grad, None, None, None, None


def curv_term_from_mask(cloud, normal, ref, mask, k: int):
    """Per-instance curvature term with a cached selection mask: cloud,
    normal [b, n, 3], ref [b, n] (the 1-NN ori kappa), mask [b, n, n] int8
    -> [b] = mean_i (kappa_i - ref_i)^2 (reference curvature_loss,
    Lib/loss_utils.py:84-97). Differentiable in `cloud` only: the kernel
    emits the gradient with the value, so the backward scales it by the
    per-instance cotangent."""
    return _CurvTerm.apply(
        cloud.contiguous(), normal.detach().contiguous(),
        ref.detach().contiguous(), mask, k,
    )


def knn_kappa(cloud, normal, k: int):
    """Curvature proxy over the self-kNN neighbourhood: cloud, normal
    [b, n, 3] -> kappa [b, n], kappa_i = mean over the k nearest other
    points j of |unit(p_j - p_i) . n_i| (reference Lib/loss_utils.py:52-62).
    Forward only: the attack needs it for the constant `kappa_ori`."""
    if torch.is_grad_enabled() and cloud.requires_grad:
        raise NotImplementedError(
            "knn_kappa is forward-only in the port (kappa_bwd is queued in "
            "ROADMAP.md); call it on a detached cloud"
        )
    kappa, _ = kappa_kernel.kappa_fwd(
        cloud.contiguous(), normal.detach().contiguous(), k
    )
    return kappa
