"""Nearest-neighbour ops (port of geoa3_tpu/ops/knn.py).

Distances are squared Euclidean (pytorch3d semantics, reference
Lib/loss_utils.py:28-50). Selected indices and masks carry no gradient;
gradients flow through coordinates: `knn_points` recomputes its distances
from the gathered neighbours, and every gather's backward is the scatter-add
kernel. Each op goes through its kernel wrapper in ops/kernels/, which takes
the plain PyTorch version for CPU tensors and the CUDA kernel for CUDA
tensors.

Farthest-point sampling, the ball query and grouping live in ops/sampling.py,
ops/ball_query.py and ops/grouping.py. `set_topk_backend`'s approximate mode
is a TPU option and has no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from geoa3_tpu_torch.ops.distance import pairwise_sqdist
from geoa3_tpu_torch.ops.kernels import (
    kappa_kernel,
    knn_kernel,
    nn1_kernel,
    scatter_kernel,
)

__all__ = [
    "KNNResult",
    "KNNPlanes",
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
]


class KNNResult(NamedTuple):
    """pytorch3d-style kNN return plus the gathered neighbour coordinates:
    dists, idx [b, n, k]; nbrs [b, n, k, 3]."""

    dists: torch.Tensor
    idx: torch.Tensor
    nbrs: torch.Tensor


class KNNPlanes(NamedTuple):
    """kNN result as coordinate planes: idx, x, y, z are [b, n, k]; the
    planes are differentiable in `points`."""

    idx: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


class _CoordsGather(torch.autograd.Function):
    """Neighbour gather whose forward is the coordinate block the kNN kernel
    already wrote and whose backward is the scatter-add a gather would have
    (geoa3_tpu/ops/knn.py:_coords_gather)."""

    @staticmethod
    def forward(ctx, points, idx, precomputed):
        ctx.save_for_backward(idx)
        ctx.m = points.shape[1]
        return precomputed.clone()

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return scatter_kernel.scatter_rows(idx, ct, ctx.m), None, None


class _KNNGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.m = points.shape[1]
        return knn_kernel.gather_nbrs(points, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _scatter_back(idx, ct, ctx.m), None


def _scatter_back(idx, ct, m):
    """A row gather's backward: the scatter-add kernel; a bf16 cotangent (a
    bf16 victim's) is summed in float32 and rounded once, as the JAX
    package's TPU route sums it (geoa3_tpu/ops/grouping.py:56-77; bf16
    autograd through index_add_ would round at every add)."""
    if ct.dtype == torch.bfloat16:
        return scatter_kernel.scatter_rows(idx, ct.float(), m).to(ct.dtype)
    return scatter_kernel.scatter_rows(idx, ct, m)


def knn_gather(points, idx):
    """Gather neighbour features: points [b, m, c], idx [b, n, k] ->
    [b, n, k, c] (pytorch3d's `knn_gather`, reference Lib/loss_utils.py:58).
    The backward is the scatter-add kernel (3-channel or C-channel), summed
    in float32."""
    return _KNNGather.apply(points, idx)


def _knn_search(query, points, k: int):
    """(idx [b, n, k] int32, neighbour coordinates [b, n, k, 3] or None)."""
    if k == 1:
        d = pairwise_sqdist(query, points)
        return d.argmin(dim=-1, keepdim=True).to(torch.int32), None
    _, idx, nbrs = knn_kernel.knn(query.contiguous(), points.contiguous(), k)
    return idx, nbrs


def knn_points(query, points, k: int) -> KNNResult:
    """k nearest neighbours of `query` in `points`: query [b, n, 3], points
    [b, m, 3] -> KNNResult, ascending by squared distance, lowest index on
    ties (reference Lib/loss_utils.py:32-34).

    k == 1 is a distance matrix and an argmin, as in the JAX package; k > 1
    is the kNN kernel. The returned distances are recomputed from the
    gathered coordinates, so they are differentiable in both clouds; the
    kernel's own (expansion) distances are not returned."""
    idx, kernel_nbrs = _knn_search(query.detach(), points.detach(), k)
    if kernel_nbrs is not None:
        nbrs = _CoordsGather.apply(points, idx, kernel_nbrs)
    else:
        nbrs = knn_gather(points, idx)
    diff = query[:, :, None, :] - nbrs
    return KNNResult(dists=(diff * diff).sum(-1), idx=idx, nbrs=nbrs)


def knn_points_planes(query, points, k: int) -> KNNPlanes:
    """`knn_points` with the neighbours as three [b, n, k] coordinate planes
    (the TPU package's layout for elementwise math; here views of the same
    block)."""
    res = knn_points(query, points, k)
    return KNNPlanes(res.idx, res.nbrs[..., 0], res.nbrs[..., 1], res.nbrs[..., 2])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, points, idx):
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        c = points.shape[-1]
        return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, c))

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _scatter_back(idx, ct, ctx.n), None


def gather_rows(points, idx):
    """Row gather points [b, n, c], idx [b, s] -> [b, s, c] whose backward is
    the scatter-add kernel."""
    return _GatherRows.apply(points, idx)



def nn1_dual(adv, ori):
    """Both 1-NN directions at once: (a2o [b, n], o2a [b, m]) int32, lowest
    index on ties. Not differentiable."""
    return nn1_kernel.nn1_dual(adv.detach().contiguous(), ori.detach().contiguous())


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
        ct3 = ct[:, :3].transpose(1, 2)  # [b, m, 3], read through its strides
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
    -> [b] = mean_i (kappa_i - ref_i)^2 with kappa_i the mean over the
    mask's other members j of |unit(p_j - p_i) . n_i| from the direct
    difference (reference curvature_loss, Lib/loss_utils.py:84-97).
    Differentiable in `cloud` only: the kernel emits the gradient with the
    value, so the backward scales it by the per-instance cotangent."""
    return _CurvTerm.apply(
        cloud.contiguous(), normal.detach().contiguous(),
        ref.detach().contiguous(), mask, k,
    )


class _KnnKappa(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cloud, normal, k):
        kappa, mask = kappa_kernel.kappa_fwd(cloud, normal, k)
        ctx.save_for_backward(cloud, normal, mask)
        ctx.k = k
        return kappa

    @staticmethod
    def backward(ctx, g):
        cloud, normal, mask = ctx.saved_tensors
        grad = kappa_kernel.kappa_bwd(
            cloud, normal, mask, g.contiguous(), ctx.k, "direct"
        )
        return grad, None, None


def knn_kappa(cloud, normal, k: int):
    """Curvature proxy over the self-kNN neighbourhood: cloud, normal
    [b, n, 3] -> kappa [b, n], kappa_i = mean over the k nearest other
    points j of |unit(p_j - p_i) . n_i| (reference Lib/loss_utils.py:52-62).
    Differentiable in `cloud`: the forward kernel emits its selection mask
    and the backward kernel reads it. `normal` gets no gradient."""
    return _KnnKappa.apply(
        cloud.contiguous(), normal.detach().contiguous(), k
    )


class _KnnKappaFromMask(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cloud, normal, mask, k):
        ctx.save_for_backward(cloud, normal, mask)
        ctx.k = k
        return kappa_kernel.kappa_frommask(cloud, normal, mask, k)

    @staticmethod
    def backward(ctx, g):
        cloud, normal, mask = ctx.saved_tensors
        grad = kappa_kernel.kappa_bwd(
            cloud, normal, mask, g.contiguous(), ctx.k, "expansion"
        )
        return grad, None, None, None


def knn_kappa_from_mask(cloud, normal, mask, k: int):
    """Curvature proxy with a cached membership mask: cloud, normal
    [b, n, 3], mask [b, n, n] int8 (from `kappa_select_mask`) -> kappa
    [b, n] = sum_j mask_ij |unit(p_j - p_i) . n_i| / k, the self column adding
    exactly zero, radii from the distance expansion. Differentiable in
    `cloud`; `normal` and `mask` get no gradient."""
    return _KnnKappaFromMask.apply(
        cloud.contiguous(), normal.detach().contiguous(), mask, k
    )
