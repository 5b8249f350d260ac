"""Geometric attack losses (port of geoa3_tpu/losses.py).

Channel-last clouds [b, n, 3]; per-batch losses return [b]. Every distance is
a squared Euclidean distance (pytorch3d's kNN convention, reference
Lib/loss_utils.py:28-50) unless a function takes the square root itself. The
attack's hot path does not call the Chamfer, Hausdorff and curvature
functions here: attack/engine.py:forward_losses computes the same values
from one dual 1-NN pass.
"""

from __future__ import annotations

import math

import torch

from geoa3_tpu_torch import ops


def _l2normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) (reference `_normalize`, Lib/utility.py:30-31)."""
    return v / torch.linalg.vector_norm(v, dim=dim, keepdim=True).clamp_min(eps)


def norm_l2_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor) -> torch.Tensor:
    """Total squared L2 between clouds -> [b]. (reference Lib/loss_utils.py:25-26)"""
    return ((adv_pc - ori_pc) ** 2).sum(dim=(1, 2))


def chamfer_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor) -> torch.Tensor:
    """Two-sided Chamfer: mean squared 1-NN distance both ways -> [b]. (:28-35)"""
    a2o = ops.knn_points(adv_pc, ori_pc, k=1).dists[..., 0]
    o2a = ops.knn_points(ori_pc, adv_pc, k=1).dists[..., 0]
    return a2o.mean(dim=-1) + o2a.mean(dim=-1)


def pseudo_chamfer_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor) -> torch.Tensor:
    """One-sided (adv -> ori) Chamfer -> [b]. (:37-43)"""
    return ops.knn_points(adv_pc, ori_pc, k=1).dists[..., 0].mean(dim=-1)


def hausdorff_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor) -> torch.Tensor:
    """One-sided Hausdorff: max over adv points of the squared 1-NN distance
    -> [b]. (:45-50)"""
    return ops.knn_points(adv_pc, ori_pc, k=1).dists[..., 0].amax(dim=-1)


def get_kappa_ori(pc: torch.Tensor, normal: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Per-point curvature proxy on the clean cloud -> [b, n]
    (reference Lib/loss_utils.py:52-62): mean over the k nearest other points
    of |<normalize(q_i - p), n_p>| with the point's own normal."""
    return ops.knn_kappa(pc, normal, k)


def _nbr_normal_dots(pc: torch.Tensor, normal: torch.Tensor, k: int) -> torch.Tensor:
    """mean over the k nearest other points of |<normalize(q_i - p), n_p>|
    through the kNN kernel's gathered neighbours -> [b, n]."""
    nn_pts = ops.knn_points(pc, pc, k=k + 1).nbrs[:, :, 1:, :]
    vectors = _l2normalize(nn_pts - pc[:, :, None, :])
    return (vectors * normal[:, :, None, :]).sum(-1).abs().mean(dim=-1)


def get_kappa_adv(adv_pc, ori_pc, ori_normal, k: int = 2):
    """Curvature proxy on the adversarial cloud -> (kappa [b, n], normal
    [b, n, 3]); each point borrows the normal of its nearest original point
    (:64-82)."""
    one_nn = ops.knn_points(adv_pc, ori_pc, k=1)
    normal = ops.knn_gather(ori_normal, one_nn.idx)[:, :, 0, :]
    return _nbr_normal_dots(adv_pc, normal, k), normal


def curvature_loss(adv_pc, ori_pc, adv_kappa, ori_kappa) -> torch.Tensor:
    """Mean squared difference between adv kappa and its 1-NN ori kappa
    -> [b]. (:84-97)"""
    idx = ops.knn_points(adv_pc, ori_pc, k=1).idx[..., 0].long()
    return ((adv_kappa - torch.gather(ori_kappa, 1, idx)) ** 2).mean(dim=-1)


def _gather_cols(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [b, n], idx [b, n, k] -> values[b, idx] as [b, n, k]."""
    b, n, k = idx.shape
    return torch.gather(values, 1, idx.reshape(b, n * k).long()).reshape(b, n, k)


def displacement_loss(adv_pc, ori_pc, k: int = 16) -> torch.Tensor:
    """Local smoothness of the displacement field -> [b, n]. (:99-107)"""
    ori = ori_pc.detach()
    inter_idx = ops.knn_points(ori, ori, k=k + 1).idx[..., 1:]
    theta = ((adv_pc - ori_pc) ** 2).sum(-1)
    return ((_gather_cols(theta, inter_idx) - theta[..., None]) ** 2).mean(dim=-1)


def corresponding_normal_loss(adv_pc, normal, k: int = 2) -> torch.Tensor:
    """|<normalised neighbour offsets, given normal>| averaged over k
    neighbours -> [b, n]. (:109-117)"""
    return _nbr_normal_dots(adv_pc, normal, k)


def repulsion_loss(pc, k: int = 4, h: float = 0.03) -> torch.Tensor:
    """Repulsion on squared kNN distances with Gaussian falloff -> [b, n].
    (:119-123)"""
    dis = ops.knn_points(pc, pc, k=k + 1).dists[..., 1:]
    return -(dis * torch.exp(-(dis**2) / (h**2))).mean(dim=-1)


def distance_kmean_loss(pc, k: int) -> torch.Tensor:
    """|mean kNN distance of p - mean kNN distance of its neighbours| ->
    [b, n], on non-squared distances (the reference takes the root, :125-133)."""
    res = ops.knn_points(pc, pc, k=k + 1)
    dis_mean = torch.sqrt(res.dists + 1e-12)[..., 1:].mean(dim=-1)
    dis_mean_k = _gather_cols(dis_mean, res.idx[..., 1:])
    return (dis_mean[..., None] - dis_mean_k).abs().mean(dim=-1)


def knn_smoothing_loss(adv_pc, k: int, threshold_coef: float = 1.05) -> torch.Tensor:
    """Penalise points whose mean squared kNN distance exceeds
    mean + coef * std -> [b] (:135-149). torch.std's default is the
    reference's Bessel-corrected estimate."""
    knn_dis = ops.knn_points(adv_pc, adv_pc, k=k + 1).dists[..., 1:].mean(dim=-1)
    mean = knn_dis.mean(dim=-1, keepdim=True)
    std = knn_dis.std(dim=-1, keepdim=True)
    cond = (knn_dis > mean + threshold_coef * std).to(knn_dis.dtype)
    return (knn_dis * cond).mean(dim=-1)


def uniform_loss(
    adv_pc: torch.Tensor,
    percentages: tuple = (0.004, 0.006, 0.008, 0.010, 0.012),
    radius: float = 1.0,
    k: int = 2,
) -> torch.Tensor:
    """Multi-scale point-spacing uniformity -> scalar (:151-190; the
    reference version fails on a missing import, this is the JAX package's
    repaired arithmetic). FPS picks 5% of the points as disk seeds; at each
    percentage scale a ball query groups the seeds' neighbourhoods, and the
    local kNN spacing inside each group is held against the spacing of a
    uniform disk. Differentiable in `adv_pc` through the grouped
    coordinates."""
    b, n, _ = adv_pc.shape
    npoint = int(n * 0.05)
    seed_idx = ops.furthest_point_sampling(adv_pc, npoint)
    new_xyz = ops.gather_points(adv_pc, seed_idx).detach()  # [b, npoint, 3]

    loss = 0.0
    for p in percentages:
        p = p * 4
        nsample = int(n * p)
        r = math.sqrt(p * radius)
        expect_len = math.sqrt(math.pi * (radius**2) * p / nsample)

        idx = ops.ball_query(r, nsample, adv_pc, new_xyz)  # [b, npoint, nsample]
        grouped = ops.group_points(adv_pc, idx).reshape(b * npoint, nsample, 3)
        inter = ops.knn_points(grouped, grouped, k=k + 1)
        uniform_dis = torch.sqrt(inter.dists[..., 1:].abs() + 1e-12).mean(dim=-1)
        uniform_dis = (uniform_dis - expect_len) ** 2 / (expect_len + 1e-12)
        loss = loss + uniform_dis.mean() * math.pow(p * 100, 2)
    return loss / len(percentages)
