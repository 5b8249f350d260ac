"""Offset projection, per-point clipping, normal estimation, tangent jitter
(port of geoa3_tpu/attack/project.py; reference Attacker/geoA3_attack.py:59-98
and Lib/utility.py:33-149). All channel-last ([b, n, 3]).

Randomness is explicit: functions that draw take a `torch.Generator` on the
cloud's device. The 3x3 eigendecompositions are `torch.linalg.eigh`, outside
any kernel as in the JAX package. Eigenvectors are defined up to sign (and, on
flat patches, up to a rotation inside a degenerate eigenspace), so the tangent
jitter is reproducible only in distribution across libraries.
"""

from __future__ import annotations

from typing import Optional

import torch

from geoa3_tpu_torch import ops


def offset_proj(offset, ori_pc, ori_normal):
    """Project each offset onto the normal of its nearest ORIGINAL point
    (reference geoA3_attack.py:59-77). The reference's `condition_inner` is
    all zeros (:63), so the projection applies unconditionally, and the 1-NN
    is keyed on the OFFSET coordinates, not on the adversarial points (:65):
    both reproduced."""
    one_nn = ops.knn_points(offset, ori_pc, k=1)
    normal = ops.knn_gather(ori_normal, one_nn.idx)[:, :, 0, :]
    normal_len = (normal**2).sum(-1, keepdim=True).sqrt()
    unit = normal / (normal_len + 1e-6)
    return (offset * unit).sum(-1, keepdim=True) * unit


def find_offset(ori_pc, adv_pc):
    """Offsets relative to each adversarial point's nearest original point
    (reference geoA3_attack.py:79-85)."""
    one_nn = ops.knn_points(adv_pc, ori_pc, k=1)
    return adv_pc - ops.knn_gather(ori_pc, one_nn.idx)[:, :, 0, :]


def lp_clip(offset, cc_linf: float):
    """Rescale per-point offsets whose L2 norm exceeds cc_linf onto that
    sphere (reference geoA3_attack.py:88-98; an L2 ball per point despite the
    name)."""
    lengths = (offset**2).sum(-1, keepdim=True).sqrt()
    scaled = torch.where(
        lengths > 1e-6, offset / lengths * cc_linf, torch.zeros_like(offset)
    )
    return torch.where(lengths < cc_linf, offset, scaled)


def _randn(shape, like: torch.Tensor, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, device=like.device,
                       dtype=like.dtype)


def jitter_input(generator, like, sigma: float = 0.01, clip: float = 0.05):
    """Clamped Gaussian jitter shaped like `like` (reference
    Lib/utility.py:33-38)."""
    if not clip > 0:
        raise ValueError("clip must be positive")
    return (sigma * _randn(like.shape, like, generator)).clamp(-clip, clip)


_EIGH_CHUNK = 4096


def _eigh_batched(cov):
    """torch.linalg.eigh over [..., 3, 3] in chunks of 4096 matrices: on an
    H100 with torch 2.11 / CUDA 12.8, cuSOLVER's batched solver refuses a
    batch of 32768 (CUSOLVER_STATUS_INVALID_VALUE from
    cusolverDnXsyevBatched_bufferSize) and takes 8192; chunks are also no
    slower than one call."""
    flat = cov.reshape(-1, *cov.shape[-2:])
    if flat.shape[0] <= _EIGH_CHUNK:
        vals, vecs = torch.linalg.eigh(flat)
    else:
        vals, vecs = map(torch.cat, zip(
            *(torch.linalg.eigh(c) for c in flat.split(_EIGH_CHUNK))))
    return vals.reshape(cov.shape[:-1]), vecs.reshape(cov.shape)


def _local_covariance_eig(pc, k: int):
    """Eigendecomposition of each point's kNN covariance: pc [b, n, 3] ->
    (eigenvalues [b, n, 3] ascending, eigenvectors [b, n, 3, 3] as columns,
    centred neighbours [b, n, k, 3]). Shared by normal estimation and the
    tangent jitter (reference Lib/utility.py:40-149)."""
    nn_pts = ops.knn_points(pc, pc, k=k + 1).nbrs[:, :, 1:, :]
    centered = nn_pts - nn_pts.mean(dim=2, keepdim=True)
    cov = torch.einsum("bnkc,bnkd->bncd", centered, centered) / (k - 1)
    eigval, eigvec = _eigh_batched(cov)
    return eigval, eigvec, centered


def estimate_normal(pc, k: int):
    """Per-point normal: the smallest eigenvector of the local covariance,
    flipped to point away from the neighbours' centroid (reference
    Lib/utility.py:40-89)."""
    pc = pc.detach()
    _, eigvec, centered = _local_covariance_eig(pc, k)
    normal = eigvec[..., :, 0]
    sign = -torch.sign((normal * centered.sum(dim=2)).sum(-1, keepdim=True))
    return sign * normal


def estimate_normal_via_ori_normal(pc_adv, pc_ori, normal_ori, k: int):
    """Borrow or average normals from the k nearest original points
    (reference Lib/utility.py:91-108): a point that did not move (1-NN
    squared distance < 1e-6) copies the nearest normal; a moved point takes
    the renormalised mean of the k nearest."""
    res = ops.knn_points(pc_adv, pc_ori, k=k)
    normal_pts = ops.knn_gather(normal_ori, res.idx)
    avg = normal_pts.mean(dim=2)
    avg = avg / (torch.linalg.vector_norm(avg, dim=-1, keepdim=True) + 1e-12)
    unmoved = (res.dists[..., 0] < 1e-6)[..., None]
    return torch.where(unmoved, normal_pts[:, :, 0, :], avg)


def get_perpendicular_jitter(generator, vector, sigma: float = 0.01,
                             clip: float = 0.05):
    """Jitter perpendicular to `vector` by clamped cross products (reference
    Lib/utility.py:110-114, the "previous method")."""
    aux1 = sigma * _randn(vector.shape, vector, generator)
    aux2 = sigma * _randn(vector.shape, vector, generator)
    return torch.cross(vector, aux1, dim=-1).clamp(-clip, clip) + torch.cross(
        vector, aux2, dim=-1
    ).clamp(-clip, clip)


def perpendicular_gauss(generator, b: int, n: int, like: torch.Tensor) -> tuple:
    """The tangent jitter's two standard normal draws, [b, n, 1] each, in
    order."""
    return _randn((b, n, 1), like, generator), _randn((b, n, 1), like, generator)


def estimate_perpendicular(generator, pc, k: int, sigma: float = 0.01,
                           clip: float = 0.05, gauss=None):
    """Tangent-plane jitter -> [b, n, 3]: the two largest eigenvectors of the
    local covariance, each scaled by a Gaussian and clamped (reference
    Lib/utility.py:116-149). `gauss` (a pair of [b, n, 1] standard normal
    draws) replaces the generator's draws."""
    pc = pc.detach()
    _, eigvec, _ = _local_covariance_eig(pc, k)
    v1 = eigvec[..., :, 2]  # largest
    v2 = eigvec[..., :, 1]  # second largest
    b, n, _ = pc.shape
    if gauss is None:
        gauss = perpendicular_gauss(generator, b, n, pc)
    a1, a2 = (sigma * g.to(device=pc.device, dtype=pc.dtype) for g in gauss)
    return (v1 * a1).clamp(-clip, clip) + (v2 * a2).clamp(-clip, clip)
