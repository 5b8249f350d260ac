"""Ball query with the reference's padding semantics (port of
geoa3_tpu/ops/ball_query.py)."""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.kernels import ballquery_group_kernel


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """xyz [b, n, 3] points, new_xyz [b, m, 3] centres -> idx [b, m, nsample]
    int32 (reference ball_query_gpu.cu:9-54): strictly d^2 < r^2, the first
    `nsample` hits in ascending index order, padded with the first hit; a
    centre with no hit gets index 0 in every slot; `nsample` may exceed n.
    Not differentiable. The fused query+group kernel with its gathers
    compiled out; bf16 points (the bf16 victim's) take `ball_query_bf16`."""
    if xyz.dtype == torch.bfloat16:
        return ball_query_bf16(radius, nsample, xyz, new_xyz)
    return ballquery_group_kernel.ball_query(xyz, new_xyz, radius, nsample)


def _sum3(v: torch.Tensor) -> torch.Tensor:
    """The last axis's three entries summed in float32 in index order."""
    v = v.float()
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def pairwise_sqdist_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """geoa3_tpu/ops/knn.py:pairwise_sqdist on bf16 points a [b, m, 3] and
    b [b, n, 3], op by op as XLA's CPU runs it -> [b, m, n] float32: each
    square rounded to bf16 and |a|^2, |b|^2 their float32 sums rounded once
    to bf16 (a bf16 reduction); ab the float32 sum of the exact products, x
    then y then z; |a|^2 + |b|^2 in bf16, lifted to float32 against 2 ab
    (jnp's promotion), clamped at 0."""
    a2 = _sum3(a * a).to(torch.bfloat16)
    b2 = _sum3(b * b).to(torch.bfloat16)
    ab = _sum3(a.float()[:, :, None, :] * b.float()[:, None, :, :])
    return torch.clamp_min((a2[:, :, None] + b2[:, None, :]).float() - 2.0 * ab, 0.0)


def ball_query_bf16(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor) -> torch.Tensor:
    """`ball_query` on bf16 points, as the JAX package runs it there: its
    fused query refuses bf16 coordinates (geoa3_tpu/models/pointnetpp.py:
    _fused_query_group_ok), so the composed query (geoa3_tpu/ops/
    ball_query.py) on `pairwise_sqdist_bf16`'s distances, compared with r^2
    in float32. Plain PyTorch on both devices, as XLA's ops are in the JAX
    package; a point near the radius falls on the side these roundings
    put it."""
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    hit = pairwise_sqdist_bf16(new_xyz, xyz) < ballquery_group_kernel._r2(radius)
    return ballquery_group_kernel.first_hits(hit, nsample)
