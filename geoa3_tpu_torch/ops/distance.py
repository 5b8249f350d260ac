"""Squared pairwise distances, shared by the kernels' plain versions and ops."""

from __future__ import annotations

import torch


def sqnorm3(a: torch.Tensor) -> torch.Tensor:
    """(x*x + y*y) + z*z over the last axis of [..., 3], one rounding a step."""
    return a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max((|a_i|^2 + |b_j|^2) - 2 a_i.b_j, 0): a [..., n, 3], b [..., m, 3]
    -> [..., n, m].

    The expansion of geoa3_tpu/ops/knn.py:pairwise_sqdist. The inner product
    is written out per coordinate rather than as a matrix product, so every
    product and sum is rounded on its own in a fixed order: the CUDA kernels
    compute the same expression the same way and select bitwise the same
    neighbours.
    """
    a2 = sqnorm3(a)
    b2 = sqnorm3(b)
    ab = (
        a[..., :, None, 0] * b[..., None, :, 0]
        + a[..., :, None, 1] * b[..., None, :, 1]
        + a[..., :, None, 2] * b[..., None, :, 2]
    )
    d = a2[..., :, None] + b2[..., None, :] - 2.0 * ab
    return d.clamp_min(0.0)
