"""Geometric attack losses of the main path (port of geoa3_tpu/losses.py).

Channel-last clouds [b, n, 3]; per-batch losses return [b]. The Chamfer,
Hausdorff and curvature terms of the attack are fused into
attack/engine.py:forward_losses; the other losses of geoa3_tpu/losses.py are
queued in ROADMAP.md.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch import ops


def norm_l2_loss(adv_pc: torch.Tensor, ori_pc: torch.Tensor) -> torch.Tensor:
    """Total squared L2 between clouds -> [b]. (reference Lib/loss_utils.py:25-26)"""
    return ((adv_pc - ori_pc) ** 2).sum(dim=(1, 2))


def get_kappa_ori(pc: torch.Tensor, normal: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Per-point curvature proxy on the clean cloud -> [b, n]
    (reference Lib/loss_utils.py:52-62): mean over the k nearest other points
    of |<normalize(q_i - p), n_p>| with the point's own normal."""
    return ops.knn_kappa(pc, normal, k)
