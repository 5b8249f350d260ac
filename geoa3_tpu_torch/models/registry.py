"""Model registry and eval-closure factory (port of
geoa3_tpu/models/registry.py)."""

from __future__ import annotations

from typing import Callable

import torch

from geoa3_tpu_torch.models.pointnet import PointNet

ARCHS = ("PointNet", "PointNetPP", "PointNetPP_MSG")


def build_model(
    arch: str, classes: int = 40, npoint: int = 1024, device="cuda"
) -> torch.nn.Module:
    """Build a victim by reference arch name (reference main_attack.py:135-142),
    in eval mode, on `device`."""
    if arch == "PointNet":
        return PointNet(classes=classes, npoint=npoint).to(device).eval()
    if arch in ARCHS:
        raise NotImplementedError(
            f"{arch} is not ported yet (PointNet++ is queued in ROADMAP.md)"
        )
    raise ValueError(f"Not support such arch: {arch}")


def make_eval_fn(model: torch.nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """logits_fn(pc [b, n, 3]) -> [b, classes] with the victim in eval mode
    and its parameters frozen (reference main_attack.py:146). Gradients flow
    to the input only."""
    model.eval()
    model.requires_grad_(False)

    def logits_fn(pc: torch.Tensor) -> torch.Tensor:
        return model(pc)

    return logits_fn
