"""Model registry and eval-closure factory (port of
geoa3_tpu/models/registry.py)."""

from __future__ import annotations

import copy
from typing import Callable, Optional

import torch

from geoa3_tpu_torch.device import float32_exact
from geoa3_tpu_torch.models.pointnet import PointNet
from geoa3_tpu_torch.models.pointnetpp import (
    PointNet2ClassificationMSG,
    PointNet2ClassificationSSG,
)

ARCHS = ("PointNet", "PointNetPP", "PointNetPP_MSG")


def build_model(
    arch: str, classes: int = 40, npoint: int = 1024, device="cuda"
) -> torch.nn.Module:
    """Build a victim by reference arch name (reference main_attack.py:135-142),
    in eval mode, on `device`. TF32 is turned off (device.float32_exact)."""
    float32_exact()
    if arch == "PointNet":
        return PointNet(classes=classes, npoint=npoint).to(device).eval()
    if arch in ("PointNetPP", "PointNetPP_MSG"):
        cls = (PointNet2ClassificationSSG if arch == "PointNetPP"
               else PointNet2ClassificationMSG)
        return cls(use_xyz=True, use_normal=False, classes=classes).to(device).eval()
    raise ValueError(f"Not support such arch: {arch}")


def make_eval_fn(model: torch.nn.Module, dtype: Optional[torch.dtype] = None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """logits_fn(pc [b, n, 3]) -> [b, classes] with the victim in eval mode
    and its parameters frozen (reference main_attack.py:146). Gradients flow
    to the input only.

    `dtype=torch.bfloat16` runs a bf16 twin of the victim instead, as the
    JAX package's `make_eval_fn(..., dtype=jnp.bfloat16)` does: a frozen
    copy with every floating parameter and BatchNorm statistic cast to
    bf16, fed the cloud cast to bf16, its logits returned as float32
    (models/pointnet.py says what it computes). `model` itself is left as
    it is, so a float32 judge beside it keeps its weights and fold caches.
    PointNet only: the PointNet++ victims' bf16 route (the grouped MLP's
    single-pass mode) is ROADMAP.md's "PointNet++ bf16" item."""
    model.eval()
    model.requires_grad_(False)
    if dtype is None:
        def logits_fn(pc: torch.Tensor) -> torch.Tensor:
            return model(pc)

        return logits_fn
    if dtype != torch.bfloat16:
        raise ValueError(f"a victim runs in float32 or bfloat16, not {dtype}")
    if not isinstance(model, PointNet):
        raise NotImplementedError(
            f"a bf16 {type(model).__name__} is not ported yet (see ROADMAP.md, "
            "PointNet++ bf16)")
    twin = copy.deepcopy(model).to(dtype).eval().requires_grad_(False)

    def logits_bf16(pc: torch.Tensor) -> torch.Tensor:
        return twin(pc.to(dtype)).float()

    return logits_bf16


def bf16_grad_healthcheck(logits_fn: Callable[[torch.Tensor], torch.Tensor],
                          b: int, n: int, device="cuda") -> bool:
    """True iff d(sum logits)/d(input) at a random [b, n, 3] cloud on
    `device` is not all zero (the JAX package's guard, run by its CLI at the
    run's padded shape before a bf16 attack: a zero input gradient makes
    every attack step a no-op, so the caller refuses the mode)."""
    gen = torch.Generator(device=device).manual_seed(17)
    x = torch.randn(b, n, 3, generator=gen, device=device).requires_grad_(True)
    out = logits_fn(x).sum()
    if not out.requires_grad:
        return False
    (g,) = torch.autograd.grad(out, x, allow_unused=True)
    return g is not None and bool(g.abs().max() > 0)
