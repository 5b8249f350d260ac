"""Victim classifiers of the port."""

from geoa3_tpu_torch.models.pointnet import PointNet, TransformNet
from geoa3_tpu_torch.models.registry import (
    ARCHS,
    bf16_grad_healthcheck,
    build_model,
    make_eval_fn,
)

__all__ = ["ARCHS", "PointNet", "TransformNet", "bf16_grad_healthcheck",
           "build_model", "make_eval_fn"]
