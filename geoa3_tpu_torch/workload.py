"""The main path's workload, made from seeds: the victim, the batch, the config.

The untargeted GeoA3 attack on the 1024-point, 40-class PointNet that
bench.py measures for the JAX package (bench.py:101-151): CE + two-sided
Chamfer 1.0 + Hausdorff 0.1 + curvature 1.0 with k=16, Adam at lr 0.01, the
curvature mask rebuilt every 10 steps. chip_smoke.py and profile_step.py
drive it; weights are random (no checkpoint ships with the repo).
"""

from __future__ import annotations

import numpy as np
import torch

from geoa3_tpu_torch.attack import AttackConfig
from geoa3_tpu_torch.data.synthetic import sample_shape
from geoa3_tpu_torch.models import build_model, make_eval_fn

BATCH = 32  # clouds per attack batch (bench.py's headline batch)
NPOINT = 1024  # points per cloud
CLASSES = 40  # ModelNet40
KNN = 16  # curvature neighbours


def random_pointnet(classes: int = CLASSES, npoint: int = NPOINT, seed: int = 0,
                    device="cuda"):
    """(model, logits_fn): PointNet with its default random weights and
    non-trivial BatchNorm statistics, all drawn from `seed`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model("PointNet", classes=classes, npoint=npoint,
                            device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm1d):
                c = mod.num_features
                mod.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.running_var.copy_(0.5 + torch.rand(c, generator=g))
    model = model.to(device)
    return model, make_eval_fn(model)


def synthetic_batch(b: int = BATCH, n: int = NPOINT, seed: int = 0, device="cuda"):
    """(clouds [b, n, 3], normals [b, n, 3]) of the ten synthetic shape
    classes in turn, unit-sphere normalised."""
    rng = np.random.RandomState(seed)
    pcs, nrms = zip(*(sample_shape(i % 10, n, rng) for i in range(b)))
    return (torch.from_numpy(np.stack(pcs)).to(device),
            torch.from_numpy(np.stack(nrms)).to(device))


def main_path_config(binary_max_steps: int = 2, iter_max_steps: int = 50,
                     refresh: int = 10, npoint: int = NPOINT) -> AttackConfig:
    """The default attack, cut to `binary_max_steps` x `iter_max_steps`."""
    return AttackConfig(
        attack_label="Untarget", classes=CLASSES, npoint=npoint,
        binary_max_steps=binary_max_steps, iter_max_steps=iter_max_steps,
        cls_loss_type="CE", dis_loss_type="CD", dis_loss_weight=1.0,
        hd_loss_weight=0.1, curv_loss_weight=1.0, curv_loss_knn=KNN,
        curv_knn_refresh_every=refresh,
    )
