"""PointNet++ MSG classification (Qi et al., NeurIPS 2017, arXiv:1706.02413)
in plain PyTorch, eval mode, from a state dict in the reference names
(Model/PointNetPP_msg.py, pointnet2_ops/pointnet2_modules.py).

The levels, widths and BatchNorm eps are the configuration's
(configs/pointnetpp_msg.json: SA1 512 centres, radii 0.1/0.2/0.4 with
16/32/128 samples and shared MLPs 32-32-64, 64-64-128, 64-96-128; SA2 128
centres, radii 0.2/0.4/0.8 with 32/64/128 samples and MLPs 64-64-128,
128-128-256, 128-128-256 over 3 + 320 inputs; GroupAll over 3 + 640 inputs
with 256-512-1024; the head 512/256/classes, the first two Linear layers
without bias); the widths of each layer are those of its weights, which
the harness draws in the configuration's shapes. With use_xyz the grouped
coordinates relative to their centre come first in a layer's input
(GroupAll: the absolute coordinates); each scale ends in a max over its
samples.

Selections (FPS, ball queries) are taken on the float32 cloud
(geometry.py) by `select`, which takes many clouds at once (FPS is a loop of
dependent rounds, so its cost is per call, not per cloud); `logits` computes
the values in the dtype of the state dict.
"""

from __future__ import annotations

import torch

from benchmark import arch
from benchmark.reference import geometry as G


def _bn(x, p, name, eps):
    return ((x - p[f"{name}.running_mean"]) / torch.sqrt(p[f"{name}.running_var"] + eps)
            * p[f"{name}.weight"] + p[f"{name}.bias"])


def _shared_mlp(x, p, pre, eps):
    j = 0
    while f"{pre}.{3 * j}.weight" in p:
        x = torch.relu(_bn(x @ p[f"{pre}.{3 * j}.weight"][:, :, 0, 0].t(), p,
                           f"{pre}.{3 * j + 1}", eps))
        j += 1
    return x


def select(cfg: dict, x32: torch.Tensor) -> list:
    """The selections of every level for clouds x32 [b, n, 3] float32:
    [(fps idx [b, m], [ball idx [b, m, ns] a scale]) a level], in the
    coordinates of the level's input (SA2's are indices into SA1's
    centres)."""
    sel, xyz = [], x32
    for lv in arch.msg_levels(cfg):
        idx = G.fps(xyz, lv["npoint"])
        new = G.gather_pts(xyz, idx)
        sel.append((idx, [G.ball_query(xyz, new, r, ns)
                          for r, ns in zip(lv["radii"], lv["nsamples"])]))
        xyz = new
    return sel


def logits(cfg: dict, p: dict, x: torch.Tensor, sel=None) -> torch.Tensor:
    """x [b, n, 3] -> [b, classes]; `sel` from `select` on x's float32
    values (made here when None)."""
    eps = cfg["bn_eps"]
    if sel is None:
        sel = select(cfg, x.float())
    xyz, feats = x, None
    for i, (idx, balls) in enumerate(sel):
        new = G.gather_pts(xyz, idx)
        outs = []
        for s, bq in enumerate(balls):
            gx = G.gather_pts(xyz, bq) - new[:, :, None, :]
            h = gx if feats is None else torch.cat([gx, G.gather_pts(feats, bq)], -1)
            outs.append(_shared_mlp(h, p, f"SA_modules.{i}.mlps.{s}", eps).amax(dim=2))
        xyz, feats = new, torch.cat(outs, -1)
    h = _shared_mlp(torch.cat([xyz, feats], -1), p, "SA_modules.2.mlps.0", eps).amax(dim=1)
    h = torch.relu(_bn(h @ p["fc_layer.0.weight"].t(), p, "fc_layer.1", eps))
    h = torch.relu(_bn(h @ p["fc_layer.3.weight"].t(), p, "fc_layer.4", eps))
    return h @ p["fc_layer.7.weight"].t() + p["fc_layer.7.bias"]


def take(sel: list, rows) -> list:
    """The selections of some clouds (a slice or index tensor of rows)."""
    return [(idx[rows], [bq[rows] for bq in balls]) for idx, balls in sel]
