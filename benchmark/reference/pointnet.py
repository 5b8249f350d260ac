"""PointNet classification (Qi et al., CVPR 2017, arXiv:1612.00593) in plain
PyTorch, eval mode, from a state dict in the reference GeoA3 victim's names
(Model/PointNet.py): input T-Net(3) and feature T-Net(64), each
64/128/1024 point layers, a max-pool and a 512/256/K head; conv 64-64-64-128;
conv5 a kernel-3 convolution to 1024 with padding 1 over the point order; a
max-pool; a 512/256/classes head (dropout is the identity in eval mode).
BatchNorm in eval mode: (x - mean) / sqrt(var + eps) * weight + bias, eps
the configuration's (configs/pointnet.json: 1e-3 on the point side, 1e-5 in
the classifier head). The widths are those of the weights, which the
harness draws in the configuration's shapes.

Everything runs in the dtype of the state dict's tensors. Channel-last:
x [b, n, 3] -> logits [b, classes].
"""

from __future__ import annotations

import torch

def _bn(x, p, name, eps):
    return ((x - p[f"{name}.running_mean"])
            / torch.sqrt(p[f"{name}.running_var"] + eps)
            * p[f"{name}.weight"] + p[f"{name}.bias"])


def _dense(x, p, name):
    w = p[f"{name}.weight"]
    if w.dim() == 3:
        w = w[..., 0]
    return x @ w.t() + p[f"{name}.bias"]


def _tnet(x, p, pre, K, eps):
    h = torch.relu(_bn(_dense(x, p, f"{pre}.conv1"), p, f"{pre}.bn1", eps))
    h = torch.relu(_bn(_dense(h, p, f"{pre}.conv2"), p, f"{pre}.bn2", eps))
    h = torch.relu(_bn(_dense(h, p, f"{pre}.conv3"), p, f"{pre}.bn3", eps))
    h = h.amax(dim=1)
    h = torch.relu(_bn(_dense(h, p, f"{pre}.fc1"), p, f"{pre}.bn4", eps))
    h = torch.relu(_bn(_dense(h, p, f"{pre}.fc2"), p, f"{pre}.bn5", eps))
    return _dense(h, p, f"{pre}.fc3").reshape(-1, K, K)


def _conv5(x, p, c5):
    """The configuration's convolution over the point axis (kernel 3,
    padding 1): x [b, n, c] -> [b, n, width] as one product of the shifted
    copies."""
    w = p["conv5.weight"]  # [cout, cin, kernel]
    k, pad = c5["kernel"], c5["padding"]
    z = x.new_zeros(x.shape[0], pad, x.shape[2])
    xp = torch.cat([z, x, z], dim=1)
    n = xp.shape[1] - k + 1
    cols = torch.cat([xp[:, t:t + n] for t in range(k)], dim=-1)  # [b, n, k c]
    wm = w.permute(2, 1, 0).reshape(-1, w.shape[0])  # [k c, cout]
    return cols @ wm + p["conv5.bias"]


def logits(cfg: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    eps, fc_eps = cfg["conv_bn_eps"], cfg["fc_bn_eps"]
    nconv, nhead = len(cfg["conv"]), len(cfg["head"])
    feat = x @ _tnet(x, p, "input_transform", 3, eps)
    for i in range(1, nconv + 1):
        feat = torch.relu(_bn(_dense(feat, p, f"conv{i}"), p, f"bn{i}", eps))
        if i == 2:
            feat = feat @ _tnet(feat, p, "feature_transform", feat.shape[-1], eps)
    feat = torch.relu(_bn(_conv5(feat, p, cfg["conv5"]), p, f"bn{nconv + 1}", eps))
    feat = feat.amax(dim=1)
    for i in range(1, nhead + 1):
        feat = torch.relu(_bn(_dense(feat, p, f"fc{i}"), p, f"bn{nconv + 1 + i}", fc_eps))
    return _dense(feat, p, f"fc{nhead + 1}")
