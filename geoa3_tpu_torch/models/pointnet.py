"""PointNet victim classifier (port of geoa3_tpu/models/pointnet.py).

Module and parameter names are those of the reference Model/PointNet.py, so
a reference state_dict loads as it is (models/convert.py). The public layout
is channel-last like the JAX package: the model takes [b, n, 3] clouds, and
every 1x1 conv is applied as a dense layer over the channel axis.

Parity notes (reference Model/PointNet.py):
  * 3x3 input T-Net -> conv1/2 -> 64x64 feature T-Net -> conv3/4/5 -> global
    max-pool -> FC 512/256/classes with dropout 0.3 (:96-160);
  * conv5 is a real kernel-3 convolution with padding 1 (:110);
  * conv-side BatchNorms (all of the T-Net's) use eps 1e-3, the two FC-side
    ones eps 1e-5 (:59,100,112-122);
  * the T-Net's fc3 starts at the identity transform (:93-94).

In eval mode the three global pools (input T-Net conv3, feature T-Net
conv3, conv5) run through the fused pool kernel with the BatchNorm folded
into the weights and the ReLU applied after the pool, as
geoa3_tpu/models/pointnet.py:_fused_pool does.

In train mode (`model.train()`, the trainer's; geoa3_tpu/models/pointnet.py:
131-240) the pools run unfused, as the JAX model's `_pool_fusable` says in
training: the conv, the train-mode BatchNorm (models/layers.py: batch
statistics, flax's running-statistics rule), the ReLU and a max over the
points (`amax`, whose backward splits ties as `jnp.max`'s does). The two
dropouts (0.3) draw from the `generator` passed to `forward`, or take the
`keep` masks given, and `forward` returns (logits, feature transform
[b, 64, 64]) for the orthogonality penalty. No kernel of ours runs in
training.

`point_mask` [b, n] bool excludes padded points from the three global max
pools, for clouds that a defense shrank and padded back to n (defense.py).
As in the JAX model (`_pool_fusable` is False under a mask), a masked
forward does not take the fused pool: it runs the conv, the BatchNorm and
the ReLU, then a max over the kept points. conv5's padded rows are zeroed
first, so its kernel of 3 sees the boundary a shrunken cloud would. The JAX
model's `return_idx` (the critical-point indices) is used nowhere outside
that model and is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geoa3_tpu_torch.models.layers import batch_norm, dropout
from geoa3_tpu_torch.ops.kernels.pool_matmul_kernel import pool_affine_max

CONV_BN_EPS = 1e-3
FC_BN_EPS = 1e-5
DROPOUT = 0.3


def _dense(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """Channel-last application of a Linear or kernel-1 Conv1d."""
    w = layer.weight
    if w.dim() == 3:
        w = w[..., 0]
    return F.linear(x, w, layer.bias)


def _folded(conv: nn.Conv1d, bn: nn.BatchNorm1d):
    """(w3 [taps, cin, cout], bias [cout], w3t [taps, cout, cin]): the eval
    BatchNorm folded into the conv. The victim is frozen, so the fold is kept
    on the conv and made again only when one of its sources was moved or
    changed in place (a new storage or a new version counter: the
    optimiser's step and the train-mode BatchNorm update in place)."""
    srcs = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
            bn.running_var)
    key = (conv.weight.device,) + tuple((t.data_ptr(), t._version) for t in srcs)
    cached = getattr(conv, "_fold", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            s = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
            w3 = (conv.weight.permute(2, 1, 0) * s).contiguous()
            b = ((conv.bias - bn.running_mean) * s + bn.bias).contiguous()
            cached = (key, w3, b, w3.transpose(1, 2).contiguous())
        conv._fold = cached
    return cached[1:]


def _fused_pool(x: torch.Tensor, conv: nn.Conv1d, bn: nn.BatchNorm1d):
    """relu(max_n(bn(conv(x)))) through the pool kernel: x [b, n, cin] ->
    [b, cout]. The eval BatchNorm folds into the conv; ReLU commutes with the
    max and is applied after it."""
    w3, b, w3t = _folded(conv, bn)
    return torch.relu(pool_affine_max(x, w3, b, w3t))


def _pool(x, conv, bn, training: bool, point_mask=None):
    """relu(bn(conv(x))) from x [b, n, cin], max-pooled over the points ->
    [b, cout]. In eval mode without a mask, the fused pool kernel. Otherwise
    unfused: a kernel-3 conv runs over the point axis with padding 1
    (F.conv1d), the BatchNorm is train-mode in training, and the max skips
    the points where point_mask [b, n] is False."""
    if not training and point_mask is None:
        return _fused_pool(x, conv, bn)
    if conv.kernel_size[0] == 1:
        h = _dense(x, conv)
    else:
        h = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                     padding=conv.padding).transpose(1, 2)
    h = torch.relu(batch_norm(h, bn, training))
    if point_mask is not None:
        h = torch.where(point_mask[..., None], h, torch.finfo(h.dtype).min)
    return h.amax(dim=1)


class TransformNet(nn.Module):
    """KxK spatial/feature transform net (reference Model/PointNet.py:56-94)."""

    def __init__(self, K: int = 3):
        super().__init__()
        self.K = K
        self.conv1 = nn.Conv1d(K, 64, 1)
        self.conv2 = nn.Conv1d(64, 128, 1)
        self.conv3 = nn.Conv1d(128, 1024, 1)
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, K * K)
        for i, c in enumerate((64, 128, 1024, 512, 256), start=1):
            setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=CONV_BN_EPS))
        self.reset_transform()

    def reset_transform(self) -> None:
        """fc3 at the identity transform: zero weight, identity bias (the JAX
        model's `_identity_bias`, reference :93-94)."""
        with torch.no_grad():
            self.fc3.weight.zero_()
            self.fc3.bias.copy_(torch.eye(self.K).reshape(-1))

    def forward(self, x: torch.Tensor, point_mask=None) -> torch.Tensor:
        """x [b, n, K] -> [b, K, K]; the pool skips the points where
        `point_mask` [b, n] is False."""
        t = self.training
        h = torch.relu(batch_norm(_dense(x, self.conv1), self.bn1, t))
        h = torch.relu(batch_norm(_dense(h, self.conv2), self.bn2, t))
        h = _pool(h, self.conv3, self.bn3, t, point_mask)
        h = torch.relu(batch_norm(_dense(h, self.fc1), self.bn4, t))
        h = torch.relu(batch_norm(_dense(h, self.fc2), self.bn5, t))
        h = _dense(h, self.fc3)
        return h.reshape(h.shape[0], self.K, self.K)


class PointNet(nn.Module):
    """PointNet classifier: [b, n, 3] -> logits [b, classes]; in train mode
    (logits, feature transform [b, 64, 64])."""

    def __init__(self, classes: int = 40, npoint: int = 1024):
        super().__init__()
        self.classes = classes
        self.npoint = npoint  # informational, as the reference ctor argument
        self.input_transform = TransformNet(3)
        self.feature_transform = TransformNet(64)
        self.conv1 = nn.Conv1d(3, 64, 1)
        self.conv2 = nn.Conv1d(64, 64, 1)
        self.conv3 = nn.Conv1d(64, 64, 1)
        self.conv4 = nn.Conv1d(64, 128, 1)
        self.conv5 = nn.Conv1d(128, 1024, 3, padding=1)
        for i, c in enumerate((64, 64, 64, 128, 1024), start=1):
            setattr(self, f"bn{i}", nn.BatchNorm1d(c, eps=CONV_BN_EPS))
        self.fc1 = nn.Linear(1024, 512)
        self.fc2 = nn.Linear(512, 256)
        self.fc3 = nn.Linear(256, classes)
        self.bn6 = nn.BatchNorm1d(512, eps=FC_BN_EPS)
        self.bn7 = nn.BatchNorm1d(256, eps=FC_BN_EPS)
        self.dropout = nn.Dropout(DROPOUT)

    def forward(self, pc: torch.Tensor, point_mask=None,
                generator: Optional[torch.Generator] = None,
                keep: Optional[Sequence[torch.Tensor]] = None):
        """pc [b, n, 3] -> logits [b, classes]. With `point_mask` [b, n]
        bool, the points where it is False are left out of every global
        pool (and zeroed before conv5). In train mode -> (logits, feature
        transform [b, 64, 64]), the two dropouts' keep masks ([b, 512],
        [b, 256]) drawn from `generator` or given as `keep`."""
        if pc.shape[-1] != 3:
            raise ValueError(f"expected channel-last [b, n, 3], got {tuple(pc.shape)}")
        if point_mask is not None and point_mask.shape != pc.shape[:2]:
            raise ValueError(f"point_mask {tuple(point_mask.shape)} does not "
                             f"match the cloud {tuple(pc.shape)}")
        t = self.training
        keep1, keep2 = keep if keep is not None else (None, None)
        feat = pc @ self.input_transform(pc, point_mask)
        feat = torch.relu(batch_norm(_dense(feat, self.conv1), self.bn1, t))
        feat = torch.relu(batch_norm(_dense(feat, self.conv2), self.bn2, t))
        t_feat = self.feature_transform(feat, point_mask)
        feat = feat @ t_feat
        feat = torch.relu(batch_norm(_dense(feat, self.conv3), self.bn3, t))
        feat = torch.relu(batch_norm(_dense(feat, self.conv4), self.bn4, t))
        if point_mask is not None:
            feat = torch.where(point_mask[..., None], feat, 0.0)
        feat = _pool(feat, self.conv5, self.bn5, t, point_mask)
        feat = torch.relu(batch_norm(_dense(feat, self.fc1), self.bn6, t))
        feat = dropout(feat, DROPOUT, t, generator, keep1)
        feat = torch.relu(batch_norm(_dense(feat, self.fc2), self.bn7, t))
        feat = dropout(feat, DROPOUT, t, generator, keep2)
        logits = _dense(feat, self.fc3)
        return (logits, t_feat) if t else logits
