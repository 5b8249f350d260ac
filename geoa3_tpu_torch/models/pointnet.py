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
first, so its kernel of 3 sees the boundary a shrunken cloud would.

`return_idx=True` in eval mode also returns conv5's max-pool argmax
[b, 1024] (the critical points; the JAX model's `return_idx`): the pool
then runs unfused, as the JAX model's does, and a masked point is never
chosen.

A bf16 twin of the victim (models.registry.make_eval_fn with
`dtype=torch.bfloat16`: every parameter and statistic in bf16, the cloud cast
to bf16) computes what the JAX package's bf16 victim computes: types follow
flax's promotion (a bf16 layer on a bf16 input stays bf16, its product a
float32 one rounded once to bf16, as XLA's CPU dot is; a float32 input
lifts the bf16 weights to float32), its BatchNorms are flax's op order
(models/layers.py), its folds are made in bf16 arithmetic in
`_fused_pool`'s order, and its three pools run the pool kernel's
single-pass bf16 mode (`pool_affine_max_bf16`), which returns float32: so
from the input T-Net's pool on, the activations are float32. It serves the
attack's gradient pass in eval mode only: training, a `point_mask` and
`return_idx` raise.

In training, a layer whose output features `parallel.make_sharded_train_step`
split over the model group (`model_group`: the wide layers, >= 512
outputs) computes its own features, which are all-gathered before its
bias, its BatchNorm and its ReLU (parallel/collectives.py). The eval route
never looks: a split model refuses eval mode.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from geoa3_tpu_torch.models.layers import batch_norm, dropout
from geoa3_tpu_torch.parallel.collectives import model_group, split_features
from geoa3_tpu_torch.ops.kernels.pool_matmul_kernel import (
    pool_affine_max,
    pool_affine_max_bf16,
)

CONV_BN_EPS = 1e-3
FC_BN_EPS = 1e-5
DROPOUT = 0.3


def _dense(x: torch.Tensor, layer: nn.Module, training: bool = False) -> torch.Tensor:
    """Channel-last application of a Linear or kernel-1 Conv1d; in training,
    of this rank's features of a split layer, gathered (module docstring)."""
    w = layer.weight
    if w.dim() == 3:
        w = w[..., 0]
    if w.dtype == torch.bfloat16:
        return _promoted(x, layer, w)
    group = model_group(layer) if training else None
    if group is None:
        return F.linear(x, w, layer.bias)
    return split_features(x, group, lambda x: F.linear(x, w)) + layer.bias


def _promoted(x: torch.Tensor, layer: nn.Module, w: torch.Tensor) -> torch.Tensor:
    """x @ w.T + bias of a bf16 twin's layer (w its bf16 weight [cout, cin])
    in flax's promoted type: for a bf16 x, the float32 product rounded once
    to bf16, then the bf16 bias added; for a float32 x, in float32 with the
    weights lifted exactly. The lifted weights are kept on the layer (the
    victim is frozen) and made again only when their sources were moved or
    changed in place."""
    key = tuple((t.data_ptr(), t._version) for t in (w, layer.bias))
    cached = getattr(layer, "_lift", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            cached = (key, w.float(), layer.bias.float())
        layer._lift = cached
    _, w32, b32 = cached
    if x.dtype == torch.bfloat16:
        return (x.float() @ w32.T).to(x.dtype) + layer.bias
    return F.linear(x, w32, b32)


def _matmul(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """a @ t in the promoted type (jnp.einsum's): a bf16 twin's cloud meets
    its float32 transform in float32."""
    dt = torch.promote_types(a.dtype, t.dtype)
    return a.to(dt) @ t.to(dt)


def _folded(conv: nn.Conv1d, bn: nn.BatchNorm1d):
    """(w3 [taps, cin, cout], bias [cout] float32, w3t [taps, cout, cin]):
    the eval BatchNorm folded into the conv, in the weights' type (a bf16
    twin's fold rounds each op to bf16, in geoa3_tpu/models/pointnet.py:
    _fused_pool's order, eps taken as bf16; its bias, bf16 values, is handed
    to the kernel as float32). The victim is frozen, so the fold is kept on
    the conv and made again only when one of its sources was moved, cast or
    changed in place (a new storage, type or version counter: the
    optimiser's step and the train-mode BatchNorm update in place)."""
    srcs = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
            bn.running_var)
    key = (conv.weight.device, conv.weight.dtype) + tuple(
        (t.data_ptr(), t._version) for t in srcs)
    cached = getattr(conv, "_fold", None)
    if cached is None or cached[0] != key:
        with torch.no_grad():
            eps = torch.tensor(bn.eps, dtype=bn.running_var.dtype,
                               device=bn.running_var.device)
            s = bn.weight * torch.rsqrt(bn.running_var + eps)
            w3 = (conv.weight.permute(2, 1, 0) * s).contiguous()
            b = ((conv.bias - bn.running_mean) * s + bn.bias).float().contiguous()
            cached = (key, w3, b, w3.transpose(1, 2).contiguous())
        conv._fold = cached
    return cached[1:]


def _fused_pool(x: torch.Tensor, conv: nn.Conv1d, bn: nn.BatchNorm1d):
    """relu(max_n(bn(conv(x)))) through the pool kernel: x [b, n, cin] ->
    [b, cout] float32. The eval BatchNorm folds into the conv; ReLU commutes
    with the max and is applied after it. A bf16 twin's folds take the
    kernel's single-pass bf16 mode."""
    w3, b, w3t = _folded(conv, bn)
    if w3.dtype == torch.bfloat16:
        return torch.relu(pool_affine_max_bf16(x, w3, b, w3t))
    return torch.relu(pool_affine_max(x, w3, b, w3t))


def _pool(x, conv, bn, training: bool, point_mask=None, return_idx=False):
    """relu(bn(conv(x))) from x [b, n, cin], max-pooled over the points ->
    [b, cout] (and with `return_idx` the first point of each maximum,
    [b, cout]). In eval mode without a mask or the index, the fused pool
    kernel. Otherwise unfused: a kernel-3 conv runs over the point axis with
    padding 1 (F.conv1d), the BatchNorm is train-mode in training, and the
    max skips the points where point_mask [b, n] is False."""
    if not (training or return_idx) and point_mask is None:
        return _fused_pool(x, conv, bn)
    group = model_group(conv) if training else None
    if conv.kernel_size[0] == 1:
        h = _dense(x, conv, training)
    elif group is None:
        h = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias,
                     padding=conv.padding).transpose(1, 2)
    else:
        h = split_features(x, group, lambda x: F.conv1d(
            x.transpose(1, 2), conv.weight, padding=conv.padding
        ).transpose(1, 2)) + conv.bias
    h = torch.relu(batch_norm(h, bn, training))
    if point_mask is not None:
        h = torch.where(point_mask[..., None], h, torch.finfo(h.dtype).min)
    if return_idx:
        return h.max(dim=1)
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
        h = torch.relu(batch_norm(_dense(x, self.conv1, t), self.bn1, t))
        h = torch.relu(batch_norm(_dense(h, self.conv2, t), self.bn2, t))
        h = _pool(h, self.conv3, self.bn3, t, point_mask)
        h = torch.relu(batch_norm(_dense(h, self.fc1, t), self.bn4, t))
        h = torch.relu(batch_norm(_dense(h, self.fc2, t), self.bn5, t))
        h = _dense(h, self.fc3, t)
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
                keep: Optional[Sequence[torch.Tensor]] = None,
                return_idx: bool = False):
        """pc [b, n, 3] -> logits [b, classes]. With `point_mask` [b, n]
        bool, the points where it is False are left out of every global
        pool (and zeroed before conv5). In train mode -> (logits, feature
        transform [b, 64, 64]), the two dropouts' keep masks ([b, 512],
        [b, 256]) drawn from `generator` or given as `keep`. With
        `return_idx` (eval mode) -> (logits, conv5's pool argmax [b, 1024]
        int64: the first point of each feature's maximum)."""
        if pc.shape[-1] != 3:
            raise ValueError(f"expected channel-last [b, n, 3], got {tuple(pc.shape)}")
        if point_mask is not None and point_mask.shape != pc.shape[:2]:
            raise ValueError(f"point_mask {tuple(point_mask.shape)} does not "
                             f"match the cloud {tuple(pc.shape)}")
        t = self.training
        if return_idx and t:
            raise ValueError("return_idx is an eval-mode output")
        if self.conv1.weight.dtype == torch.bfloat16 and (
                t or point_mask is not None or return_idx):
            raise ValueError("a bf16 victim serves the attack's gradient pass "
                             "only: eval mode, no point_mask, no return_idx")
        keep1, keep2 = keep if keep is not None else (None, None)
        feat = _matmul(pc, self.input_transform(pc, point_mask))
        feat = torch.relu(batch_norm(_dense(feat, self.conv1, t), self.bn1, t))
        feat = torch.relu(batch_norm(_dense(feat, self.conv2, t), self.bn2, t))
        t_feat = self.feature_transform(feat, point_mask)
        feat = _matmul(feat, t_feat)
        feat = torch.relu(batch_norm(_dense(feat, self.conv3, t), self.bn3, t))
        feat = torch.relu(batch_norm(_dense(feat, self.conv4, t), self.bn4, t))
        if point_mask is not None:
            feat = torch.where(point_mask[..., None], feat, 0.0)
        feat = _pool(feat, self.conv5, self.bn5, t, point_mask, return_idx)
        if return_idx:
            feat, idx = feat
        feat = torch.relu(batch_norm(_dense(feat, self.fc1, t), self.bn6, t))
        feat = dropout(feat, DROPOUT, t, generator, keep1)
        feat = torch.relu(batch_norm(_dense(feat, self.fc2, t), self.bn7, t))
        feat = dropout(feat, DROPOUT, t, generator, keep2)
        logits = _dense(feat, self.fc3, t)
        if return_idx:
            return logits, idx
        return (logits, t_feat) if t else logits
