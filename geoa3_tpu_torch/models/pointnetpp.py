"""PointNet++ SSG and MSG victim classifiers and the feature-propagation
module (port of geoa3_tpu/models/pointnetpp.py).

Module and parameter names are those of the reference
Model/PointNetPP_ssg.py and pointnet2_ops/pointnet2_modules.py
(`SA_modules.{i}.mlps.{j}.{3k}` Conv2d / `{3k+1}` BatchNorm2d,
`fc_layer.{0,1,3,4,7}`), so a reference state_dict loads as it is
(models/convert.py). The public layout is channel-last like the JAX package:
the model takes [b, n, 3] clouds ([b, n, 6] with normals as features).

Parity notes (reference PointNetPP_ssg.py:64-98, PointNetPP_msg.py:17-46,
pointnet2_modules.py):
  * SSG: SA(512, r=0.2, ns=64, mlp 64/64/128) -> SA(128, r=0.4, ns=64, mlp
    128/128/256) -> GroupAll mlp 256/512/1024 -> FC head 512/256/classes with
    dropout 0.5;
  * MSG: SA(512; radii 0.1/0.2/0.4, ns 16/32/128; mlps 32/32/64, 64/64/128,
    64/96/128) -> SA(128; radii 0.2/0.4/0.8, ns 32/64/128; mlps 64/64/128,
    128/128/256, 128/128/256) -> GroupAll mlp 256/512/1024 -> the same head;
    each level's scales are concatenated (3 -> 3 + 320 -> 3 + 640 inputs);
  * with use_xyz the grouped relative coordinates come before the features in
    the first layer's input (pointnet2_utils.py:322-324);
  * the shared-MLP convs and the head's first two Linears carry no bias; every
    BatchNorm has eps 1e-5.

In eval mode each set-abstraction level is farthest-point sampling, then
per scale either the fused ball query + grouping and the grouped three-layer
MLP with its max over nsample (ops/kernels/{ballquery_group,group_mlp}_kernel),
or the whole scale in one (ops/kernels/sa_fused_kernel), chosen by the JAX
package's shape rule (PointnetSAModuleMSG); the eval BatchNorms are folded
into the layers' weights. GroupAll feeds the whole cloud to the grouped-MLP
kernel as one group.

In train mode (`model.train()`, the trainer's), and wherever `use_xyz` is
False, a scale takes the JAX package's unfused route
(geoa3_tpu/models/pointnetpp.py:279-323, 369-391): FPS (row 12), the ball
query alone (row 15's forward with its gathers compiled out),
`ops.group_points` of the coordinates minus the centres and of the features
(a gather whose backward is the C-channel scatter kernel, row 13), then the
shared MLP's layers one by one (1x1 conv as a product, the first one split
over coordinates and features as the JAX `_SplitDense` is, the train-mode
BatchNorm of models/layers.py, ReLU) and `amax` over nsample. GroupAll
broadcasts the whole cloud as one group. The head's dropout (0.5) draws from
the `generator` passed to `forward`, or takes the `keep` mask given. The
grouped-MLP kernels take the three-layer MLPs of eval mode only.

The JAX model's eval route at use_xyz=False sends GroupAll's last layer
through its pool kernel; the port runs that layer unfused (the same
function). No classifier of either package uses use_xyz=False.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from geoa3_tpu_torch import ops
from geoa3_tpu_torch.models.layers import batch_norm, dropout
from geoa3_tpu_torch.ops.kernels.group_mlp_kernel import FoldedMLP

BN_EPS = 1e-5
DROPOUT = 0.5


class SharedMLP(nn.Sequential):
    """Conv2d-1x1 + BatchNorm2d + ReLU stack (reference build_shared_mlp,
    pointnet2_modules.py:9-19), applied to grouped rows and max-pooled over
    nsample by the fused kernel: gx [b, m, ns, 3], gf [b, m, ns, cf] or None
    -> [b, m, widths[-1]]. The kernel takes three layers."""

    def __init__(self, cin: int, widths: Sequence[int]):
        layers = []
        for w in widths:
            layers += [nn.Conv2d(cin, w, 1, bias=False),
                       nn.BatchNorm2d(w, eps=BN_EPS), nn.ReLU(inplace=True)]
            cin = w
        super().__init__(*layers)
        self.widths = tuple(widths)

    def folded(self) -> FoldedMLP:
        """The eval BatchNorms folded into the convs (w_i * s_i, beta_i -
        mean_i * s_i with s_i = gamma_i / sqrt(var_i + eps)). The victim is
        frozen, so the fold is kept and made again only when one of its
        sources was moved or changed in place."""
        srcs = [t for i in range(0, len(self), 3)
                for t in (self[i].weight, self[i + 1].weight, self[i + 1].bias,
                          self[i + 1].running_mean, self[i + 1].running_var)]
        key = (srcs[0].device,) + tuple((t.data_ptr(), t._version) for t in srcs)
        cached = getattr(self, "_fold", None)
        if cached is None or cached[0] != key:
            parts = []
            with torch.no_grad():
                for i in range(0, len(self), 3):
                    conv, bn = self[i], self[i + 1]
                    s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                    parts.append(conv.weight[:, :, 0, 0].t() * s[None, :])
                    parts.append(bn.bias - bn.running_mean * s)
                cached = (key, ops.fold_mlp(*parts))
            self._fold = cached
        return cached[1]

    def _kernel_fold(self) -> FoldedMLP:
        if self.training:
            raise NotImplementedError(
                "the grouped-MLP kernels fold the eval BatchNorm: call .eval(), "
                "or run the layers unfused (SharedMLP.unfused)")
        if len(self.widths) != 3:
            raise NotImplementedError(
                f"the grouped-MLP kernel takes three layers, got {self.widths}")
        return self.folded()

    def forward(self, gx: torch.Tensor, gf: Optional[torch.Tensor]) -> torch.Tensor:
        return ops.group_mlp_maxpool(gx, gf, self._kernel_fold())

    def whole_scale(self, xyz, new_xyz, features, radius: float,
                    nsample: int) -> torch.Tensor:
        """The ball query, the grouping, this MLP and the max over nsample in
        one (ops.sa_query_group_mlp): xyz [b, n, 3], new_xyz [b, m, 3],
        features [b, n, cf] or None -> [b, m, widths[-1]]."""
        return ops.sa_query_group_mlp(xyz, new_xyz, features, radius, nsample,
                                      self._kernel_fold())

    def rows(self, x: torch.Tensor, gf: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The layers applied to rows, not pooled, any number of them:
        x [..., cin] -> [..., widths[-1]]; with `gf` [..., cf], x holds the
        first cin - cf inputs and gf the rest, and the first layer is split
        over the two (the JAX `_SplitDense`: no concatenation). Plain
        PyTorch (the JAX package runs this path unfused too); the eval
        BatchNorm as flax computes it, the train-mode one of
        models/layers.py in training."""
        for i in range(0, len(self), 3):
            conv, bn = self[i], self[i + 1]
            w = conv.weight[:, :, 0, 0]
            if i == 0 and gf is not None:
                wa = x.shape[-1]
                x = x @ w[:, :wa].t() + gf @ w[:, wa:].t()
            else:
                x = x @ w.t()
            if self.training:
                x = batch_norm(x, bn, True)
            else:
                x = (x - bn.running_mean) * (torch.rsqrt(bn.running_var + bn.eps)
                                             * bn.weight) + bn.bias
            x = torch.relu(x)
        return x

    def unfused(self, gx: Optional[torch.Tensor],
                gf: Optional[torch.Tensor]) -> torch.Tensor:
        """The layers on grouped rows and the max over nsample, unfused:
        gx [b, m, ns, 3] or None (use_xyz=False), gf [b, m, ns, cf] or None
        -> [b, m, widths[-1]] (geoa3_tpu/models/pointnetpp.py:279-323)."""
        x = self.rows(gf) if gx is None else self.rows(gx, gf)
        return x.amax(dim=2)


class PointnetSAModuleMSG(nn.Module):
    """Set abstraction with one or more grouping scales (reference
    pointnet2_modules.py:77-115): xyz [b, n, 3], features [b, n, c] or None
    -> (new_xyz [b, npoint, 3] or None, features [b, npoint, sum of the last
    widths]). `npoint=None` is GroupAll: the whole cloud is one group."""

    def __init__(self, npoint: Optional[int], radii: Sequence[Optional[float]],
                 nsamples: Sequence[Optional[int]],
                 mlps: Sequence[Sequence[int]], in_features: int = 0,
                 use_xyz: bool = True):
        super().__init__()
        if not len(radii) == len(nsamples) == len(mlps):
            raise ValueError("radii, nsamples and mlps must have one entry a scale")
        if not use_xyz and not in_features:
            raise ValueError("cannot have no features and not use xyz")
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.use_xyz = use_xyz
        cin = (3 if use_xyz else 0) + in_features
        self.mlps = nn.ModuleList(SharedMLP(cin, widths) for widths in mlps)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]):
        outs = []
        unfused = self.training or not self.use_xyz
        if self.npoint is not None:
            fps_idx = ops.furthest_point_sampling(xyz, self.npoint)
            new_xyz = ops.gather_points(xyz, fps_idx)
            cf = 0 if features is None else features.shape[-1]
            for radius, ns, mlp in zip(self.radii, self.nsamples, self.mlps):
                if unfused:
                    # geoa3_tpu/models/pointnetpp.py:_query_and_group
                    idx = ops.ball_query(radius, ns, xyz, new_xyz)
                    gx = (ops.group_points(xyz, idx) - new_xyz[:, :, None]
                          if self.use_xyz else None)
                    gf = (ops.group_points(features, idx)
                          if features is not None else None)
                    outs.append(mlp.unfused(gx, gf))
                # the JAX package's route (geoa3_tpu/models/pointnetpp.py:
                # 441-465, gated by group_mlp_available and
                # ball_query_group_available): the split pair where cf is 0
                # or a multiple of 128, the whole-scale kernel otherwise
                # (MSG's SA2 at cf = 320, and SA1 with normals at cf = 3)
                elif cf % 128 == 0:
                    _, gx, gf = ops.ball_query_group(xyz, new_xyz, features,
                                                     radius, ns)
                    outs.append(mlp(gx, gf))
                else:
                    outs.append(mlp.whole_scale(xyz, new_xyz, features,
                                                radius, ns))
        else:
            new_xyz = None
            gx = xyz[:, None] if self.use_xyz else None
            gf = features[:, None] if features is not None else None
            mlp = self.mlps[0]
            outs.append(mlp.unfused(gx, gf) if unfused else mlp(gx, gf))
        return new_xyz, outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


class PointnetSAModule(PointnetSAModuleMSG):
    """Single-scale set abstraction (reference pointnet2_modules.py:118-146)."""

    def __init__(self, mlp: Sequence[int], npoint: Optional[int] = None,
                 radius: Optional[float] = None, nsample: Optional[int] = None,
                 in_features: int = 0, use_xyz: bool = True):
        super().__init__(npoint, [radius], [nsample], [mlp],
                         in_features=in_features, use_xyz=use_xyz)


def _ClsHead(classes: int) -> nn.Sequential:
    """FC head 1024 -> 512 -> 256 -> classes (reference
    PointNetPP_ssg.py:89-98), with the reference's `fc_layer` indices."""
    return nn.Sequential(
        nn.Linear(1024, 512, bias=False), nn.BatchNorm1d(512, eps=BN_EPS),
        nn.ReLU(True),
        nn.Linear(512, 256, bias=False), nn.BatchNorm1d(256, eps=BN_EPS),
        nn.ReLU(True),
        nn.Dropout(DROPOUT), nn.Linear(256, classes),
    )


class PointNet2ClassificationSSG(nn.Module):
    """PointNet++ SSG classifier: [b, n, 3] (or [b, n, 6] with use_normal)
    -> logits [b, classes]."""

    SA_CONFIGS = (
        dict(npoint=512, radius=0.2, nsample=64, mlp=[64, 64, 128]),
        dict(npoint=128, radius=0.4, nsample=64, mlp=[128, 128, 256]),
        dict(mlp=[256, 512, 1024]),  # GroupAll
    )

    def __init__(self, use_xyz: bool = True, use_normal: bool = False,
                 classes: int = 40):
        super().__init__()
        self.use_normal = use_normal
        self.classes = classes
        cin = 3 if use_normal else 0
        mods = []
        for cfg in self.SA_CONFIGS:
            # one scale (`mlp`) or several (`mlps`), as the reference builds
            # its levels
            sa = (PointnetSAModule if "mlp" in cfg else PointnetSAModuleMSG)(
                in_features=cin, use_xyz=use_xyz, **cfg)
            mods.append(sa)
            cin = sum(mlp.widths[-1] for mlp in sa.mlps)
        self.SA_modules = nn.ModuleList(mods)
        self.fc_layer = _ClsHead(classes)

    def forward(self, pc: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pc [b, n, 3] ([b, n, 6] with use_normal) -> logits [b, classes].
        In train mode the head's dropout keep mask [b, 256] is drawn from
        `generator` or given as `keep`."""
        want = 6 if self.use_normal else 3
        if pc.shape[-1] != want:
            raise ValueError(
                f"expected channel-last [b, n, {want}], got {tuple(pc.shape)}")
        xyz = pc[..., :3].contiguous()
        features = pc[..., 3:].contiguous() if self.use_normal else None
        for sa in self.SA_modules:
            xyz, features = sa(xyz, features)
        return self._head(features[:, 0, :], generator, keep)

    def _head(self, x, generator, keep):
        """The FC head; in training with the train-mode BatchNorms and the
        dropout written out (geoa3_tpu/models/pointnetpp.py:_ClsHead)."""
        fc = self.fc_layer
        if not self.training:
            return fc(x)
        x = torch.relu(batch_norm(x @ fc[0].weight.t(), fc[1], True))
        x = torch.relu(batch_norm(x @ fc[3].weight.t(), fc[4], True))
        return fc[7](dropout(x, fc[6].p, True, generator, keep))


class PointNet2ClassificationMSG(PointNet2ClassificationSSG):
    """PointNet++ MSG classifier (reference PointNetPP_msg.py:9-47): [b, n, 3]
    (or [b, n, 6] with use_normal) -> logits [b, classes]."""

    SA_CONFIGS = (
        dict(npoint=512, radii=[0.1, 0.2, 0.4], nsamples=[16, 32, 128],
             mlps=[[32, 32, 64], [64, 64, 128], [64, 96, 128]]),
        dict(npoint=128, radii=[0.2, 0.4, 0.8], nsamples=[32, 64, 128],
             mlps=[[64, 64, 128], [128, 128, 256], [128, 128, 256]]),
        dict(mlp=[256, 512, 1024]),  # GroupAll
    )


class PointnetFPModule(nn.Module):
    """Feature propagation by 3-NN interpolation (reference
    pointnet2_modules.py:149-209): unknown [b, n, 3], known [b, m, 3] (or
    None: known_feats [b, 1, c2] is broadcast), unknow_feats [b, n, c1] or
    None, known_feats [b, m, c2] -> [b, n, mlp[-1]]. `mlp` lists the input
    width (c2, + c1 with unknown features) and then the layers' widths, as
    the reference's build_shared_mlp takes it; the layers are plain PyTorch
    (`SharedMLP.rows`, train-mode BatchNorm in training). No shipped
    classifier uses it."""

    def __init__(self, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(mlp[0], mlp[1:])

    def forward(self, unknown: torch.Tensor, known: Optional[torch.Tensor],
                unknow_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor) -> torch.Tensor:
        if known is not None:
            dist, idx = ops.three_nn(unknown, known)
            dist_recip = 1.0 / (dist + 1e-8)
            weight = dist_recip / dist_recip.sum(dim=2, keepdim=True)
            interpolated = ops.three_interpolate(known_feats, idx, weight)
        else:
            interpolated = known_feats.expand(-1, unknown.shape[1], -1)
        if unknow_feats is not None:
            interpolated = torch.cat([interpolated, unknow_feats], dim=-1)
        return self.mlp.rows(interpolated)
