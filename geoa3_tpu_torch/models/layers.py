"""BatchNorm and dropout as the JAX package's flax layers compute them, for
both victim families (geoa3_tpu/models/pointnet.py, pointnetpp.py).

Channel-last: every helper normalises over the last axis of x [..., C].

Train-mode BatchNorm follows flax's `nn.BatchNorm`, which is not
`torch.nn.BatchNorm`'s rule, and so deviates from the upstream PyTorch
reference on purpose:
  * the output uses the batch mean and the biased batch variance (torch does
    this too);
  * the running statistics move as m * old + (1 - m) * batch, where m is
    flax's momentum, 1 - the module's torch-convention `momentum` (the
    trainer sets that from `train.bn_momentum_for_epoch`), and the running
    variance takes the BIASED batch variance (flax 0.12.3,
    normalization.py: `ra_var = m * ra_var + (1 - m) * var`); torch's takes
    the unbiased one, b / (b - 1) times larger (3.2% on the heads'
    BatchNorm1d at b = 32, 2x at b = 2);
  * one row per channel (the head at a last batch of one cloud) normalises
    to 0 (variance 0), as flax does (`F.batch_norm` refuses one row).
The statistics are reduced by torch's mean (pairwise sums) in two passes,
not as flax's E[x^2] - E[x]^2 (`use_fast_variance`) nor by F.batch_norm:
the same quantities, without the cancellation that costs float32 digits
where a channel's mean is large against its spread (a head's BatchNorm
over a few clouds), and without F.batch_norm's running sums on the CPU,
which lose ~1e-2 of a gradient over the 10^5 rows of a set-abstraction
level; in float64 all of them agree to rounding (tests/test_torch_train.py).
The running buffers are updated in place under no_grad, so their version
counters move and the models' eval-mode fold caches are made again.

Inside `parallel.collectives.data_shard` (the sharded train step of
parallel/mesh.py) each rank holds its rows of the global batch: the
statistics are the global batch's, both passes summed over the data group by
a differentiable all-reduce (so every rank's running statistics agree), and
the dropout masks are drawn at the global batch's shape, or given at it,
and cut to this rank's rows, so that a sharded step computes what one
device computes on the whole batch.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from geoa3_tpu_torch.parallel.collectives import active_shard, all_reduce_sum


def batch_norm(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
               training: bool) -> torch.Tensor:
    """`bn` applied over the last axis of x [..., C]: in training with the
    batch's statistics (updating bn's running ones by flax's rule), else with
    the running statistics."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not training:
        y = F.batch_norm(x2, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return y.reshape(x.shape)
    # two passes: the mean, then the mean square of the centred rows (one
    # row gives exactly 0, as in flax)
    shard = active_shard()
    if shard is None:
        mean = x2.mean(0)
        xc = x2 - mean
        var = (xc * xc).mean(0)
    else:
        rows = x2.shape[0] * shard.size
        mean = all_reduce_sum(x2.sum(0), shard.group) / rows
        xc = x2 - mean
        var = all_reduce_sum((xc * xc).sum(0), shard.group) / rows
    y = xc * (torch.rsqrt(var + bn.eps) * bn.weight) + bn.bias
    m = 1.0 - bn.momentum  # flax's momentum
    with torch.no_grad():
        bn.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
        bn.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
    return y.reshape(x.shape)


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None,
            keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax's `nn.Dropout(p)`: in training, x / (1 - p) where kept, else 0.
    The keep mask is `keep` (bool, x's shape: a test feeds another engine's
    draw) or drawn from `generator` (on x's device; None: torch's default
    generator). Outside training, x. In a data shard, `keep` and the draw
    have the global batch's rows, of which this rank keeps its own."""
    if not training:
        return x
    shard = active_shard()
    shape = x.shape if shard is None else (x.shape[0] * shard.size,) + x.shape[1:]
    if keep is None:
        keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    elif keep.shape != shape:
        raise ValueError(f"dropout keep mask {tuple(keep.shape)} does not match "
                         f"{tuple(shape)}")
    if shard is not None:
        keep = shard.rows(keep).to(x.device)
    return torch.where(keep, x / (1.0 - p), 0.0)
