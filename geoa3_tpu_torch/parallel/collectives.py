"""The collectives a sharded forward and backward take, as autograd functions,
and the data shard that the train-mode layers read (models/layers.py).

The JAX package leaves these to GSPMD; here each rank runs its own eager
program, so the three places where ranks meet inside a step are written out:

  * `all_reduce_sum`: a sum over a group whose backward is a sum again (the
    global BatchNorm statistics: every rank's loss depends on every rank's
    rows);
  * `split_features`: a layer whose output features are split over the
    `model` group (Megatron's column-parallel layer): the input passes
    unchanged and its gradient is summed over the group; each rank computes
    its features and they are all-gathered along the last axis, whose
    backward hands each rank the gradient of its own features;
  * `data_shard`: a context naming the `data` group, this rank's index in it
    and its size, so that BatchNorm reduces its statistics over the group
    and dropout draws its masks at the global batch's shape and keeps this
    rank's rows.

Only all_reduce, all_gather and broadcast are used: every backend has them
(some gloo builds have no reduce-scatter). Each runs where its backend
wants the tensor: a CUDA tensor goes through the host for gloo (ranks that
share one card), a host tensor through the current card for NCCL (Adam's
step counts).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist


def rows_of(x, index: int, size: int):
    """Rank `index` of `size`'s rows of x's leading (batch) axis; a batch
    that `size` does not divide raises."""
    b = x.shape[0]
    if b % size:
        raise ValueError(f"a batch of {b} does not split over {size} data ranks")
    per = b // size
    return x[index * per:(index + 1) * per]


class DataShard(NamedTuple):
    group: dist.ProcessGroup
    index: int  # this rank's place on the data axis
    size: int  # the data axis's size

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor at the global batch's shape."""
        return rows_of(x, self.index, self.size)


_SHARD: contextvars.ContextVar[Optional[DataShard]] = contextvars.ContextVar(
    "geoa3_data_shard", default=None)


def active_shard() -> Optional[DataShard]:
    """The data shard of the enclosing `data_shard` block, or None."""
    return _SHARD.get()


@contextlib.contextmanager
def data_shard(group, index: int, size: int):
    """Run the block's train-mode layers as one rank of a data-parallel
    group (see the module docstring)."""
    token = _SHARD.set(DataShard(group, index, size))
    try:
        yield
    finally:
        _SHARD.reset(token)


def _staged(t: torch.Tensor, group, op: Callable[[torch.Tensor], None]) -> None:
    """op(t) in place, on a copy on the device the group's backend takes
    where t lies elsewhere."""
    want_cuda = dist.get_backend(group) == "nccl"
    if t.is_cuda == want_cuda:
        op(t)
        return
    tmp = t.to("cuda" if want_cuda else "cpu")
    op(tmp)
    t.copy_(tmp)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of a contiguous tensor over the group."""
    _staged(t, group, lambda x: dist.all_reduce(x, group=group))
    return t


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """In-place broadcast of a contiguous tensor from global rank `src`."""
    _staged(t, group, lambda x: dist.broadcast(x, src, group=group))
    return t


def all_gather(t: torch.Tensor, group=None) -> list:
    """The group's tensors of t's shape, in the group's rank order."""
    t = t.contiguous()
    size = dist.get_world_size(group)
    if (dist.get_backend(group) == "nccl") == t.is_cuda:
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        return parts
    src = t.to("cuda" if t.device.type == "cpu" else "cpu")
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return [x.to(t.device) for x in parts]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format),
                           ctx.group), None


class _GatherFeatures(torch.autograd.Function):
    """All-gather along the last axis, in the group's rank order; the
    backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        ctx.width = y.shape[-1]
        ctx.index = dist.get_rank(group)
        return torch.cat(all_gather(y, group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group, differentiable (module docstring)."""
    return _AllReduceSum.apply(x, group)


def split_features(x: torch.Tensor, group,
                   local: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """`local(x)` computes this rank's share of a layer's output features
    [..., c / size]; the result holds all of them [..., c] on every rank of
    the model group. With no group, `local(x)` alone."""
    if group is None:
        return local(x)
    return _GatherFeatures.apply(local(_ToModel.apply(x, group)), group)


def model_group(layer: torch.nn.Module):
    """The model group over which `parallel.make_sharded_train_step`'s
    `place` split this layer's output features, or None: a plain attribute,
    read from the layer's own dict (no Module.__getattr__ miss)."""
    return vars(layer).get("model_group")
