"""Point-removal defenses (port of geoa3_tpu/defense.py; reference
defense.py:18-50).

Three defenses, each on a batch of clouds of one size:
  * `random_drop`       - drop `drop_num` random points;
  * `outliers_fix_num`  - drop the `drop_num` points with the largest mean
    kNN distance (statistical outlier removal, fixed count);
  * `outliers_variance` - drop the points whose mean kNN distance is at
    least mean + alpha * std. The kept count depends on the cloud, so the
    output keeps the cloud's size: the kept points come first in their
    original order, the tail repeats the first kept point, and a suffix
    `keep_mask` marks the kept slots. Classify PointNet with `point_mask`
    and PointNet++ on the padded cloud as it is.

The padding is neutral for both victim families, as in the JAX package:
max pools trivially under the mask; FPS and ball query because the repeats
sit in the suffix with the coordinates of the first kept point (FPS starts
at index 0, so they carry a running distance of 0 and are never picked, and
a ball query pads with the first hit, whose coordinates equal theirs).
PointNet++ logits on the padded cloud equal those on the shrunken one, which
the reference materialises (defense.py:30-35).

The mean kNN distance is a self-kNN at k = outlier_knn + 1 (the kNN
kernel on the card). The selections follow the JAX package's orders exactly:
the fixed-count keep takes the lower index among tied distances (as
`jax.lax.top_k` does), through a stable argsort.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from geoa3_tpu_torch import ops


class DefenseResult(NamedTuple):
    pc: torch.Tensor  # [b, m, 3] (fixed-count modes) or [b, n, 3] (variance)
    keep_mask: Optional[torch.Tensor]  # [b, n] bool, only for outliers_variance
    num_dropped: torch.Tensor  # [b] int32


def _mean_knn_dist(pc: torch.Tensor, k: int) -> torch.Tensor:
    """Mean (not squared) distance of each point to its k nearest other
    points -> [b, n] (reference defense.py:26-27)."""
    res = ops.knn_points(pc, pc, k=k + 1)
    return torch.sqrt(res.dists[..., 1:] + 1e-20).mean(dim=-1)


def _keep(pc: torch.Tensor, keep_idx: torch.Tensor, drop_num: int) -> DefenseResult:
    """The points at keep_idx [b, m], in index order."""
    keep_idx = torch.sort(keep_idx, dim=-1).values
    dropped = torch.full((pc.shape[0],), drop_num, dtype=torch.int32,
                         device=pc.device)
    return DefenseResult(ops.gather_points(pc, keep_idx), None, dropped)


def random_drop_noise(pc: torch.Tensor, generator=None) -> torch.Tensor:
    """The uniform draws [b, n] that rank the points for `random_drop`."""
    return torch.rand(pc.shape[:2], generator=generator, device=pc.device)


def drop_by_noise(pc: torch.Tensor, noise: torch.Tensor, drop_num: int) -> DefenseResult:
    """Drop the `drop_num` points with the smallest noise [b, n], keeping
    the others in index order."""
    return _keep(pc, torch.argsort(noise, dim=-1, stable=True)[:, drop_num:],
                 drop_num)


def random_drop(pc: torch.Tensor, drop_num: int, generator=None) -> DefenseResult:
    """Drop `drop_num` random points, keeping the index order (reference
    defense.py:18-23); the draws come from `generator`."""
    return drop_by_noise(pc, random_drop_noise(pc, generator), drop_num)


def outliers_fix_num(pc: torch.Tensor, drop_num: int, outlier_knn: int) -> DefenseResult:
    """Keep the n - drop_num points of smallest mean kNN distance, in index
    order; on tied distances the lower index is kept (reference :36-40)."""
    dis = _mean_knn_dist(pc, outlier_knn)
    keep = pc.shape[1] - drop_num
    return _keep(pc, torch.argsort(dis, dim=-1, stable=True)[:, :keep], drop_num)


def outliers_variance(pc: torch.Tensor, alpha: float, outlier_knn: int) -> DefenseResult:
    """Keep the points whose mean kNN distance is below mean + alpha * std
    (Bessel's std; reference :30-35). The kept points move to the front in
    index order (the reference's masked_select), the tail repeats the first
    kept point, and keep_mask [b, n] is the suffix mask of the kept slots."""
    n = pc.shape[1]
    dis = _mean_knn_dist(pc, outlier_knn)
    mean = dis.mean(dim=-1, keepdim=True)
    std = torch.std(dis, dim=-1, correction=1, keepdim=True)
    keep = dis < mean + alpha * std
    order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
    out = ops.gather_points(pc, order)
    count = keep.sum(dim=-1, keepdim=True)
    mask = torch.arange(n, device=pc.device)[None, :] < count
    out = torch.where(mask[..., None], out, out[:, :1, :])
    return DefenseResult(out, mask, (n - count[:, 0]).to(torch.int32))


def point_removal(
    pc: torch.Tensor,
    defense_type: str,
    drop_num: int,
    alpha: float,
    outlier_knn: int,
    generator=None,
) -> DefenseResult:
    """Dispatch on the defense type (reference `point_removal_fn`,
    defense.py:42-50); `generator` feeds `rand_drop`."""
    if defense_type == "rand_drop":
        return random_drop(pc, drop_num, generator)
    if defense_type == "outliers_variance":
        return outliers_variance(pc, alpha, outlier_knn)
    if defense_type == "outliers_fixNum":
        return outliers_fix_num(pc, drop_num, outlier_knn)
    raise ValueError(f"Wrong defense type: {defense_type}")
