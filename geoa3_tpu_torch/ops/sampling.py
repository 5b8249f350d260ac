"""Farthest-point sampling and index gathers (port of
geoa3_tpu/ops/sampling.py).

`furthest_point_sampling` has the reference CUDA kernel's semantics
(sampling_gpu.cu:69-229): start at index 0, points with |p|^2 <= 1e-3 never
become candidates, running minimum from 1e10. `farthest_points_sample` is the
reference's random-start resampling (Lib/utility.py:175-203): the random
first pick is part of the selection and there is no skip. Both go through the
FPS kernel (ops/kernels/fps_kernel.py).

Randomness is explicit: the random start comes from a caller's
torch.Generator, or from a `start` tensor (a test replays another engine's
draw that way).
"""

from __future__ import annotations

from typing import Optional

import torch

from geoa3_tpu_torch.ops.kernels import fps_kernel
from geoa3_tpu_torch.ops.knn import gather_rows


def furthest_point_sampling(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy FPS, CUDA-kernel semantics: xyz [b, n, 3] -> idx [b, npoint]
    int32. Not differentiable. bf16 coordinates (the bf16 victim's) are
    sampled in float32, as the TPU's FPS kernel takes them
    (geoa3_tpu/ops/pallas/fps_kernel.py casts its input to float32)."""
    if xyz.dtype == torch.bfloat16:
        xyz = xyz.float()
    return fps_kernel.fps(xyz.detach().contiguous(), npoint,
                          skip_near_origin=True)


def gather_points(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features [b, n, c], idx [b, m] -> [b, m, c] (reference
    `gather_operation`, sampling_gpu.cu:8-57). Differentiable in `features`:
    the backward is the scatter-add kernel."""
    return gather_rows(features, idx)


def random_start(b: int, n: int, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """One uniform start index in [0, n) per cloud -> [b] int32."""
    return torch.randint(n, (b,), generator=generator, device=device,
                         dtype=torch.int32)


def _fps_random_start(points, num_points, generator, start):
    b, n, _ = points.shape
    if start is None:
        start = random_start(b, n, generator, points.device)
    start = start.to(device=points.device, dtype=torch.int32).contiguous()
    return fps_kernel.fps(points.detach().contiguous(), num_points,
                          start=start, skip_near_origin=False)


def farthest_points_sample(
    points: torch.Tensor,
    num_points: int,
    generator: Optional[torch.Generator] = None,
    start: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Random-start FPS resampling of a cloud: points [b, n, 3] ->
    [b, num_points, 3] (reference Lib/utility.py:175-187). The first pick is
    `start` [b], or drawn from `generator`. Differentiable in `points`
    through the gather."""
    idx = _fps_random_start(points, num_points, generator, start)
    return gather_points(points, idx)


def farthest_points_sample_with_normal(
    points: torch.Tensor,
    normals: torch.Tensor,
    num_points: int,
    generator: Optional[torch.Generator] = None,
    start: Optional[torch.Tensor] = None,
):
    """FPS resampling that carries the normals along (reference
    Lib/utility.py:189-203) -> (points, normals), each [b, num_points, 3]."""
    idx = _fps_random_start(points, num_points, generator, start)
    return gather_points(points, idx), gather_points(normals, idx)
