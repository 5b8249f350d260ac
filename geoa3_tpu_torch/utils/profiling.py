"""Tracing, timing and a NaN guard (port of geoa3_tpu/utils/profiling.py).

  * `device_trace`: torch.profiler over the host and, where there is one,
    the card, written as a Chrome trace (chrome://tracing, Perfetto);
  * `annotate`: a named range in that trace, and an NVTX range on the card;
  * `timed`: wall time of a call, the card synchronised before the clock is
    read;
  * `debug_nans`: raise on the first operation that makes a NaN. A
    TorchDispatchMode sees torch's operations but not the port's kernels,
    which write through pointers (ops/kernels/_build.py), so the guard also
    turns on a check in the kernels' shared launch path.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from geoa3_tpu_torch.ops.kernels import _build


@contextlib.contextmanager
def device_trace(logdir: str = "geoa3_trace") -> Iterator[str]:
    """Profile a block into `logdir`/trace.json:

        with device_trace("trace"):
            run_attack(...)
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in device traces (record_function; NVTX on the card)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


# operations that return memory they did not write: their NaNs are not made
_UNWRITTEN = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided", "empty_permuted"}


class _NaNGuard(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNWRITTEN:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.is_floating_point()
                        and torch.isnan(t).any()):
                    raise FloatingPointError(f"{func} produced a NaN")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise FloatingPointError on the first operation inside the block
    that makes a NaN: a torch operation, or a kernel of ours that wrote one
    into an argument that held none."""
    if not enable:
        yield
        return
    prev = _build.check_nans
    _build.check_nans = True
    try:
        with _NaNGuard():
            yield
    finally:
        _build.check_nans = prev


def timed(fn, *args, label: Optional[str] = None, **kwargs):
    """Run fn, wait for the card where an output lies on one, and return
    (result, seconds)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    for dev in {t.device for t in tree_leaves(out)
                if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if label:
        print(f"[timed] {label}: {dt * 1000:.2f} ms")
    return out, dt
