"""Meters and timers (the port's own copy of geoa3_tpu/utils/meters.py;
reference Lib/utility.py:472-577).

The reference's `progress_bar` shells out to `stty size` at import time
(utility.py:466) and breaks in headless runs; this version is terminal-safe.
The step timer waits for the card (torch.cuda.synchronize) before it reads
the clock.
"""

from __future__ import annotations

import sys
import time


class AverageMeter:
    """Running value/average tracker (reference Lib/utility.py:548-563)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def format_time(seconds: float) -> str:
    """Compact duration string (reference Lib/utility.py:516-546)."""
    days = int(seconds / 3600 / 24)
    seconds -= days * 3600 * 24
    hours = int(seconds / 3600)
    seconds -= hours * 3600
    minutes = int(seconds / 60)
    seconds -= minutes * 60
    secondsf = int(seconds)
    millis = int((seconds - secondsf) * 1000)
    parts = []
    for val, suffix in ((days, "D"), (hours, "h"), (minutes, "m"),
                        (secondsf, "s"), (millis, "ms")):
        if val > 0 and len(parts) < 2:
            parts.append(f"{val}{suffix}")
    return "".join(parts) if parts else "0ms"


def progress_line(current: int, total: int, msg: str = "") -> None:
    """Single-line progress print, safe without a tty."""
    bar_len = 30
    filled = int(bar_len * (current + 1) / max(total, 1))
    bar = "=" * filled + ">" + "." * (bar_len - filled)
    end = "\n" if current + 1 >= total else "\r"
    sys.stdout.write(f" [{bar}] {current + 1}/{total} {msg}{end}")
    sys.stdout.flush()


class StepTimer:
    """Wall-clock step timer that waits for the device before stopping."""

    def __init__(self):
        self.meter = AverageMeter()
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        dt = time.perf_counter() - self._t0
        self.meter.update(dt)
        return dt


def natural_sort(items):
    """Sort strings with embedded numbers numerically (reference
    Lib/utility.py:717-720)."""
    import re

    def convert(text):
        return int(text) if text.isdigit() else text.lower()

    return sorted(items, key=lambda key: [convert(c) for c in re.split(r"([0-9]+)", key)])
