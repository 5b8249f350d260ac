"""The numbers a cell's check compares, each against its limit.

A traffic driver's `check` returns the gaps its reference found; here each
gap becomes one number (the statistic the cell's settings name for it) and
is held to the limit in `workloads/<cell>.json`. PERF.md gives the readings
each limit was set from.
"""

from __future__ import annotations

import math

import torch


def _stat(t: torch.Tensor, how: str) -> float:
    t = t.detach().double()
    if how == "median_max":
        # of a gap [steps, answers]: the largest of each answer's median
        # over the steps and of each step's median over the answers, so a
        # fault in one answer through most steps, or in most answers at
        # one step, shows; a gap's rare spikes do not
        return float(torch.maximum(t.median(0).values.max(), t.median(1).values.max()))
    t = t.flatten()
    if how == "max":
        return float(t.max())
    if how == "first":  # e.g. the first of a run of steps
        return float(t[0])
    if how.startswith("q"):  # a quantile, e.g. q0.9
        return float(torch.quantile(t, float(how[1:])))
    raise ValueError(f"unknown statistic {how!r}")


def numbers(gaps: dict, settings: dict) -> list:
    """[(name, value, limit)] in the settings' order; a value that is not a
    number (a NaN from the program) reads as infinite."""
    out = []
    for name, rule in settings["limits"].items():
        v = _stat(gaps[name], rule["stat"])
        out.append((name, v if math.isfinite(v) else math.inf, float(rule["limit"])))
    return out


def passed(nums: list) -> bool:
    return all(v <= lim for _, v, lim in nums)


def failed_items(gaps: dict, settings: dict) -> int:
    """How many answers (the last axis of a gap: clouds, or leaves and
    steps) the failing numbers find over their limits, summed over the
    numbers (a number that passes finds none, also where some answers
    exceed its limit at some steps)."""
    total = 0
    for name, rule in settings["limits"].items():
        lim = float(rule["limit"])
        if _stat(gaps[name], rule["stat"]) <= lim:
            continue
        g = gaps[name].detach().double()
        if rule["stat"] == "median_max":
            # the answers wrong through most steps, else those wrong at the
            # step that most answers get wrong
            per = g.median(0).values
            if bool((per <= lim).all()):
                per = g[g.median(1).values.argmax()]
        else:
            per = g.reshape(-1, g.shape[-1]).amax(0) if g.dim() > 1 else g
        total += int((~(per <= lim)).sum())
    return total
