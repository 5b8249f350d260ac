"""Shared arithmetic of the roofline groups (roofline/<group>.py).

A group's bound is the least time the chip could take for a step's launches
of the group at the cell's shapes: for each launch the larger of its bytes
over the memory rate and its operations over the float32 peak, each input
byte read once and each output byte written once. Where the work depends on
the data (rows that carry a cotangent, balls scanned), only the part that
does not is counted, so a bound is never above the work, and a share never
above 100% for that reason. The counts are a frozen copy of those the port's
kernel check (chip_smoke.py) states for each kernel.
"""

from __future__ import annotations

from benchmark import arch

F4 = 4  # bytes of a float32 or an int32


def seconds(nbytes: float, flops: float, rates) -> float:
    flops_per_s, bytes_per_s = rates
    return max(nbytes / bytes_per_s, flops / flops_per_s)


def attack(layout: dict, arch=None) -> bool:
    return layout["kind"] == "attack" and (arch is None or layout["arch"] == arch)


def msg_scales(layout: dict):
    """[(level, n, m, ns, cf, (c0, c1, c2, c3))] of MSG's grouped scales at
    the configuration's sizes (level 0: SA1, 1: SA2)."""
    cfg = layout["config"]
    out, n = [], cfg["npoint"]
    for lvl, lv in enumerate(arch.msg_levels(cfg)):
        m, cin = lv["npoint"], lv["cin"]
        for ns, widths in zip(lv["nsamples"], lv["mlps"]):
            out.append((lvl, n, m, ns, cin - 3, (cin,) + tuple(widths)))
        n = m
    return out


def pools(cfg: dict):
    """[(cin, cout, taps)] of PointNet's three max-pooled layers: the two
    T-Nets' last point layer and conv5."""
    c5 = cfg["conv5"]
    return [(w[1], w[2], 1) for w in (cfg["input_tnet"], cfg["feature_tnet"])] + [
        (cfg["conv"][-1], c5["width"], c5["kernel"])]


def mlp_flops(rows: int, widths) -> float:
    return 2.0 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def mlp_weight_bytes(widths) -> int:
    return F4 * sum(a * b + b for a, b in zip(widths[:-1], widths[1:]))
