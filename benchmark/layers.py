"""Arithmetic the per-layer readers share (metrics/<metric>.py). Each reader
gets the traced run's context: `summary` (trace.summarize), `layout` (the
driver's shapes), `step_flops`, `peaks` ((float32 FLOP/s, bytes/s) of the
card, or None), `groups` and `by_group` (plugins.groups / classify)."""

from __future__ import annotations


def idle_share(ctx, kind):
    if ctx["layout"]["kind"] != kind:
        return None
    s = ctx["summary"]
    return 1.0 - s["busy_s"] / s["window_s"]


def mfu_percent(ctx, kind):
    """The step's algorithmic FLOPs over the traced step time at the card's
    float32 peak, in percent."""
    if ctx["layout"]["kind"] != kind or ctx["peaks"] is None:
        return None
    s = ctx["summary"]
    return 100.0 * ctx["step_flops"] * s["steps"] / (s["window_s"] * ctx["peaks"][0])


def layer_ms_per_step(ctx, layer, kind="attack"):
    if ctx["layout"]["kind"] != kind:
        return None
    names = {g.NAME for g in ctx["groups"] if g.LAYER == layer}
    secs = sum(v[0] for k, v in ctx["by_group"].items() if k in names)
    return 1e3 * secs / ctx["summary"]["steps"]


def roofline_percent(ctx, kind):
    """Sum of the bounds over sum of the device time of the program's kernel
    groups that ran in the traced window and state a bound, in percent; a
    group that ran no operation drops out of both sums."""
    if ctx["layout"]["kind"] != kind or ctx["peaks"] is None:
        return None
    steps = ctx["summary"]["steps"]
    bound = spent = 0.0
    for g in ctx["groups"]:
        secs = ctx["by_group"].get(g.NAME, (0.0, 0))[0]
        if not g.PORT or secs <= 0:
            continue
        b = g.bound_s(ctx["layout"], ctx["peaks"])
        if b is None:
            continue
        bound += b * steps
        spent += secs
    return 100.0 * bound / spent if spent > 0 else None
