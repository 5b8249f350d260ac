"""Row 15's forward: the fused ball query and grouping (ballquery_fwd) of
MSG's SA1 scales, once each a step: coordinates and centres read, indices
and grouped coordinates written (the scan is data: bytes only)."""
from benchmark.bounds import F4, attack, msg_scales, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "ballquery_fwd", r"ballquery_fwd", "victim", True, 0


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    b, total = layout["b"], 0.0
    for lvl, n, m, ns, cf, _ in msg_scales(layout):
        if lvl == 0:
            total += seconds(F4 * b * (3 * n + 3 * m + m * ns * 4), 0.0, rates)
    return total
