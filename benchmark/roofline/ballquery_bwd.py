"""Row 15's backward (ballquery_bwd) of MSG's SA1 scales, once each a step:
indices and grouped cotangents read, dxyz and dcentres written, one add a
grouped coordinate."""
from benchmark.bounds import F4, attack, msg_scales, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "ballquery_bwd", r"ballquery_bwd", "victim", True, 0


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    b, total = layout["b"], 0.0
    for lvl, n, m, ns, cf, _ in msg_scales(layout):
        if lvl == 0:
            nbytes = F4 * b * (m * ns * 4 + 3 * n + 3 * m)
            total += seconds(nbytes, 3.0 * b * m * ns, rates)
    return total
