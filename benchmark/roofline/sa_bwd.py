"""Row 17's backward (sa_bwd_tiles), once a scale a step: the recompute of
layers 2-3 is counted (the cotangent rows are data)."""
from benchmark.bounds import F4, attack, mlp_flops, mlp_weight_bytes, msg_scales, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "sa_bwd", r"sa_bwd_tiles", "victim", True, 0


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    b, total = layout["b"], 0.0
    for lvl, n, m, ns, cf, w in msg_scales(layout):
        if lvl == 1:
            nbytes = (F4 * b * (2 * n * w[1] + 2 * m * w[1] + m * ns + 3 * m * w[-1])
                      + 2 * mlp_weight_bytes(w[1:]))
            total += seconds(nbytes, mlp_flops(b * m * ns, w[1:]), rates)
    return total
