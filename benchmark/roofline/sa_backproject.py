"""Row 17's back-projections (backproject_kernel) of MSG SA2's scales, once
a scale a step."""
from benchmark.bounds import F4, attack, msg_scales, seconds

NAME, PATTERN, LAYER, PORT, ORDER = ("sa_backproject", r"backproject_kernel", "victim",
                                     True, 0)


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    b, total = layout["b"], 0.0
    for lvl, n, m, ns, cf, w in msg_scales(layout):
        if lvl == 1:
            c0, c1 = w[0], w[1]
            nbytes = F4 * (b * n * c1 + b * m * c1 + c0 * c1 + b * n * c0 + b * m * 3)
            total += seconds(nbytes, 2.0 * b * (n * c0 * c1 + m * 3 * c1), rates)
    return total
