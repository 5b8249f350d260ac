"""Row 6: PointNet's three fused pools (pool_fwd_kernel), each a step: the
two T-Nets' last point layer (one tap) and conv5 (its kernel's taps), at
the configuration's widths."""
from benchmark.bounds import F4, attack, pools, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "pool_fwd", r"pool_fwd_kernel", "victim", True, 0
MAX_TIES = 4


def bound_s(layout, rates):
    if not attack(layout, "PointNet"):
        return None
    b, n = layout["b"], layout["n"]
    total = 0.0
    for cin, cout, taps in pools(layout["config"]):
        nbytes = F4 * (b * n * cin + taps * cin * cout + cout + b * cout * (2 + MAX_TIES))
        total += seconds(nbytes, 2.0 * b * n * cin * cout * taps, rates)
    return total
