"""Row 7: the pools' input gradient (pool_bwd_gather, float32), each a
step: g, the counts and recorded rows and w3t read once, dx written once;
one product row a (cloud, column) (ties are data)."""
from benchmark.bounds import F4, attack, pools, seconds

NAME, PATTERN, LAYER, PORT, ORDER = ("pool_bwd", r"pool_bwd_gather.*GatherF32", "victim",
                                     True, 0)
MAX_TIES = 4


def bound_s(layout, rates):
    if not attack(layout, "PointNet"):
        return None
    b, n = layout["b"], layout["n"]
    total = 0.0
    for cin, cout, taps in pools(layout["config"]):
        nbytes = F4 * (b * cout * (2 + MAX_TIES) + b * n * cin + taps * cin * cout)
        total += seconds(nbytes, 2.0 * b * cout * taps * cin, rates)
    return total
