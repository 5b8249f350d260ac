"""Row 17's forward: MSG SA2's whole scales (sa_query_kernel, sa_fwd_tiles,
sa_fwd_finish), once a scale a step: layers 2-3 over the grouped rows
(layer 1 is the projection group's), projections, indices and the pool."""
from benchmark.bounds import F4, attack, mlp_flops, mlp_weight_bytes, msg_scales, seconds

NAME, PATTERN, LAYER, PORT, ORDER = ("sa_fwd", r"sa_(query_kernel|fwd_tiles|fwd_finish)",
                                     "victim", True, 0)


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    b, total = layout["b"], 0.0
    for lvl, n, m, ns, cf, w in msg_scales(layout):
        if lvl == 1:
            nbytes = (F4 * b * (n * w[1] + m * w[1] + m * ns + 2 * m * w[-1])
                      + mlp_weight_bytes(w[1:]))
            total += seconds(nbytes, mlp_flops(b * m * ns, w[1:]), rates)
    return total
