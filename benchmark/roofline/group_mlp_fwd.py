"""Row 16's forward: the grouped three-layer MLP and max (group_mlp_fwd_
tiles / _finish) of MSG's SA1 scales and GroupAll, once each a step."""
from benchmark import arch
from benchmark.bounds import F4, attack, mlp_flops, mlp_weight_bytes, msg_scales, seconds

NAME, PATTERN, LAYER, PORT, ORDER = ("group_mlp_fwd", r"group_mlp_fwd_(tiles|finish)",
                                     "victim", True, 0)


def calls(layout):
    """[(rows, widths, pooled groups)] of the launches a step."""
    b = layout["b"]
    scales = [s for s in msg_scales(layout) if s[0] == 0]
    out = [(b * m * ns, w, b * m) for lvl, n, m, ns, cf, w in scales]
    m2 = arch.msg_levels(layout["config"])[-1]["npoint"]
    return out + [(b * m2, arch.group_all_widths(layout["config"]), b)]


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    total = 0.0
    for rows, w, groups in calls(layout):
        nbytes = F4 * (rows * w[0] + 2 * groups * w[-1]) + mlp_weight_bytes(w)
        total += seconds(nbytes, mlp_flops(rows, w), rates)
    return total
