"""Row 16's backward (group_mlp_bwd_tiles), once a scale a step: the
forward's recompute is counted (the products of the cotangent rows are
data), the grouped input read and its gradient written."""
from benchmark.bounds import F4, attack, mlp_flops, mlp_weight_bytes, seconds
from benchmark.plugins import HERE, load

NAME, PATTERN, LAYER, PORT, ORDER = "group_mlp_bwd", r"group_mlp_bwd_tiles", "victim", True, 0


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    fwd = load(HERE / "roofline" / "group_mlp_fwd.py")
    total = 0.0
    for rows, w, groups in fwd.calls(layout):
        nbytes = F4 * (2 * rows * w[0] + 3 * groups * w[-1]) + 2 * mlp_weight_bytes(w)
        total += seconds(nbytes, mlp_flops(rows, w), rates)
    return total
