"""Row 12: farthest-point sampling (fps_rounds), once a level a step: the
cloud read, the indices written, 9 operations a (point, round)."""
from benchmark import arch
from benchmark.bounds import F4, attack, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "fps", r"fps_rounds", "victim", True, 0


def bound_s(layout, rates):
    if not attack(layout, "PointNetPP_MSG"):
        return None
    b, n, total = layout["b"], layout["n"], 0.0
    for m in (lv["npoint"] for lv in arch.msg_levels(layout["config"])):
        total += seconds(F4 * b * (3 * n + m), 9.0 * b * n * (m - 1), rates)
        n = m
    return total
