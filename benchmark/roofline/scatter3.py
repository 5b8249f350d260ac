"""Row 2: the o2a gather's backward (scatter3_kernel), once a step."""
from benchmark.bounds import F4, attack, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "scatter3", r"scatter3_(global_)?kernel", "losses", True, 0


def bound_s(layout, rates):
    if not attack(layout):
        return None
    b, n = layout["b"], layout["n"]
    return seconds(F4 * b * (n + 3 * n + 3 * n), 3.0 * b * n, rates)
