"""Row 4: the curvature term and its gradient from the mask
(curv_term_kernel), once a step: 60 operations a (point, member)."""
from benchmark.bounds import F4, attack, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "curv_term", r"curv_term_kernel", "losses", True, 0


def bound_s(layout, rates):
    if not attack(layout):
        return None
    b, n, k = layout["b"], layout["n"], layout["k"]
    nbytes = F4 * b * (3 * n + 3 * n + n + 1 + 3 * n) + b * n * n
    return seconds(nbytes, 60.0 * b * n * (k + 1), rates)
