"""Row 5: the clean cloud's curvature with its selection
(kappa_select_kernel<true>), once a batch."""
from benchmark.bounds import F4, attack, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "kappa_fwd", r"kappa_select_kernel<true", "losses", True, 0


def bound_s(layout, rates):
    if not attack(layout):
        return None
    b, n, k = layout["b"], layout["n"], layout["k"]
    nbytes = F4 * b * (3 * n + 3 * n + n) + b * n * n
    return seconds(nbytes, 11.0 * b * n * n + 20.0 * b * n * k, rates) / layout["batch_steps"]
