"""Row 3: the self-kNN selection mask (kappa_select_kernel<false>), once a
block of K steps: the cloud read, the [b, n, n] int8 mask written."""
from benchmark.bounds import F4, attack, seconds

NAME, PATTERN, LAYER, PORT, ORDER = ("kappa_select", r"kappa_select_kernel<false",
                                     "losses", True, 0)


def bound_s(layout, rates):
    if not attack(layout):
        return None
    b, n = layout["b"], layout["n"]
    return seconds(F4 * b * 3 * n + b * n * n, 11.0 * b * n * n, rates) / layout["refresh"]
