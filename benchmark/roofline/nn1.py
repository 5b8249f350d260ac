"""Row 1: the dual 1-NN with its payload copies (nn1_tile_kernel +
nn1_finish_kernel), once a step: 10 operations a pair of points."""
from benchmark.bounds import F4, attack, seconds

NAME, PATTERN, LAYER, PORT, ORDER = "nn1", r"nn1_(tile|finish)_kernel", "losses", True, 0


def bound_s(layout, rates):
    if not attack(layout):
        return None
    b, n = layout["b"], layout["n"]
    nbytes = F4 * b * (3 * n + 3 * n + 8 * n) + F4 * b * (n + n + 8 * n + 8 * n)
    return seconds(nbytes, 10.0 * b * n * n, rates)
