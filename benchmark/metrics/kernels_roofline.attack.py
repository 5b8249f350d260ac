"""The program's kernels' share of their roofline in a traced attack step:
the sum of the groups' bounds at the cell's shapes over the sum of their
device time (benchmark/layers.py)."""
from benchmark.layers import roofline_percent


def read(ctx):
    return roofline_percent(ctx, "attack")
