"""The attack step's algorithmic FLOPs (benchmark/flops.py) over the traced
step time, as a share of the card's float32 peak."""
from benchmark.layers import mfu_percent


def read(ctx):
    return mfu_percent(ctx, "attack")
