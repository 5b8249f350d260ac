"""Share of the traced train window in which no device operation ran."""
from benchmark.layers import idle_share


def read(ctx):
    return idle_share(ctx, "train")
