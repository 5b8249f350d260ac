"""Device ms a traced attack step in the victim's kernel groups (pools,
grouped MLPs, whole-scale set abstraction, ball queries, FPS, scatters,
matrix products)."""
from benchmark.layers import layer_ms_per_step


def read(ctx):
    return layer_ms_per_step(ctx, "victim")
