"""Device ms a traced attack step in the losses' kernel groups (dual 1-NN,
kappa selection and forward, curvature term, scatter_3)."""
from benchmark.layers import layer_ms_per_step


def read(ctx):
    return layer_ms_per_step(ctx, "losses")
