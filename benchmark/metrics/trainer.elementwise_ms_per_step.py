"""Device ms a traced train step in PyTorch's elementwise, reduction, fill
and copy kernels: the trainer's composed BatchNorm, dropout and optimiser
work."""
from benchmark.layers import layer_ms_per_step


def read(ctx):
    return layer_ms_per_step(ctx, "torch", kind="train")
