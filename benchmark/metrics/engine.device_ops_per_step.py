"""Device operations (kernels, copies, memsets) a traced attack step: what
CUDA graphs and fusion would cut."""


def read(ctx):
    if ctx["layout"]["kind"] != "attack":
        return None
    return ctx["summary"]["device_ops"] / ctx["summary"]["steps"]
