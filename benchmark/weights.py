"""Random victim weights made on the device from the seed.

No checkpoint ships, so every parameter and BatchNorm statistic is drawn:
one uniform draw of all of them at once from a `torch.Generator` on the
device, then each leaf scaled in place. Conv and Linear weights and biases
are U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's default range); BatchNorm
scales 1 +- 0.1, shifts and running means +- 0.1, running variances in
[0.5, 1.5). A T-Net's last layer keeps the identity in its bias, as the
victim is built.
"""

from __future__ import annotations

import torch


def _fan_in(shapes, name):
    layer = name.rsplit(".", 1)[0]
    w = shapes[f"{layer}.weight"][0]
    fan = 1
    for s in w[1:]:
        fan *= s
    return fan


def make(shapes: dict, seed: int, device) -> dict:
    """{name: tensor} for `shapes` ({name: (shape, dtype)}, the victim's
    state dict's as the configuration states it, `arch.state_shapes`), drawn from `seed` on `device`, floating leaves in
    float32 (the reference takes them exactly in float64)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    floats = [k for k, (_, dt) in shapes.items() if dt.is_floating_point]
    sizes = [int(torch.Size(shapes[k][0]).numel()) for k in floats]
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for k, size in zip(floats, sizes):
        v = u[at:at + size].view(shapes[k][0])
        at += size
        layer, leaf = k.rsplit(".", 1)
        bn = f"{layer}.running_var" in shapes
        if leaf == "running_var":
            v = 0.5 + v
        elif bn:
            v = (1.0 if leaf == "weight" else 0.0) + 0.2 * (v - 0.5)
        else:
            v = (2.0 * v - 1.0) / _fan_in(shapes, k) ** 0.5
            if leaf == "bias" and layer.endswith("transform.fc3"):
                kk = int(round(size ** 0.5))
                v = v + torch.eye(kk, device=device).reshape(-1)
        out[k] = v
    for k, (shape, dt) in shapes.items():
        if not dt.is_floating_point:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
    return out

