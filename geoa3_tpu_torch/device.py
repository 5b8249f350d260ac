"""Where an entry point runs, and the float32 contract of the port.

The port computes in float32 throughout (ROADMAP.md): TF32 is off in both
cuBLAS and cuDNN. PointNet's conv5 goes through cuDNN wherever it is not
fused into the pool kernel (under a point mask), and cuDNN allows TF32 by
default, so every entry point turns it off here.
"""

from __future__ import annotations

import torch


def float32_exact() -> None:
    """Turn TF32 off for matrix products (cuBLAS) and convolutions (cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def entry_device(name: str) -> torch.device:
    """The device an entry point's `--device` names, with TF32 turned off. A
    CUDA device without a card raises: an entry point never carries on on
    the CPU unless it is asked to."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (pass --device cpu "
            "to run on the CPU)"
        )
    float32_exact()
    return device
