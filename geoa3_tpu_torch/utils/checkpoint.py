"""Victim checkpoints of the port (counterpart of
geoa3_tpu/utils/checkpoint.py:load_victim_variables).

The port reads PyTorch files: the reference's `model_best.pth.tar` /
`checkpoint.pth.tar` (a dict with a `state_dict` entry, possibly with
DataParallel "module." prefixes) and a plain `torch.save`d `state_dict`. The
JAX package's own `.msgpack` checkpoints are decoded by flax, which this
package must not import: they are refused, with the way across named.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

CANDIDATES = ("model_best.pth.tar", "checkpoint.pth.tar", "model_best.pt",
              "checkpoint.pt")
_MSGPACK_HELP = (
    "{path} is a flax msgpack checkpoint of the JAX package, which the "
    "PyTorch port cannot decode (flax imports JAX). Load it with the JAX "
    "package, pass the variables as numpy through "
    "geoa3_tpu_torch/models/convert.py:from_flax_variables, and torch.save "
    "the resulting state_dict"
)


def load_victim_state(path_or_dir: str, arch: str = "PointNet") -> Dict[str, torch.Tensor]:
    """A victim's `state_dict` (CPU tensors, "module." prefixes stripped)
    from a checkpoint file, or from the first of model_best.pth.tar,
    checkpoint.pth.tar, model_best.pt, checkpoint.pt in a directory
    (reference main_attack.py:133-147). Load it into a model with
    models.convert.load_reference_state_dict."""
    if arch != "PointNet":
        raise NotImplementedError(
            f"{arch} is not ported yet (PointNet++ is queued in ROADMAP.md)"
        )
    path = path_or_dir
    if os.path.isdir(path):
        found = [c for c in CANDIDATES if os.path.isfile(os.path.join(path, c))]
        if not found:
            packs = [f for f in sorted(os.listdir(path)) if f.endswith(".msgpack")]
            if packs:
                raise ValueError(
                    _MSGPACK_HELP.format(path=os.path.join(path, packs[0]))
                )
            raise FileNotFoundError(
                f"no checkpoint in {path} (looked for {', '.join(CANDIDATES)})"
            )
        path = os.path.join(path, found[0])
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if path.endswith(".msgpack"):
        raise ValueError(_MSGPACK_HELP.format(path=path))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else None
    if not isinstance(state, dict) or not all(
        isinstance(v, torch.Tensor) for v in state.values()
    ):
        raise ValueError(
            f"{path} holds no state_dict of tensors (expected a torch.save'd "
            "state_dict, or a dict with a 'state_dict' entry)"
        )
    return {k.removeprefix("module."): v for k, v in state.items()}
