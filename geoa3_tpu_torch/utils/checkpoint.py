"""Checkpoints of the port (counterpart of geoa3_tpu/utils/checkpoint.py;
reference main_train.py:107-110, 167-178).

The trainer writes the reference's layout: `checkpoint.pth.tar` every epoch,
copied to `model_best.pth.tar` on a new best. Each file is a dict of
`epoch`, `state_dict` (the model's), `optimizer` (torch Adam's state_dict),
`best_prec` and `class_prec`: tensors and Python scalars only, so that it
loads with `torch.load(..., weights_only=True)`, and the names the victim
loaders of both packages read (`load_victim_state` here,
geoa3_tpu/utils/checkpoint.py:load_victim_variables there).

The port reads PyTorch files: the reference's `model_best.pth.tar` /
`checkpoint.pth.tar` (a dict with a `state_dict` entry, possibly with
DataParallel "module." prefixes) and a plain `torch.save`d `state_dict`. The
JAX package's own `.msgpack` checkpoints are decoded by flax, which this
package must not import: they are refused, with the way across named.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import torch

from geoa3_tpu_torch.models.convert import load_reference_state_dict
from geoa3_tpu_torch.models.registry import ARCHS, build_model

CKPT_NAME = "checkpoint.pth.tar"
BEST_NAME = "model_best.pth.tar"
CANDIDATES = (BEST_NAME, CKPT_NAME, "model_best.pt", "checkpoint.pt")
_MSGPACK_HELP = (
    "{path} is a flax msgpack checkpoint of the JAX package, which the "
    "PyTorch port cannot decode (flax imports JAX). Load it with the JAX "
    "package, pass the variables as numpy through "
    "geoa3_tpu_torch/models/convert.py:from_flax_variables, and torch.save "
    "the resulting state_dict"
)


def save_checkpoint(modeldir: str, state: Dict[str, Any], is_best: bool,
                    filename: str = CKPT_NAME) -> str:
    """Write `state` to modeldir/filename through a `.tmp` file moved into
    place, and copy it to model_best.pth.tar when `is_best` (reference
    main_train.py:107-110) -> the path written."""
    os.makedirs(modeldir, exist_ok=True)
    path = os.path.join(modeldir, filename)
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, os.path.join(modeldir, BEST_NAME))
    return path


def load_checkpoint(path_or_dir: str, best: bool = False) -> Optional[Dict[str, Any]]:
    """A checkpoint file, or a directory's checkpoint.pth.tar
    (model_best.pth.tar with `best`), loaded onto the CPU with
    weights_only=True; None where there is no such file (reference
    main_train.py:167-178)."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, BEST_NAME if best else CKPT_NAME)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def load_victim_state(path_or_dir: str, arch: str = "PointNet") -> Dict[str, torch.Tensor]:
    """A victim's `state_dict` (CPU tensors, "module." prefixes stripped)
    from a checkpoint file, or from the first of model_best.pth.tar,
    checkpoint.pth.tar, model_best.pt, checkpoint.pt in a directory
    (reference main_attack.py:133-147). Load it into a model with
    models.convert.load_reference_state_dict."""
    if arch not in ARCHS:
        raise ValueError(f"Not support such arch: {arch}")
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


def load_victim(arch: str, classes: int, npoint: int, checkpoint=None,
                device="cuda"):
    """(the victim `arch` in eval mode on `device` with its weights loaded,
    the checkpoint path): `checkpoint`, or Pretrained/{arch}/{npoint}/ as in
    the reference CLIs."""
    model = build_model(arch, classes, npoint, device=device)
    ckpt = checkpoint or os.path.join("Pretrained", arch, str(npoint))
    load_reference_state_dict(model, load_victim_state(ckpt, arch=arch))
    return model, ckpt
