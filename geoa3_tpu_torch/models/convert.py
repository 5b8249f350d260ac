"""Carry PointNet weights into the port.

Two sources:
  * `from_flax_variables`: the JAX package's flax variable tree (as numpy)
    -> a `state_dict` of models.pointnet.PointNet;
  * `load_reference_state_dict`: a reference PyTorch PointNet state_dict
    (the key names that geoa3_tpu/models/convert.py:82-101 reads), which the
    port's module names match one for one.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TNET_DENSE = ("conv1", "conv2", "conv3", "fc1", "fc2", "fc3")
_TNET_BN = ("bn1", "bn2", "bn3", "bn4", "bn5")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(sd: dict, name: str, p: Mapping[str, Any], conv: bool) -> None:
    """flax Dense {kernel [cin, cout], bias} -> Linear [cout, cin] or
    kernel-1 Conv1d [cout, cin, 1]."""
    w = _t(p["kernel"]).T.contiguous()
    sd[f"{name}.weight"] = w[..., None] if conv else w
    sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: dict, name: str, p: Mapping[str, Any], s: Mapping[str, Any]) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """geoa3_tpu PointNet variables {params, batch_stats} (numpy leaves) ->
    PointNet state_dict.

    Dense kernels transpose to [cout, cin]; conv5's flax Conv kernel
    [3, cin, cout] becomes the Conv1d weight [cout, cin, 3] by a transpose
    alone (both are cross-correlations: no tap flip); BatchNorm
    scale/bias/mean/var become weight/bias/running_mean/running_var.
    """
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for tn in ("input_transform", "feature_transform"):
        for layer in _TNET_DENSE:
            _dense(sd, f"{tn}.{layer}", params[tn][layer], layer.startswith("conv"))
        for bn in _TNET_BN:
            _bn(sd, f"{tn}.{bn}", params[tn][bn], stats[tn][bn])
    for layer in ("conv1", "conv2", "conv3", "conv4"):
        _dense(sd, layer, params[layer], conv=True)
    k = _t(params["conv5"]["kernel"])  # [3, cin, cout]
    sd["conv5.weight"] = k.permute(2, 1, 0).contiguous()
    sd["conv5.bias"] = _t(params["conv5"]["bias"])
    for layer in ("fc1", "fc2", "fc3"):
        _dense(sd, layer, params[layer], conv=False)
    for bn in ("bn1", "bn2", "bn3", "bn4", "bn5", "bn6", "bn7"):
        _bn(sd, bn, params[bn], stats[bn])
    return sd


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a reference PyTorch PointNet state_dict (tensors or numpy arrays,
    optionally with DataParallel "module." prefixes) into `model`. Every
    parameter and BatchNorm statistic must be present; only the
    `num_batches_tracked` counters may be missing."""
    state = {
        k.removeprefix("module."): (
            v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        )
        for k, v in sd.items()
    }
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(
            f"state_dict mismatch: missing {missing}, unexpected {unexpected}"
        )
