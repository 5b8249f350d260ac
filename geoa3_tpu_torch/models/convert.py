"""Carry victim weights into the port.

Two sources:
  * `from_flax_variables`: the JAX package's flax variable tree (as numpy)
    -> a `state_dict` of models.pointnet.PointNet or, for a PointNet++ tree
    (`SA{i}`/`head`), of models.pointnetpp.PointNet2ClassificationSSG or
    PointNet2ClassificationMSG (the walk is the same for one scale a level
    or three);
  * `load_reference_state_dict`: a reference PyTorch state_dict (the key
    names that geoa3_tpu/models/convert.py:82-163 reads), which the port's
    module names match one for one.
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


def pointnetpp_from_flax_variables(
    variables: Mapping[str, Any],
) -> Dict[str, torch.Tensor]:
    """geoa3_tpu PointNet++ variables {params, batch_stats} (numpy leaves)
    -> a state_dict with the reference's names: `SA{i}/mlp{j}/conv{k}`
    becomes the bias-free Conv2d `SA_modules.{i}.mlps.{j}.{3k}` (kernel
    [cin, cout] -> weight [cout, cin, 1, 1]) and `bn{k}` the BatchNorm2d
    `{3k+1}`; the head's fc0/bn0/fc1/bn1/fc2 become `fc_layer.{0,1,3,4,7}`
    (the inverse of geoa3_tpu/models/convert.py:103-163)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for sa in sorted(k for k in params if k.startswith("SA")):
        for mlp in sorted(params[sa]):
            prefix = f"SA_modules.{int(sa[2:])}.mlps.{int(mlp[3:])}"
            convs = sorted(k for k in params[sa][mlp] if k.startswith("conv"))
            for conv in convs:
                k = int(conv[4:])
                w = _t(params[sa][mlp][conv]["kernel"]).T.contiguous()
                sd[f"{prefix}.{3 * k}.weight"] = w[..., None, None]
                _bn(sd, f"{prefix}.{3 * k + 1}", params[sa][mlp][f"bn{k}"],
                    stats[sa][mlp][f"bn{k}"])
    head, hstats = params["head"], stats["head"]
    sd["fc_layer.0.weight"] = _t(head["fc0"]["kernel"]).T.contiguous()
    _bn(sd, "fc_layer.1", head["bn0"], hstats["bn0"])
    sd["fc_layer.3.weight"] = _t(head["fc1"]["kernel"]).T.contiguous()
    _bn(sd, "fc_layer.4", head["bn1"], hstats["bn1"])
    _dense(sd, "fc_layer.7", head["fc2"], conv=False)
    return sd


def from_flax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """geoa3_tpu victim variables {params, batch_stats} (numpy leaves) ->
    the port's state_dict: PointNet's, or PointNet++'s for a tree with set
    abstraction levels (`pointnetpp_from_flax_variables`).

    Dense kernels transpose to [cout, cin]; conv5's flax Conv kernel
    [3, cin, cout] becomes the Conv1d weight [cout, cin, 3] by a transpose
    alone (both are cross-correlations: no tap flip); BatchNorm
    scale/bias/mean/var become weight/bias/running_mean/running_var.
    """
    params, stats = variables["params"], variables["batch_stats"]
    if "SA0" in params:
        return pointnetpp_from_flax_variables(variables)
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
    """Load a reference PyTorch victim state_dict (tensors or numpy arrays,
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
