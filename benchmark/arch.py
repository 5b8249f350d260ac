"""The victim's shapes as its configuration file states them.

The configuration (configs/<name>.json) is the one source of the widths: the
state dict a run expects, the levels of PointNet++ MSG, the FLOP and byte
counts and the plain reference all come from it. A run fails where the
program's model has another state dict (`check_model`), so a change of the
program's widths cannot pass for the published ones.
"""

from __future__ import annotations

import torch

F32, I64 = torch.float32, torch.int64


def _bn(name, c):
    return {f"{name}.weight": ((c,), F32), f"{name}.bias": ((c,), F32),
            f"{name}.running_mean": ((c,), F32), f"{name}.running_var": ((c,), F32),
            f"{name}.num_batches_tracked": ((), I64)}


def _pointnet_tnet(pre, k, widths):
    c1, c2, c3, f1, f2 = widths
    out = {}
    for i, (cin, cout) in enumerate(((k, c1), (c1, c2), (c2, c3)), start=1):
        out[f"{pre}.conv{i}.weight"] = ((cout, cin, 1), F32)
        out[f"{pre}.conv{i}.bias"] = ((cout,), F32)
    for i, (cin, cout) in enumerate(((c3, f1), (f1, f2), (f2, k * k)), start=1):
        out[f"{pre}.fc{i}.weight"] = ((cout, cin), F32)
        out[f"{pre}.fc{i}.bias"] = ((cout,), F32)
    for i, c in enumerate((c1, c2, c3, f1, f2), start=1):
        out.update(_bn(f"{pre}.bn{i}", c))
    return out


def pointnet_shapes(cfg: dict) -> dict:
    conv, c5, head = cfg["conv"], cfg["conv5"], cfg["head"]
    out = _pointnet_tnet("input_transform", 3, cfg["input_tnet"])
    out.update(_pointnet_tnet("feature_transform", conv[1], cfg["feature_tnet"]))
    cins = [3] + conv[:-1]
    for i, (cin, cout) in enumerate(zip(cins, conv), start=1):
        out[f"conv{i}.weight"] = ((cout, cin, 1), F32)
        out[f"conv{i}.bias"] = ((cout,), F32)
    out["conv5.weight"] = ((c5["width"], conv[-1], c5["kernel"]), F32)
    out["conv5.bias"] = ((c5["width"],), F32)
    for i, c in enumerate(conv + [c5["width"]], start=1):
        out.update(_bn(f"bn{i}", c))
    fcs = list(zip([c5["width"]] + head, head + [cfg["classes"]]))
    for i, (cin, cout) in enumerate(fcs, start=1):
        out[f"fc{i}.weight"] = ((cout, cin), F32)
        out[f"fc{i}.bias"] = ((cout,), F32)
    for i, c in enumerate(head, start=len(conv) + 2):
        out.update(_bn(f"bn{i}", c))
    return out


def msg_levels(cfg: dict) -> list:
    """[{"npoint", "radii", "nsamples", "mlps", "cin"}] of MSG's grouped
    levels (cin: the width of a grouped row, coordinates first)."""
    if not cfg["use_xyz"]:
        raise ValueError("the benchmark's MSG groups coordinates with features (use_xyz)")
    out, feats = [], 3 if cfg["use_normal"] else 0
    for key in ("sa1", "sa2"):
        lv = cfg[key]
        out.append(dict(npoint=lv["npoint"], radii=tuple(lv["radii"]),
                        nsamples=tuple(lv["nsamples"]),
                        mlps=tuple(tuple(m) for m in lv["mlps"]), cin=3 + feats))
        feats = sum(m[-1] for m in lv["mlps"])
    return out


def group_all_widths(cfg: dict) -> tuple:
    """(cin, c1, c2, c3) of the GroupAll level."""
    return (3 + sum(m[-1] for m in cfg["sa2"]["mlps"]),) + tuple(cfg["group_all"])


def _shared_mlp(pre, widths):
    out = {}
    for j, (cin, cout) in enumerate(zip(widths[:-1], widths[1:])):
        out[f"{pre}.{3 * j}.weight"] = ((cout, cin, 1, 1), F32)
        out.update(_bn(f"{pre}.{3 * j + 1}", cout))
    return out


def msg_shapes(cfg: dict) -> dict:
    out = {}
    for i, lv in enumerate(msg_levels(cfg)):
        for s, m in enumerate(lv["mlps"]):
            out.update(_shared_mlp(f"SA_modules.{i}.mlps.{s}", (lv["cin"],) + m))
    out.update(_shared_mlp("SA_modules.2.mlps.0", group_all_widths(cfg)))
    (h1, h2), c = cfg["head"], cfg["group_all"][-1]
    out["fc_layer.0.weight"] = ((h1, c), F32)
    out.update(_bn("fc_layer.1", h1))
    out["fc_layer.3.weight"] = ((h2, h1), F32)
    out.update(_bn("fc_layer.4", h2))
    out["fc_layer.7.weight"] = ((cfg["classes"], h2), F32)
    out["fc_layer.7.bias"] = ((cfg["classes"],), F32)
    return out


def state_shapes(cfg: dict) -> dict:
    """{name: (shape, dtype)} of the victim's state dict as the
    configuration states it."""
    if cfg["arch"] == "PointNet":
        return pointnet_shapes(cfg)
    if cfg["arch"] == "PointNetPP_MSG":
        return msg_shapes(cfg)
    raise ValueError(f"no shapes for {cfg['arch']}")


def check_model(model: torch.nn.Module, cfg: dict) -> dict:
    """The configuration's shapes, after checking that `model`'s state dict
    has exactly these; raises where it differs."""
    want = state_shapes(cfg)
    got = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    diff = sorted(k for k in want.keys() | got.keys() if want.get(k) != got.get(k))
    if diff:
        shown = "; ".join(f"{k}: config {want.get(k)}, program {got.get(k)}"
                          for k in diff[:6])
        raise RuntimeError(f"the program's {cfg['arch']} differs from "
                           f"{cfg['name']}.json in {len(diff)} entries: {shown}")
    return want
