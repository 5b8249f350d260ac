"""The victim's train step in plain PyTorch (PointNet++ MSG; the reference's
main_train.py as the port states it): the train-mode forward with batch
statistics (mean and biased variance over every row of a layer, the running
statistics moved as m * old + (1 - m) * batch with m = 1 - momentum), the
head's dropout from given keep masks, label-smoothing cross entropy (0.2),
then Adam with L2 weight decay added to the gradient (PyTorch's Adam:
eps outside the root, bias-corrected step size).

`train_steps` runs the steps from a state dict in the dtype of its tensors
and returns, for each step, the loss, and after the first step the
gradients as the optimiser took them and the state, and after the last the
parameters and running statistics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import pointnetpp
from benchmark.reference import geometry as G


def _bn_train(x, p, name, momentum, stats, eps):
    rows = x.reshape(-1, x.shape[-1])
    mean = rows.mean(0)
    xc = rows - mean
    var = (xc * xc).mean(0)
    y = xc * (torch.rsqrt(var + eps) * p[f"{name}.weight"]) + p[f"{name}.bias"]
    m = 1.0 - momentum
    stats[f"{name}.running_mean"] = m * p[f"{name}.running_mean"] + (1 - m) * mean.detach()
    stats[f"{name}.running_var"] = m * p[f"{name}.running_var"] + (1 - m) * var.detach()
    return y.reshape(x.shape)


def _mlp(x, p, pre, momentum, stats, eps):
    j = 0
    while f"{pre}.{3 * j}.weight" in p:
        x = x @ p[f"{pre}.{3 * j}.weight"][:, :, 0, 0].t()
        x = torch.relu(_bn_train(x, p, f"{pre}.{3 * j + 1}", momentum, stats, eps))
        j += 1
    return x


def msg_train_logits(cfg, p, x, keep, momentum, stats, sel=None):
    """Train-mode logits of PointNet++ MSG (configuration `cfg`) at x [b, n,
    3]; `keep` the head's dropout keep mask [b, 256] (p = the
    configuration's dropout); the new running statistics go into `stats`."""
    eps, drop = cfg["bn_eps"], cfg["dropout"]
    if sel is None:
        sel = pointnetpp.select(cfg, x.float())
    xyz, feats = x, None
    for i, (idx, balls) in enumerate(sel):
        new = G.gather_pts(xyz, idx)
        outs = []
        for s, bq in enumerate(balls):
            gx = G.gather_pts(xyz, bq) - new[:, :, None, :]
            h = gx if feats is None else torch.cat([gx, G.gather_pts(feats, bq)], -1)
            outs.append(_mlp(h, p, f"SA_modules.{i}.mlps.{s}", momentum, stats, eps).amax(2))
        xyz, feats = new, torch.cat(outs, -1)
    h = _mlp(torch.cat([xyz, feats], -1)[:, None], p, "SA_modules.2.mlps.0", momentum,
             stats, eps).amax(2)[:, 0]
    h = torch.relu(_bn_train(h @ p["fc_layer.0.weight"].t(), p, "fc_layer.1", momentum,
                             stats, eps))
    h = torch.relu(_bn_train(h @ p["fc_layer.3.weight"].t(), p, "fc_layer.4", momentum,
                             stats, eps))
    h = torch.where(keep, h / (1 - drop), torch.zeros_like(h))
    return h @ p["fc_layer.7.weight"].t() + p["fc_layer.7.bias"]


def train_steps(cfg: dict, params: dict, batches: list, lr: float, wd: float,
                momentum: float, smoothing: float = 0.2, loss_rows: int = None) -> dict:
    """batches: [(pc [b, n, 3] float32, target [b], keep [b, 256])];
    `loss_rows` takes the loss over the first rows only (a planted fault)."""
    leaves = [k for k, v in params.items()
              if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))]
    state = {k: v.clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(state[k]) for k in leaves}
    nu = {k: torch.zeros_like(state[k]) for k in leaves}
    out = {"loss": []}
    for t, (pc, target, keep) in enumerate(batches, start=1):
        p = {k: (v.detach().requires_grad_(True) if k in leaves else v)
             for k, v in state.items()}
        stats = {}
        x = pc.to(next(iter(params.values())).dtype)
        logits = msg_train_logits(cfg, p, x, keep, momentum, stats)
        rows = slice(None, loss_rows)
        loss = F.cross_entropy(logits[rows], target[rows], label_smoothing=smoothing)
        grads = torch.autograd.grad(loss, [p[k] for k in leaves])
        out["loss"].append(loss.detach())
        bc1, bc2 = 1 - 0.9 ** t, 1 - 0.999 ** t
        g_opt = {}
        with torch.no_grad():
            for k, g in zip(leaves, grads):
                g = g + wd * state[k]
                g_opt[k] = g
                mu[k] = 0.9 * mu[k] + 0.1 * g
                nu[k] = 0.999 * nu[k] + 0.001 * g * g
                denom = nu[k].sqrt() / bc2 ** 0.5 + 1e-8
                state[k] = state[k] - (lr / bc1) * mu[k] / denom
            state.update(stats)
        if t == 1:
            out["grad"] = g_opt
            out["state1"] = {k: v.clone() for k, v in state.items()}
    out["state"] = state
    out["leaves"] = leaves
    return out
