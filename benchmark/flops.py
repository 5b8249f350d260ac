"""Algorithmic FLOPs of a step, for the share of the chip's peak.

A copy of the port's FLOP model for PointNet's attack step
(geoa3_tpu_torch/utils/flops.py), extended to PointNet++ MSG and to the
train step. Conventions:
  * FLOPs = 2 x MACs of every matrix product and convolution; elementwise,
    BatchNorm, ReLU, pooling and selection work (FPS, ball queries, kNN
    rounds) earn no credit;
  * an attack step's backward counts input-gradient products only (the
    victim is frozen): a layer's dX = dY W^T costs its forward's MACs,
    except a layer whose output is max-pooled, where one row a pooled
    channel carries a cotangent: cout x cin MACs a pool (the port's
    utils/flops.py counts it dense, n x cout x cin, far above what the
    gradient needs);
  * a train step counts the forward, the weight gradients (each layer's
    forward MACs again) and the input gradients of every layer but the
    first;
  * the attack's geometry counts one [n, n] distance expansion each for the
    dual 1-NN and the kappa terms, the payload and scatter contractions at
    their logical widths;
  * the peak is float32's outside the tensor cores (TF32 is off).
"""

from __future__ import annotations

from benchmark import arch

# float32 peak FLOP/s outside the tensor cores and HBM bytes/s by a substring
# of the card's name (NVIDIA's H100 datasheet)
PEAKS = (
    ("H100 80GB HBM3", 67e12, 3.35e12),  # H100 SXM5
    ("H100 NVL", 60e12, 3.9e12),
    ("H100 PCIe", 51e12, 2.0e12),
)


def peaks(card: str):
    """(float32 FLOP/s, bytes/s) of a card, or None where unknown."""
    for sub, f, b in PEAKS:
        if sub in card:
            return f, b
    return None


def _tnet(n, K, widths):
    c1, c2, c3, f1, f2 = widths
    return [(n, K, c1), (n, c1, c2), (n, c2, c3, "pool"), (1, c3, f1), (1, f1, f2),
            (1, f2, K * K)]


def pointnet_layers(cfg: dict):
    """[(rows, cin, cout[, "pool"])] of every product of PointNet's forward
    at the configuration's widths; "pool" marks a layer whose output is
    max-pooled over its rows."""
    n, conv, c5 = cfg["npoint"], cfg["conv"], cfg["conv5"]
    fc = [c5["width"]] + cfg["head"] + [cfg["classes"]]
    return (_tnet(n, 3, cfg["input_tnet"]) + [(n, 3, 3), (n, 3, conv[0]), (n, conv[0], conv[1])]
            + _tnet(n, conv[1], cfg["feature_tnet"])
            + [(n, conv[1], conv[1]), (n, conv[1], conv[2]), (n, conv[2], conv[3]),
               (n, c5["kernel"] * conv[3], c5["width"], "pool")]
            + [(1, a, b) for a, b in zip(fc[:-1], fc[1:])])


def msg_layers(cfg: dict):
    """PointNet++ MSG's products at the configuration's widths. A grouped
    scale's first layer is linear in [coordinates - centre, features], so
    its least work is one product of every input point and one of every
    centre's coordinates, gathered to the groups (the port's whole-scale
    kernel computes it so)."""
    out, n = [], cfg["npoint"]
    for lv in arch.msg_levels(cfg):
        m = lv["npoint"]
        for ns, widths in zip(lv["nsamples"], lv["mlps"]):
            out += [(n, lv["cin"], widths[0]), (m, 3, widths[0])]
            c = widths[0]
            for j, w in enumerate(widths[1:], start=1):
                out.append((m * ns, c, w, "pool", m) if j == len(widths) - 1 else (m * ns, c, w))
                c = w
        n = m
    ga = arch.group_all_widths(cfg)
    for j, (c, w) in enumerate(zip(ga[:-1], ga[1:])):
        out.append((n, c, w, "pool") if j == len(ga) - 2 else (n, c, w))
    fc = [ga[-1]] + cfg["head"] + [cfg["classes"]]
    return out + [(1, a, b) for a, b in zip(fc[:-1], fc[1:])]


def _layers(cfg):
    return pointnet_layers(cfg) if cfg["arch"] == "PointNet" else msg_layers(cfg)


def _fwd(layer):
    return layer[0] * layer[1] * layer[2]


def _input_grad(layer):
    """MACs of a layer's dX: dense, or one row a pooled channel of each
    pooled group (a group of `groups` pools; 1 by default)."""
    if len(layer) == 3:
        return _fwd(layer)
    groups = layer[4] if len(layer) > 4 else 1
    return groups * layer[1] * layer[2]


def forward_macs(cfg: dict):
    return sum(_fwd(x) for x in _layers(cfg))


def attack_step(cfg: dict, batch: int) -> float:
    """FLOPs of one attack step: victim forward and input gradient (the two
    feature transforms' bmm also give dT, n K^2 each), and the geometry
    (n^2 x (3 + 8 + 3 + 6 + 6) MACs a cloud)."""
    n, layers = cfg["npoint"], _layers(cfg)
    fwd = sum(_fwd(x) for x in layers)
    bwd = sum(_input_grad(x) for x in layers)
    if cfg["arch"] == "PointNet":
        bwd += n * (3 * 3 + cfg["conv"][1] ** 2)
    geo = n * n * (3 + 8 + 3 + 6 + 6)
    return 2.0 * batch * (fwd + bwd + geo)


def train_step(cfg: dict, batch: int) -> float:
    """FLOPs of one train step: forward, weight gradients (each layer's
    forward MACs), and the input gradients of every layer but the first."""
    layers = _layers(cfg)
    fwd = sum(_fwd(x) for x in layers)
    return 2.0 * batch * (2 * fwd + sum(_input_grad(x) for x in layers[1:]))
