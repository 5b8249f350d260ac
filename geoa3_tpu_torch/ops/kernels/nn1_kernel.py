"""Dual 1-NN, with and without payload copies: CUDA kernel wrappers and
their plain versions.

Replaces geoa3_tpu/ops/pallas/nn1_kernel.py:_nn1_payload_kernel
(`nn1_dual_payload_pallas`) and :_nn1_dual_kernel (`nn1_dual_pallas`), exact
selection. Source: csrc/nn1.cu; the bare variant is the same tile kernel
with the copies compiled out of its finishing kernel, so both select the
same indices.

Bound on the H100: operations (b*n*m distance evaluations against a few MB
of inputs and outputs). One tile kernel computes each distance once and folds
it into both directions' minima (a column's row index is found after each
chunk by computing the winning row group's distances again); across blocks,
which run in no order, the minima meet as 64-bit (distance bits, index) keys
through `atomicMin`, a total order whose minimum is the lowest-index argmin,
so the fold the TPU kernel made in grid order gives the same bits in any
order. A finishing kernel decodes the keys and makes the copies. The wrapper
allocates the key scratch (b * (n + m) int64, set to all ones inside the C
entry) beside the outputs. Distances are rounded step by step like
`pairwise_sqdist`, so the kernel selects bitwise what the plain version does.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.distance import pairwise_sqdist
from geoa3_tpu_torch.ops.kernels import _build


def nn1_dual_payload_plain(adv, ori, payload):
    """Plain PyTorch version of `nn1_dual_payload` (same outputs)."""
    b, m = ori.shape[0], ori.shape[1]
    d = pairwise_sqdist(adv, ori)
    a2o = d.argmin(dim=-1).to(torch.int32)
    o2a = d.argmin(dim=-2).to(torch.int32)
    gp = torch.gather(
        payload, 2, a2o.long()[:, None, :].expand(-1, payload.shape[1], -1)
    )
    o2a_nn = torch.gather(adv, 1, o2a.long()[..., None].expand(-1, -1, 3))
    op = torch.cat(
        [o2a_nn.transpose(1, 2), adv.new_zeros(b, 5, m)], dim=1
    ).contiguous()
    return a2o, o2a, gp, op


def nn1_dual_plain(adv, ori):
    """Plain PyTorch version of `nn1_dual`."""
    d = pairwise_sqdist(adv, ori)
    return d.argmin(dim=-1).to(torch.int32), d.argmin(dim=-2).to(torch.int32)


def nn1_dual(adv, ori):
    """adv [b, n, 3], ori [b, m, 3] -> (a2o [b, n] int32, o2a [b, m] int32),
    the argmins of `nn1_dual_payload` without its copies. Not differentiable.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if not adv.is_cuda:
        return nn1_dual_plain(adv, ori)
    b, n, _ = adv.shape
    m = ori.shape[1]
    _build.check_cuda(adv, "adv", torch.float32, (b, n, 3))
    _build.check_cuda(ori, "ori", torch.float32, (b, m, 3))
    dev = adv.device
    keys = torch.empty(b * (n + m), dtype=torch.int64, device=dev)
    a2o = torch.empty(b, n, dtype=torch.int32, device=dev)
    o2a = torch.empty(b, m, dtype=torch.int32, device=dev)
    _build.launch("geoa3_nn1_dual", adv, ori, b, n, m, keys, a2o, o2a)
    nn1_dual.launches += 1
    return a2o, o2a


def nn1_dual_payload(adv, ori, payload):
    """adv [b, n, 3], ori [b, m, 3], payload [b, 8, m] ->
    (a2o [b, n] int32, o2a [b, m] int32, gp [b, 8, n], op [b, 8, m]).

    a2o[b, i] = argmin_j d(adv_i, ori_j), o2a[b, j] = argmin_i likewise
    (lowest index on ties); gp[b, p, i] = payload[b, p, a2o[b, i]];
    op[b, c, j] = adv[b, o2a[b, j], c] for c < 3, rows 3..7 zero. Not
    differentiable. CPU tensors take the plain version; CUDA tensors launch
    the kernel.
    """
    if not adv.is_cuda:
        return nn1_dual_payload_plain(adv, ori, payload)
    b, n, _ = adv.shape
    m = ori.shape[1]
    _build.check_cuda(adv, "adv", torch.float32, (b, n, 3))
    _build.check_cuda(ori, "ori", torch.float32, (b, m, 3))
    _build.check_cuda(payload, "payload", torch.float32, (b, 8, m))
    dev = adv.device
    keys = torch.empty(b * (n + m), dtype=torch.int64, device=dev)
    a2o = torch.empty(b, n, dtype=torch.int32, device=dev)
    o2a = torch.empty(b, m, dtype=torch.int32, device=dev)
    gp = torch.empty(b, 8, n, dtype=torch.float32, device=dev)
    op = torch.empty(b, 8, m, dtype=torch.float32, device=dev)
    _build.launch("geoa3_nn1_payload", adv, ori, payload, b, n, m, keys, a2o,
                  o2a, gp, op)
    nn1_dual_payload.launches += 1
    return a2o, o2a, gp, op


nn1_dual.launches = 0
nn1_dual_payload.launches = 0
