#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (geoa3_tpu_torch) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository around the script. Phases:

  1. print the card's name and power limit; build the CUDA kernels (timed);
  2. hold every kernel against its plain PyTorch version at the paths'
     shapes (b=32, n=m=1024, k=16; PointNet's pools at [32, 1024, 128] ->
     1024; kNN also at m != n and at one query row), with the tolerance
     stated, and time both (CUDA events, warm, median of 20), plus one
     PyTorch library call where one computes the same function;
  3. run the default untargeted GeoA3 attack on PointNet (40 classes, 1024
     points, random weights with non-trivial BatchNorm statistics, 32
     synthetic clouds; CE + Chamfer + 0.1 Hausdorff + curvature k=16, Adam
     lr 0.01) for 1 x 50 Adam steps with the mask rebuilt every 10 steps,
     then 20 steps of exact mode (mask rebuilt every step, one selection and
     one curvature launch per step); and hold a short attack on the card
     against the same attack on the CPU (plain versions);
  4. the engine's side modes at the same width, 1 x 100 steps each: tangent
     jitter + projection + per-point clip (one kNN launch per jitter
     refresh; every successful cloud's offset rows within the clip), and
     partial-variable mode with SGD (one kappa forward and backward launch
     per step, one kNN launch per phase);
  5. the attack CLI in process on 40 synthetic clouds with a torch.save'd
     victim, into build/chip_smoke/: Mat/, PC/, attack_result.txt,
     attack_metrics.json, batches_done.txt, and a second run that must
     clear a planted stale file;
  6. print one JSON line listing the kernels, then the result line.

Every path runs with the kernels' launch counts set to 0 just before and
read just after, and fails if a kernel it names was not launched; together
the paths (and phase 2, for the two kernels that only public ops reach) must
cover every kernel. `--kernels-only` stops after phase 2.

Any failed check raises, and the script exits non-zero. It never falls back
to the CPU: without a CUDA device it exits non-zero before printing results.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
CIN, COUT = 128, 1024  # conv5's channels, the largest pool


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


if not (REPO / "geoa3_tpu_torch" / "csrc").is_dir():
    _fail(f"geoa3_tpu_torch/ not found beside {Path(__file__).name}")
sys.path.insert(0, str(REPO))
from geoa3_tpu_torch.workload import BATCH as B, KNN as K, NPOINT as N  # noqa: E402


def time_ms(fn, iters: int = 20, warm: int = 3) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb = nbytes / PEAK_BYTES * 1e3
    tf = flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check(name: str, err: float, tol: float, what: str) -> None:
    ok = err <= tol
    print(f"  {name}: {what} max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        _fail(f"{name} disagrees with its plain version ({what})")


def make_batch(torch, b: int, n: int, seed: int):
    from geoa3_tpu_torch.workload import synthetic_batch

    pc, nrm = synthetic_batch(b, n, seed)
    return pc, nrm, np.random.RandomState(seed + 1000)


def kernel_checks(torch) -> list[dict]:
    """Phase 2: every kernel against its plain version at main-path shapes."""
    import torch.nn.functional as F

    from geoa3_tpu_torch.ops.kernels import (
        kappa_kernel as kk,
        knn_kernel as qk,
        nn1_kernel as nk,
        pool_matmul_kernel as pk,
        scatter_kernel as sk,
    )

    out = []
    pc, nrm, rng = make_batch(torch, B, N, seed=0)
    adv = (pc + 0.01 * torch.from_numpy(
        rng.randn(B, N, 3).astype(np.float32)).cuda()).contiguous()

    def entry(name, source, replaces, err, ms, plain_ms, bound, library_ms,
              shape):
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms, "shape": shape,
        })

    # --- nn1 payload -------------------------------------------------------
    with torch.no_grad():
        kap0 = kk.kappa_fwd_plain(pc, nrm, K)[0]
    pay = torch.cat([pc.transpose(1, 2), nrm.transpose(1, 2), kap0[:, None],
                     torch.zeros_like(kap0)[:, None]], 1).contiguous()
    got = nk.nn1_dual_payload(adv, pc, pay)
    want = nk.nn1_dual_payload_plain(adv, pc, pay)
    torch.cuda.synchronize()
    for g, w, what in zip(got, want, ("a2o", "o2a", "gp", "op")):
        if not torch.equal(g, w):
            _fail(f"nn1_payload {what} is not bit-equal to the plain version "
                  f"({(g != w).sum().item()} entries differ)")
    print("  nn1_payload: a2o, o2a, gp, op bit-equal to plain (required)")
    pairs = B * N * N
    entry("nn1_payload", "geoa3_tpu_torch/csrc/nn1.cu",
          "geoa3_tpu/ops/pallas/nn1_kernel.py:200", 0.0,
          time_ms(lambda: nk.nn1_dual_payload(adv, pc, pay)),
          time_ms(lambda: nk.nn1_dual_payload_plain(adv, pc, pay)),
          bound_ms(nbytes(adv, pc, pay, *got), 10.0 * pairs), None,
          "[32,1024,3]x[32,1024,3], payload [32,8,1024]")
    o2a = got[1]

    # --- scatter -----------------------------------------------------------
    ct = torch.from_numpy(rng.randn(B, N, 3).astype(np.float32)).cuda()
    g = sk.scatter_add_3t(o2a, ct, N)
    w = sk.scatter_add_3t_plain(o2a, ct, N)
    # float32 sums of the rows that collide, in atomic (run-dependent) order
    check("scatter_add_3t", (g - w).abs().max().item(), 1e-5, "out")
    flat_idx = (o2a.long() + N * torch.arange(B, device="cuda")[:, None]).reshape(-1)
    flat_ct = ct.reshape(-1, 3)
    lib_out = torch.zeros(B * N, 3, device="cuda")
    entry("scatter_add_3t", "geoa3_tpu_torch/csrc/scatter.cu",
          "geoa3_tpu/ops/pallas/scatter_kernel.py:167",
          (g - w).abs().max().item(),
          time_ms(lambda: sk.scatter_add_3t(o2a, ct, N)),
          time_ms(lambda: sk.scatter_add_3t_plain(o2a, ct, N)),
          bound_ms(nbytes(o2a, ct, g), 3.0 * B * N),
          time_ms(lambda: lib_out.index_add_(0, flat_idx, flat_ct)),
          "idx [32,1024] -> [32,1024,3]")

    # --- kappa selection mask ----------------------------------------------
    mask = kk.kappa_selmask(adv, K)
    mask_p = kk.kappa_selmask_plain(adv, K)
    if not torch.equal(mask, mask_p):
        _fail(f"kappa_selmask differs from plain in "
              f"{(mask != mask_p).sum().item()} entries")
    if not torch.all(mask.sum(-1, dtype=torch.int32) == K + 1):
        _fail("kappa_selmask rows do not hold k+1 members")
    print("  kappa_selmask: mask bit-equal to plain (required)")
    entry("kappa_selmask", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:210", 0.0,
          time_ms(lambda: kk.kappa_selmask(adv, K)),
          time_ms(lambda: kk.kappa_selmask_plain(adv, K)),
          bound_ms(nbytes(adv, mask), 11.0 * pairs), None,
          "[32,1024,3] -> [32,1024,1024] int8")

    # --- curvature term ----------------------------------------------------
    a2o = got[0]
    normal_b = got[2][:, 3:6].transpose(1, 2).contiguous()
    ref = got[2][:, 6].contiguous()
    cv, gr = kk.curv_term(adv, normal_b, ref, mask, K)
    cv_p, gr_p = kk.curv_term_plain(adv, normal_b, ref, mask, K)
    # per-pair terms are bitwise the plain version's and the sums run in
    # another (atomic) order. The plain gradient comes from autograd through
    # the distance expansion, whose 2 p_j and -2 p_i terms are summed apart
    # and cancel to p_j - p_i: for the closest pairs that f32 cancellation
    # sets the difference, bounded against the largest entry
    check("curv_term", (cv - cv_p).abs().max().item(),
          1e-5 * cv_p.abs().max().item(), "curv")
    check("curv_term", (gr - gr_p).abs().max().item(),
          2e-4 * gr_p.abs().max().item(), "grad")
    _, gr_64 = kk.curv_term_plain(adv.double(), normal_b.double(),
                                  ref.double(), mask, K)
    print(f"  curv_term: (information) the float32 composed gradient is "
          f"{(gr_p.double() - gr_64).abs().max().item() / gr_64.abs().max().item():.3e} "
          f"of the largest entry from its float64 evaluation")
    pairs_sel = B * N * (K + 1)
    entry("curv_term", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:603",
          (gr - gr_p).abs().max().item(),
          time_ms(lambda: kk.curv_term(adv, normal_b, ref, mask, K)),
          time_ms(lambda: kk.curv_term_plain(adv, normal_b, ref, mask, K)),
          bound_ms(nbytes(adv, normal_b, ref, mask, cv, gr), 60.0 * pairs_sel),
          None, "[32,1024,3], mask [32,1024,1024] -> [32], [32,1024,3]")
    del a2o

    # --- fused kappa (prologue) --------------------------------------------
    kp, km = kk.kappa_fwd(pc, nrm, K)
    kp_p, km_p = kk.kappa_fwd_plain(pc, nrm, K)
    if not torch.equal(km, km_p):
        _fail("kappa_fwd mask differs from plain")
    # same selection and per-pair terms; the k-term sum runs in another order
    check("kappa_fwd", (kp - kp_p).abs().max().item(),
          1e-5 * kp_p.abs().max().item(), "kappa")
    entry("kappa_fwd", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:170",
          (kp - kp_p).abs().max().item(),
          time_ms(lambda: kk.kappa_fwd(pc, nrm, K)),
          time_ms(lambda: kk.kappa_fwd_plain(pc, nrm, K)),
          bound_ms(nbytes(pc, nrm, kp, km), 11.0 * pairs + 20.0 * B * N * K),
          None, "[32,1024,3] -> [32,1024], [32,1024,1024] int8")

    # --- kappa from a cached mask ------------------------------------------
    kf = kk.kappa_frommask(adv, normal_b, mask, K)
    kf_p = kk.kappa_from_mask_plain(adv, normal_b, mask, K)
    # per-pair terms bitwise the plain version's; the k+1-term sum runs in
    # another order
    check("kappa_frommask", (kf - kf_p).abs().max().item(),
          1e-5 * kf_p.abs().max().item(), "kappa")
    entry("kappa_frommask", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:230",
          (kf - kf_p).abs().max().item(),
          time_ms(lambda: kk.kappa_frommask(adv, normal_b, mask, K)),
          time_ms(lambda: kk.kappa_from_mask_plain(adv, normal_b, mask, K)),
          bound_ms(nbytes(adv, normal_b, mask, kf), 30.0 * pairs_sel),
          None, "[32,1024,3], mask [32,1024,1024] -> [32,1024]")

    # --- kappa backward, both radii ----------------------------------------
    gk = torch.from_numpy(rng.randn(B, N).astype(np.float32)).cuda()
    bwd_err = {}
    for radius, msk, nrm_r in (("direct", km, nrm), ("expansion", mask, normal_b)):
        cloud_r = pc if radius == "direct" else adv
        gb = kk.kappa_bwd(cloud_r, nrm_r, msk, gk, K, radius)
        gb_p = kk.kappa_bwd_plain(cloud_r, nrm_r, msk, gk, K, radius)
        # autograd of this radius's own plain forward, mask fixed. Same
        # per-pair terms; neighbour-side sums in atomic order, and (expansion)
        # the plain gradient's 2 p_j and -2 p_i terms cancel in float32:
        # bounded against the largest entry, as curv_term's gradient is
        bwd_err[radius] = (gb - gb_p).abs().max().item()
        bwd_max = gb_p.abs().max().item() if radius == "expansion" else None
        check(f"kappa_bwd[{radius}]", bwd_err[radius],
              2e-4 * gb_p.abs().max().item(), "grad")
    # the curvature term's gradient is this backward at g = 2 (kappa - ref) / n
    gb = kk.kappa_bwd(adv, normal_b, mask, (2.0 / N) * (kf - ref), K, "expansion")
    # the same per-pair arithmetic summed in another atomic order
    check("kappa_bwd[expansion]", (gb - gr).abs().max().item(),
          1e-5 * gr.abs().max().item(), "grad vs curv_term's own")
    entry("kappa_bwd", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:258", max(bwd_err.values()),
          time_ms(lambda: kk.kappa_bwd(pc, nrm, km, gk, K, "direct")),
          time_ms(lambda: kk.kappa_bwd_plain(pc, nrm, km, gk, K, "direct")),
          bound_ms(nbytes(pc, nrm, km, gk, gb), 60.0 * pairs_sel), None,
          "direct radius [32,1024,3], mask [32,1024,1024], g [32,1024] -> "
          f"[32,1024,3]; max_abs_err is the expansion radius's, against a "
          f"largest entry of {bwd_max:.1f}; expansion radius: ms="
          f"{time_ms(lambda: kk.kappa_bwd(adv, normal_b, mask, gk, K, 'expansion')):.4f}")

    # --- bare dual 1-NN ----------------------------------------------------
    d_a2o, d_o2a = nk.nn1_dual(adv, pc)
    p_a2o, p_o2a = nk.nn1_dual_plain(adv, pc)
    for g_, w_, what in ((d_a2o, p_a2o, "a2o vs plain"), (d_o2a, p_o2a, "o2a vs plain"),
                         (d_a2o, got[0], "a2o vs nn1_payload"),
                         (d_o2a, got[1], "o2a vs nn1_payload")):
        if not torch.equal(g_, w_):
            _fail(f"nn1_dual {what}: {(g_ != w_).sum().item()} entries differ")
    print("  nn1_dual: a2o, o2a bit-equal to plain and to nn1_payload's (required)")
    entry("nn1_dual", "geoa3_tpu_torch/csrc/nn1.cu",
          "geoa3_tpu/ops/pallas/nn1_kernel.py:73", 0.0,
          time_ms(lambda: nk.nn1_dual(adv, pc)),
          time_ms(lambda: nk.nn1_dual_plain(adv, pc)),
          bound_ms(nbytes(adv, pc, d_a2o, d_o2a), 10.0 * pairs), None,
          "[32,1024,3]x[32,1024,3] -> int32 [32,1024] x2")

    # --- kNN ---------------------------------------------------------------
    dup = adv.clone()
    dup[:, 5] = dup[:, 900]  # a duplicated point in every cloud
    dup[0, 7:10] = dup[0, 7]  # and a triple
    cases = {
        "self k=17, duplicates": (dup, dup, K + 1),
        "query != points, m=768, k=16": (adv, pc[:, :768].contiguous(), K),
        "n=1, k=4": (pc[:, 5:6].contiguous(), pc, 4),
    }
    for label, (q_, p_, k_) in cases.items():
        kg = qk.knn(q_, p_, k_)
        kw = qk.knn_plain(q_, p_, k_)
        for g_, w_, what in zip(kg, kw, ("dists", "idx", "nbrs")):
            if not torch.equal(g_, w_):
                _fail(f"knn[{label}] {what} is not bit-equal to the plain "
                      f"version ({(g_ != w_).sum().item()} entries differ)")
    print(f"  knn: dists, idx, nbrs bit-equal to plain (required) at {list(cases)}")
    # the scatter as the backward of the neighbour gather: s = n * k sources
    # into n rows, every row hit ~k times and the duplicated ones more
    idx_dup = qk.knn(dup, dup, K + 1)[1].reshape(B, N * (K + 1)).contiguous()
    ct_big = torch.from_numpy(
        rng.randn(B, N * (K + 1), 3).astype(np.float32)).cuda()
    sg = sk.scatter_add_3t(idx_dup, ct_big, N)
    sw = sk.scatter_add_3t_plain(idx_dup, ct_big, N)
    # float32 sums of a few dozen colliding terms in atomic order
    check("scatter_add_3t[s=n*k]", (sg - sw).abs().max().item(),
          1e-5 * sw.abs().max().item(), "out")
    kq = K + 1  # the tangent jitter's self-kNN: jitter_k + 1 columns
    dmat = kk.pairwise_sqdist(adv, adv)
    kres = qk.knn(adv, adv, kq)
    entry("knn", "geoa3_tpu_torch/csrc/knn.cu",
          "geoa3_tpu/ops/pallas/knn_kernel.py:54", 0.0,
          time_ms(lambda: qk.knn(adv, adv, kq)),
          time_ms(lambda: qk.knn_plain(adv, adv, kq)),
          bound_ms(nbytes(adv, adv, *kres), 11.0 * pairs),
          time_ms(lambda: torch.topk(dmat, kq, largest=False)),
          "self-kNN [32,1024,3], k=17 -> [32,1024,17] x2, [32,1024,17,3] "
          "(library: torch.topk on the precomputed distance matrix)")
    del dmat

    # --- pool forward / backward -------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(1)
    pool_rows = {}
    for taps in (3, 1):
        x = torch.relu(torch.randn(B, N, CIN, device="cuda", generator=gen))
        w3 = (torch.randn(taps, CIN, COUT, device="cuda", generator=gen)
              / (taps * CIN) ** 0.5).contiguous()
        bias = 0.1 * torch.randn(COUT, device="cuda", generator=gen)
        w3t = w3.transpose(1, 2).contiguous()
        pooled, cnt, rows = pk.pool_fwd(x, w3, bias)
        want = pk.pool_affine_max_plain(x, w3, bias)
        scale = want.abs().max().item()
        # 128*taps float32 products summed in another order than cuBLAS
        check(f"pool_fwd[taps={taps}]", (pooled - want).abs().max().item(),
              1e-5 * scale, "pooled")
        xs = x.transpose(1, 2).contiguous()
        wt = w3.permute(2, 1, 0).contiguous()
        lib = time_ms(lambda: F.conv1d(xs, wt, bias, padding=taps // 2))
        pool_rows[taps] = dict(
            err=(pooled - want).abs().max().item(),
            ms=time_ms(lambda: pk.pool_fwd(x, w3, bias)),
            plain_ms=time_ms(lambda: pk.pool_affine_max_plain(x, w3, bias)),
            bound=bound_ms(nbytes(x, w3, bias, pooled, cnt, rows),
                           2.0 * B * N * CIN * COUT * taps),
            library_ms=lib,
        )
        print(f"  pool_fwd[taps={taps}]: ms={pool_rows[taps]['ms']:.4f} "
              f"plain_ms={pool_rows[taps]['plain_ms']:.4f} "
              f"conv1d_ms={lib:.4f} bound_ms={pool_rows[taps]['bound'][0]:.4f}")

        # backward: the pooled cotangent is kept off columns whose two
        # largest plain values lie within float32 rounding of each other
        # (there the two products may rightly pick different rows), and a
        # run of duplicated rows in instance 0 makes exact ties (> 4 of them)
        # (exact ties: both versions split evenly). The reference runs the
        # plain version in float64, where identical rows stay identical.
        x2 = x.clone()
        x2[0, 100:110] = 3.0 * x2[0, 100]
        pooled2, cnt2, rows2 = pk.pool_fwd(x2, w3, bias)
        x64, w64, b64 = x2.double(), w3.double(), bias.double()
        top2 = torch.topk(pk.affine_plain(x64, w64, b64), 2, dim=1).values
        gap_ok = (top2[:, 0] - top2[:, 1]) > 1e-4 * scale
        gap_ok |= cnt2 > 1
        gcot = torch.randn(B, COUT, device="cuda", generator=gen) * gap_ok
        xg = x64.clone().requires_grad_(True)
        z2 = pk.pool_affine_max_plain(xg, w64, b64)
        (dx_p,) = torch.autograd.grad((z2 * gcot.double()).sum(), xg)
        dx_p = dx_p.float()
        dx = pk.pool_bwd(gcot.contiguous(), x2, w3, w3t, bias, pooled2, cnt2, rows2)
        check(f"pool_bwd[taps={taps}]", (dx - dx_p).abs().max().item(),
              1e-5 * dx_p.abs().max().item(), "dx")
        print(f"  pool_bwd[taps={taps}]: {int((cnt2 > 4).sum())} columns with "
              f"more than 4 tied rows, {int(gap_ok.sum())}/{B * COUT} columns "
              f"with a cotangent")
        # timed on the tie-free input, as the main path's activations are:
        # the run of duplicates sends columns down the recompute path
        g_all = torch.randn(B, COUT, device="cuda", generator=gen)
        tied_rows = int(cnt.sum().item())
        xr = x.clone().requires_grad_(True)
        pool_rows[taps]["bwd"] = dict(
            err=(dx - dx_p).abs().max().item(),
            ms=time_ms(lambda: pk.pool_bwd(g_all, x, w3, w3t, bias, pooled, cnt, rows)),
            plain_ms=time_ms(lambda: torch.autograd.grad(
                (pk.pool_affine_max_plain(xr, w3, bias) * g_all).sum(), xr)),
            bound=bound_ms(nbytes(g_all, cnt, rows, x) + 4 * taps * CIN * COUT,
                           2.0 * tied_rows * taps * CIN),
            ms_ties=time_ms(lambda: pk.pool_bwd(gcot, x2, w3, w3t, bias, pooled2, cnt2, rows2)),
        )
        print(f"  pool_bwd[taps={taps}]: ms={pool_rows[taps]['bwd']['ms']:.4f} "
              f"(with the duplicate run: {pool_rows[taps]['bwd']['ms_ties']:.4f})")
    p3 = pool_rows[3]
    entry("pool_fwd", "geoa3_tpu_torch/csrc/pool_matmul.cu",
          "geoa3_tpu/ops/pallas/pool_matmul_kernel.py:73", p3["err"], p3["ms"],
          p3["plain_ms"], p3["bound"], p3["library_ms"],
          "conv5 taps=3 [32,1024,128]->[32,1024] (library: F.conv1d alone, "
          f"no pool); taps=1 T-Net pools: ms={pool_rows[1]['ms']:.4f} "
          f"bound_ms={pool_rows[1]['bound'][0]:.4f}")
    b3 = p3["bwd"]
    entry("pool_bwd", "geoa3_tpu_torch/csrc/pool_matmul.cu",
          "geoa3_tpu/ops/pallas/pool_matmul_kernel.py:79", b3["err"], b3["ms"],
          b3["plain_ms"], b3["bound"], None,
          "conv5 taps=3 dx [32,1024,128] (plain: autograd through the plain "
          f"forward); taps=1: ms={pool_rows[1]['bwd']['ms']:.4f}")
    return out


MAIN_PATH = ("nn1_payload", "scatter_add_3t", "kappa_selmask", "curv_term",
             "kappa_fwd", "pool_fwd", "pool_bwd")
# kernels that no engine path launches (public ops only, as in the JAX
# package): phase 2 launches and checks them
PHASE2_ONLY = ("nn1_dual", "kappa_frommask")


class Paths:
    """Drives each path with the launch counts set to 0 just before and read
    just after, and fails if a kernel the path names was not launched."""

    def __init__(self):
        self.counts = {}  # path label -> {kernel: launches}
        self.required = {}

    def run(self, label, required, fn):
        from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

        reset_launch_counts()
        out = fn()
        counts = launch_counts()
        print(f"  {label} launches: {counts}")
        missing = [k for k in required if counts[k] == 0]
        if missing:
            _fail(f"kernels not launched in the {label} run: {missing}")
        self.counts[label] = counts
        self.required[label] = tuple(required)
        return out, counts

    def check_union(self):
        from geoa3_tpu_torch.ops.kernels import KERNELS

        covered = set(PHASE2_ONLY).union(*self.required.values())
        if covered != set(KERNELS):
            _fail(f"no path launches {sorted(set(KERNELS) - covered)}")

    def launches(self, kernel):
        """The count of the first path that names the kernel (0 for the
        kernels only phase 2 launches), and the counts of every path."""
        by_path = {label: c[kernel] for label, c in self.counts.items()}
        first = next((label for label, req in self.required.items()
                      if kernel in req), None)
        return (by_path[first] if first else 0), by_path


def timed_attack(torch, fn, args, steps):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    res = fn(*args)
    e.record()
    e.synchronize()
    return res, s.elapsed_time(e) / steps


def check_result(torch, res, steps, label):
    for name, t in res._asdict().items():
        if t.is_floating_point() and name != "best_loss" and not torch.isfinite(t).all():
            _fail(f"{label}: attack result {name} is not finite")
    if res.best_attack.shape != (B, N, 3) or res.all_loss.shape != (steps, B):
        _fail(f"{label}: attack result has the wrong shape")


def attack_phase(torch, paths) -> dict:
    """Phase 3: the default attack end to end on the card."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.workload import main_path_config, random_pointnet

    model, logits_fn = random_pointnet(seed=0)
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    with torch.no_grad():
        gt = logits_fn(pc).argmax(-1)

    def run(cfg, seed):
        fn = make_attack_fn(logits_fn, cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return timed_attack(torch, fn, (pc, nrm, gt, gt, gen),
                            cfg.binary_max_steps * cfg.iter_max_steps)

    run(main_path_config(1, 10), 99)  # warm-up

    cfg = main_path_config(1, 50)
    (res, ms_step), counts = paths.run("K=10", MAIN_PATH, lambda: run(cfg, 0))
    check_result(torch, res, 50, "K=10")
    n_succ = int(res.success.sum())
    print(f"  K=10 attack: {cfg.binary_max_steps}x{cfg.iter_max_steps} steps, "
          f"{ms_step:.4f} ms/step (CUDA events), success {n_succ}/{B}")

    cfg1 = main_path_config(1, 20, refresh=1)
    (res1, ms_step1), counts1 = paths.run("K=1", MAIN_PATH, lambda: run(cfg1, 1))
    # exact mode: a fresh mask on every step, and the term read from it
    if not counts1["kappa_selmask"] == counts1["curv_term"] == 20:
        _fail("exact mode did not rebuild the mask and read it on each of its "
              f"20 steps: {counts1}")
    check_result(torch, res1, 20, "K=1")
    print(f"  K=1 (exact) attack: 1x20 steps, {ms_step1:.4f} ms/step "
          f"(CUDA events), success {int(res1.success.sum())}/{B}")
    return dict(counts=counts, counts_exact=counts1, ms_step=ms_step,
                ms_step_exact=ms_step1, success=n_succ)


def synthetic_labels(torch):
    """The ModelNet40 ids of workload.synthetic_batch's shape classes. A
    random victim does not predict them, so an untargeted attack against
    them succeeds at once for most instances."""
    from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES

    return torch.tensor([TEN_LABEL_INDEXES[i % 10] for i in range(B)],
                        device="cuda")


def side_modes_phase(torch, paths) -> dict:
    """Phase 4: the engine's side modes through make_attack_fn at full width."""
    import dataclasses

    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.attack import project
    from geoa3_tpu_torch.workload import main_path_config, random_pointnet

    _, logits_fn = random_pointnet(seed=0)
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    gt = synthetic_labels(torch)
    steps = 100
    base = main_path_config(1, steps)

    def run(cfg, seed):
        fn = make_attack_fn(logits_fn, cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return timed_attack(torch, fn, (pc, nrm, gt, gt, gen), steps)

    # the batched 3x3 eigendecomposition of the tangent jitter, on its own
    _, _, centered = project._local_covariance_eig(pc, K)
    covm = torch.einsum("bnkc,bnkd->bncd", centered, centered) / (K - 1)
    eigh_ms = time_ms(lambda: project._eigh_batched(covm), iters=5, warm=1)
    perp_ms = time_ms(lambda: project.estimate_perpendicular(
        None, pc, K, gauss=(torch.zeros(B, N, 1, device="cuda"),) * 2),
        iters=5, warm=1)
    print(f"  torch.linalg.eigh on [{B * N}, 3, 3] in chunks of "
          f"{project._EIGH_CHUNK}: {eigh_ms:.4f} ms; "
          f"estimate_perpendicular (kNN k={K + 1} + covariance + eigh): "
          f"{perp_ms:.4f} ms")

    cc = 0.1
    jcfg = dataclasses.replace(base, is_pre_jitter_input=True, is_pro_grad=True,
                               cc_linf=cc)
    (res, jit_ms), counts = paths.run("jitter+proj+clip", MAIN_PATH + ("knn",),
                                      lambda: run(jcfg, 2))
    check_result(torch, res, steps, "jitter+proj+clip")
    refreshes = steps // jcfg.calculate_project_jitter_noise_iter
    if counts["knn"] != refreshes:
        _fail(f"the jitter run launched knn {counts['knn']} times, expected one "
              f"per refresh ({refreshes})")
    n_succ = int(res.success.sum())
    if n_succ == 0:
        _fail("no instance of the jitter run succeeded: the clip is unchecked")
    norms = (res.best_attack - pc).norm(dim=-1)[res.success]
    if not norms.max().item() <= cc * (1 + 1e-5):
        _fail(f"a successful cloud's offset row has norm {norms.max().item()} "
              f"> cc_linf {cc}")
    print(f"  jitter+proj+clip: 1x{steps} steps, {jit_ms:.4f} ms/step, success "
          f"{n_succ}/{B}, largest offset row {norms.max().item():.3e} <= {cc}")

    pcfg = dataclasses.replace(base, is_partial_var=True, knn_range=3,
                               optim="sgd", curv_knn_refresh_every=1)
    need = ("nn1_payload", "scatter_add_3t", "kappa_fwd", "kappa_bwd", "knn",
            "pool_fwd", "pool_bwd")
    (res, part_ms), counts = paths.run("partial-var", need, lambda: run(pcfg, 3))
    check_result(torch, res, steps, "partial-var")
    phases = steps // pcfg.partial_reinit_every
    want = {"kappa_fwd": steps + 1, "kappa_bwd": steps, "knn": phases,
            "kappa_selmask": 0, "curv_term": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        _fail(f"partial-var launches {got}, expected {want} (one kappa forward "
              "and backward per step, the prologue, one kNN per phase)")
    print(f"  partial-var: 1x{steps} steps = {phases} phases, {part_ms:.4f} "
          f"ms/step, success {int(res.success.sum())}/{B}")
    return dict(eigh_ms=eigh_ms, estimate_perpendicular_ms=perp_ms,
                ms_per_step_jitter=jit_ms, ms_per_step_partial=part_ms)


def cli_phase(torch, paths) -> dict:
    """Phase 5: the attack CLI in process, into a directory under build/."""
    import shutil

    import scipy.io as sio

    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main
    from geoa3_tpu_torch.workload import random_pointnet

    root = REPO / "build" / "chip_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model, _ = random_pointnet(seed=0)
    torch.save(model.state_dict(), root / "victim.pt")
    per_class, steps = 4, 20
    argv = ["--attack", "GeoA3", "--attack_label", "Untarget",
            "--data_dir_file", f"synthetic:{per_class}:{N}", "-b", str(B),
            "--binary_max_steps", "1", "--iter_max_steps", str(steps),
            "--checkpoint", str(root / "victim.pt"),
            "--exps_root", str(root / "Exps")]
    t0 = time.time()
    saved, _ = paths.run("CLI", MAIN_PATH,
                         lambda: cli_main(build_parser().parse_args(argv)))
    torch.cuda.synchronize()
    secs = time.time() - t0
    saved = Path(saved)
    total = 10 * per_class
    mats = sorted(p.name for p in (saved / "Mat").iterdir())
    objs = sorted(p.name for p in (saved / "PC").iterdir())
    if not mats or [m[:-4] for m in mats] != [o[:-4] for o in objs]:
        _fail(f"CLI: Mat/ and PC/ do not hold the same instances ({len(mats)}, "
              f"{len(objs)})")
    m = sio.loadmat(saved / "Mat" / mats[0])
    cloud = m["adversary_point_clouds"]
    if cloud.shape != (3, N) or not np.isfinite(cloud).all():
        _fail(f"CLI: saved cloud has shape {cloud.shape} or is not finite")
    rate = float((saved / "attack_result.txt").read_text().strip()
                 .splitlines()[-1].split(":")[1])
    if abs(rate - 100.0 * len(mats) / total) > 0.01:
        _fail(f"CLI: attack_result.txt says {rate}% but {len(mats)} of {total} "
              "instances were saved")
    metrics = json.loads((saved / "attack_metrics.json").read_text())
    if metrics["num_successful"] != len(mats) or not (
            np.isfinite(metrics["mean_chamfer"])
            and np.isfinite(metrics["mean_hausdorff"])):
        _fail(f"CLI: attack_metrics.json is off: {metrics}")
    done = int((saved / "batches_done.txt").read_text())
    if done != -(-total // B):
        _fail(f"CLI: batches_done.txt says {done}")
    # a second run into the same directory leaves no stale file
    stale = saved / "Mat" / "adv_999_gt0_attack1_expect0.mat"
    stale.touch()
    cli_main(build_parser().parse_args(argv))
    again = sorted(p.name for p in (saved / "Mat").iterdir())
    if stale.exists() or again != mats:
        _fail("CLI: the second run left stale files or other outputs")
    print(f"  CLI: {total} clouds in {done} batches, 1x{steps} steps, "
          f"{len(mats)} saved ({rate:.2f}%), {secs:.1f} s; outputs and the "
          "stale-file clearing check out")
    return dict(saved=len(mats), total=total, seconds=secs)


def cpu_agreement(torch) -> None:
    """A short attack on the card against the same attack on the CPU (the
    kernels' plain versions), from the same weights and initial offsets."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.workload import main_path_config, random_pointnet

    b, n = 4, 256
    model, _ = random_pointnet(40, n, seed=2, device="cpu")
    pc, nrm, rng = make_batch(torch, b, n, seed=2)
    offs = [torch.from_numpy(1e-3 * rng.randn(b, n, 3).astype(np.float32))
            for _ in range(2)]
    cfg = main_path_config(2, 10, refresh=5, npoint=n)
    results = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        m.requires_grad_(False)
        x, nx = pc.to(dev), nrm.to(dev)
        with torch.no_grad():
            gt = m(x).argmax(-1)
        fn = make_attack_fn(m, cfg, init_offset=lambda i: offs[i])
        results[dev] = fn(x, nx, gt, gt)
    g, c = results["cuda"], results["cpu"]
    a, b_ = g.all_loss.cpu(), c.all_loss
    rel = ((a - b_).abs().mean() / b_.abs().mean()).item()
    # float32 sums in other orders feed 20 Adam steps
    print(f"  card vs CPU attack ([4,256], 2x10 steps): mean rel all_loss "
          f"diff {rel:.3e} (tol 1e-3), success {g.success.tolist()} vs "
          f"{c.success.tolist()}")
    if not rel <= 1e-3:
        _fail("the attack on the card disagrees with the CPU run")


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (a short check of a new kernel)")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from geoa3_tpu_torch.ops.kernels import _build

    t0 = time.time()
    so = _build.lib()
    print(f"phase 1: built {so} in {time.time() - t0:.1f} s")

    print("phase 2: kernels against their plain versions")
    kernels = kernel_checks(torch)
    if args.kernels_only:
        print(json.dumps({"kernels": kernels}))
        return 0

    paths = Paths()
    print("phase 3: default attack on the card")
    run = attack_phase(torch, paths)
    cpu_agreement(torch)

    print("phase 4: the engine's side modes at full width")
    side = side_modes_phase(torch, paths)

    print("phase 5: the attack CLI in process")
    cli = cli_phase(torch, paths)

    paths.check_union()
    for k in kernels:
        k["launches"], k["launches_by_path"] = paths.launches(k["name"])

    print(json.dumps({
        "attack": {"ms_per_step_k10": run["ms_step"],
                   "ms_per_step_exact": run["ms_step_exact"],
                   "launches_exact": run["counts_exact"],
                   "success": run["success"], "batch": B, "card": smi},
        "side_modes": side, "cli": cli,
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
