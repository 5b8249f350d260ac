#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (geoa3_tpu_torch) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository around the script. Phases:

  1. print the card's name and power limit; build the CUDA kernels (timed);
  2. hold every kernel against its plain PyTorch version at the paths'
     shapes (b=32, n=m=1024, k=16; PointNet's pools at [32, 1024, 128] ->
     1024; kNN also at m != n and at one query row; the dual 1-NN also at
     2048 original against 1024 moved points; PointNet++ SSG's sampling,
     grouping and grouped MLPs at its three set-abstraction shapes, with
     empty, over-full and larger-than-the-cloud balls and duplicated rows;
     the MSG victim's whole-scale kernel at SA2's three scales, at cf=0 and
     cf=3, with empty and over-full balls, its grouped MLPs at SA1's three
     scales and at GroupAll with 640 features, and the k-neighbour scatter),
     with the tolerance stated, and time both (CUDA events, warm, median of
     20), plus one PyTorch library call where one computes the same
     function, and for the whole-scale kernel the split pair it stands in for.
     The pool forward's whole output (maximum, tie count, first tied rows) is
     held bit-equal to an exact oracle of its fmaf chain at b=2; the 3-channel
     scatter also in the o2a backward's strided plane layout and on its
     global-atomic route for clouds too large for shared memory; the
     scatter's and the pool wrapper's host time per call are printed. The
     self-kNN selection (mask and fused kappa) and the kNN are also held
     bit-equal at a ragged n = 1000, at n = 10000 and at 12288, the kappa
     backward at 1000 and 10000, the curvature term (direct form) at 1000
     and 12288, with its float32 gradient's distance
     from float64 printed beside the expansion form's; the selection, the
     curvature term, the fused kappa and the kNN are also timed ten calls
     back to back;
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
  6. the same attack on the PointNet++ SSG victim at its published width
     (b=32, n=1024; two FPS, two ball-query+group and three grouped-MLP
     launches per forward, and as many backward launches per step), a
     short SSG attack on the card against the same attack on the CPU, and
     the victim with normals as features ([b, n, 6]) against the CPU;
  7. subsample mode with the uniform loss on PointNet: clouds of 2048
     points resampled to 1024 every step, a three-fold resampling vote; and
     the public ops whose kernels no engine path launches (`ops.nn1_dual`,
     `ops.knn_kappa_from_mask`, `ops.group_points` with its C-channel
     scatter backward, `ops.scatter_add_3`, and the feature-propagation
     module with `ops.three_nn` and `ops.three_interpolate` against the CPU);
  8. the attack on the PointNet++ MSG victim at its published width (b=32,
     n=1024, 1 x 30 steps; every kernel's launch count checked against the
     count read from the code), a short MSG attack on the card against the
     CPU, the MSG victim with normals against the CPU; then the CLI once
     with --arch PointNetPP, once with --arch PointNetPP_MSG and once with
     --is_subsample_opt on clouds of 2048 points;
  9. dense clouds (b=16, n=10000, runs/bench_dense.py's configuration):
     the 1-NN payload and FPS at the subsample path's shapes against their
     plain versions, then 1 x 20 steps in subsample mode and 1 x 20 steps
     (two phases) in partial-variable mode, each with its launch counts
     checked, its ms/step and its peak device memory;
  10. print one JSON line listing the kernels, then the result line.

Every path runs with the kernels' launch counts set to 0 just before and
read just after, and fails if a kernel it names was not launched; together
the paths must cover every kernel. `--kernels-only` stops after phase 2.

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
DENSE_B, DENSE_N = 16, 10000  # runs/bench_dense.py's batch and cloud size
# (b, n) of the selection's checks past the main path: a ragged n, the
# dense n, and the JAX package's largest padded n
DENSE_CHECKS = ((2, 1000), (2, DENSE_N), (1, 12288))


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


def ten_ms(fn, iters: int = 20) -> float:
    """One call's device time: ten calls enqueued behind a 4096 x 4096 matrix
    product that keeps the card busy while the host enqueues them, timed
    from the product's end to the tenth call's end (median of `iters`), so
    no wrapper's host time enters, however short the kernel."""
    import torch

    spacer = torch.ones(4096, 4096, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        spacer @ spacer
        s.record()
        for _ in range(10):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / 10)
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


def entry_into(out: list):
    def entry(name, source, replaces, err, ms, plain_ms, bound, library_ms,
              shape):
        out.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms, "shape": shape,
        })
    return entry


def fma_chain(torch, a, w):
    """a [r, k] @ w [k, c] in float32 as the grouped-MLP kernel sums it: from
    0, one fused multiply-add a term, k ascending. The product of two float32
    values is exact in float64, so each step rounds once, as `fmaf` does."""
    acc = torch.zeros(a.shape[0], w.shape[1], device=a.device)
    a64, w64 = a.double(), w.double()
    for k in range(w.shape[0]):
        acc = (acc.double() + a64[:, k:k + 1] * w64[k]).float()
    return acc


def host_us(torch, fn, calls: int = 200) -> float:
    """Host time of one call in microseconds: `calls` calls back to back with
    no synchronisation inside, on the host clock (what the caller's thread
    spends enqueuing, not the device time)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def require_equal(torch, name, got, want, what) -> None:
    if not torch.equal(got, want):
        _fail(f"{name} {what} is not bit-equal to the plain version "
              f"({(got != want).sum().item()} entries differ)")


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

    entry = entry_into(out)

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
    # subsample mode: 2048 original points against 1024 moved ones
    pc2, nrm2, _ = make_batch(torch, B, 2 * N, seed=5)
    pay2 = torch.cat([pc2.transpose(1, 2), nrm2.transpose(1, 2),
                      torch.zeros(B, 2, 2 * N, device="cuda")], 1).contiguous()
    for g, w, what in zip(nk.nn1_dual_payload(adv, pc2, pay2),
                          nk.nn1_dual_payload_plain(adv, pc2, pay2),
                          ("a2o", "o2a", "gp", "op")):
        require_equal(torch, "nn1_payload[n_adv=1024, n_ori=2048]", g, w, what)
    kp2, km2 = kk.kappa_fwd(pc2, nrm2, K)
    kp2_p, km2_p = kk.kappa_fwd_plain(pc2, nrm2, K)
    require_equal(torch, "kappa_fwd[n=2048]", km2, km2_p, "mask")
    check("kappa_fwd[n=2048]", (kp2 - kp2_p).abs().max().item(),
          1e-5 * kp2_p.abs().max().item(), "kappa")
    del pc2, nrm2, pay2, kp2, km2, kp2_p, km2_p

    # --- scatter -----------------------------------------------------------
    ct = torch.from_numpy(rng.randn(B, N, 3).astype(np.float32)).cuda()
    g = sk.scatter_add_3t(o2a, ct, N)
    w = sk.scatter_add_3t_plain(o2a, ct, N)
    # float32 sums of the rows that collide, in atomic (run-dependent) order
    check("scatter_add_3t", (g - w).abs().max().item(), 1e-5, "out")
    # the o2a backward's layout: the first three rows of the [b, 8, m] plane
    # cotangent, read through their strides
    planes = torch.from_numpy(rng.randn(B, 8, N).astype(np.float32)).cuda()
    pview = planes[:, :3].transpose(1, 2)
    check("scatter_add_3t[planes]",
          (sk.scatter_add_3t(o2a, pview, N)
           - sk.scatter_add_3t_plain(o2a, pview.contiguous(), N)).abs().max().item(),
          1e-5, "out")
    # the global-atomic route, for clouds whose sums exceed shared memory,
    # with out-of-range indices dropped
    nb = sk.SHARED_ROWS + 1
    big_idx = torch.from_numpy(rng.randint(-2, nb + 2, (2, nb)).astype(np.int32)).cuda()
    big_ct = torch.from_numpy(rng.randn(2, nb, 3).astype(np.float32)).cuda()
    keep = ((big_idx >= 0) & (big_idx < nb))[..., None]
    check(f"scatter_add_3t[global route, n={nb}]",
          (sk.scatter_add_3t(big_idx, big_ct, nb)
           - sk.scatter_add_3t_plain(big_idx.clamp(0, nb - 1), big_ct * keep, nb)
           ).abs().max().item(), 1e-5, "out")
    del big_idx, big_ct, keep
    flat_idx = (o2a.long() + N * torch.arange(B, device="cuda")[:, None]).reshape(-1)
    flat_ct = ct.reshape(-1, 3)
    lib_out = torch.zeros(B * N, 3, device="cuda")
    sc_ms = time_ms(lambda: sk.scatter_add_3t(o2a, ct, N))
    lib_ms = time_ms(lambda: lib_out.index_add_(0, flat_idx, flat_ct))
    host = {"scatter_add_3t": host_us(torch, lambda: sk.scatter_add_3t(o2a, ct, N)),
            "planes": host_us(torch, lambda: sk.scatter_add_3t(o2a, pview, N)),
            "index_add_": host_us(torch, lambda: lib_out.index_add_(0, flat_idx, flat_ct)),
            "current_stream": host_us(torch, lambda: torch.cuda.current_stream().cuda_stream)}
    print(f"  scatter_add_3t: ms={sc_ms:.4f} index_add_ms={lib_ms:.4f}; host us "
          f"per call (200 calls, no sync inside): " + ", ".join(
              f"{k}={v:.2f}" for k, v in host.items()))
    entry("scatter_add_3t", "geoa3_tpu_torch/csrc/scatter.cu",
          "geoa3_tpu/ops/pallas/scatter_kernel.py:167",
          (g - w).abs().max().item(), sc_ms,
          time_ms(lambda: sk.scatter_add_3t_plain(o2a, ct, N)),
          bound_ms(nbytes(o2a, ct, g), 3.0 * B * N), lib_ms,
          "idx [32,1024] -> [32,1024,3] (one launch, shared route); host us "
          "per call: " + ", ".join(f"{k}={v:.2f}" for k, v in host.items()))

    # --- kappa selection mask ----------------------------------------------
    mask = kk.kappa_selmask(adv, K)
    mask_p = kk.kappa_selmask_plain(adv, K)
    if not torch.equal(mask, mask_p):
        _fail(f"kappa_selmask differs from plain in "
              f"{(mask != mask_p).sum().item()} entries")
    if not torch.all(mask.sum(-1, dtype=torch.int32) == K + 1):
        _fail("kappa_selmask rows do not hold k+1 members")
    print("  kappa_selmask: mask bit-equal to plain (required)")
    sel_ten = ten_ms(lambda: kk.kappa_selmask(adv, K))
    entry("kappa_selmask", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:210", 0.0,
          time_ms(lambda: kk.kappa_selmask(adv, K)),
          time_ms(lambda: kk.kappa_selmask_plain(adv, K)),
          bound_ms(nbytes(adv, mask), 11.0 * pairs), None,
          f"[32,1024,3] -> [32,1024,1024] int8; ten calls back to back: "
          f"ms={sel_ten:.4f}")

    # --- curvature term ----------------------------------------------------
    a2o = got[0]
    normal_b = got[2][:, 3:6].transpose(1, 2).contiguous()
    ref = got[2][:, 6].contiguous()
    cv, gr = kk.curv_term(adv, normal_b, ref, mask, K)
    cv_p, gr_p = kk.curv_term_plain(adv, normal_b, ref, mask, K)
    # the direct form on both sides with the same per-pair arithmetic; the
    # kernel sums kappa and curv in another order, and its gradient is the
    # analytic one summed with atomics where the plain one is autograd's
    check("curv_term", (cv - cv_p).abs().max().item(),
          1e-5 * cv_p.abs().max().item(), "curv")
    check("curv_term", (gr - gr_p).abs().max().item(),
          1e-4 * gr_p.abs().max().item(), "grad")
    gaps = curv_float64_gaps(torch, kk, adv, normal_b, ref, mask, gr)
    print("  curv_term: the float32 gradient's distance from float64, as a "
          "share of the largest entry: " + ", ".join(
              f"{k_}={v:.3e}" for k_, v in gaps.items()))
    if not gaps["direct"] < gaps["expansion"]:
        _fail("curv_term: the direct form's float32 gradient is not nearer "
              "float64 than the expansion form's")
    pairs_sel = B * N * (K + 1)
    curv_ten = ten_ms(lambda: kk.curv_term(adv, normal_b, ref, mask, K))
    entry("curv_term", "geoa3_tpu_torch/csrc/kappa.cu",
          "geoa3_tpu/ops/pallas/kappa_kernel.py:603",
          (gr - gr_p).abs().max().item(),
          time_ms(lambda: kk.curv_term(adv, normal_b, ref, mask, K)),
          time_ms(lambda: kk.curv_term_plain(adv, normal_b, ref, mask, K)),
          bound_ms(nbytes(adv, normal_b, ref, mask, cv, gr), 60.0 * pairs_sel),
          None, "[32,1024,3], mask [32,1024,1024] -> [32], [32,1024,3] "
          f"(direct form); ten calls back to back: "
          f"ms={curv_ten:.4f}; float32 gradient from float64, share of the "
          "largest entry: " + ", ".join(f"{k_}={v:.3e}" for k_, v in gaps.items()))
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
          None, "[32,1024,3] -> [32,1024], [32,1024,1024] int8; ten calls "
          f"back to back: ms={ten_ms(lambda: kk.kappa_fwd(pc, nrm, K)):.4f}")

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
    # the curvature term's gradient is this backward (direct radius) at
    # g = 2 (kappa - ref) / n, with kappa_fwd's kappa (the same selection)
    kd = kk.kappa_fwd(adv, normal_b, K)[0]
    gb = kk.kappa_bwd(adv, normal_b, mask, (2.0 / N) * (kd - ref), K, "direct")
    # the same per-pair arithmetic summed in another order
    check("kappa_bwd[direct]", (gb - gr).abs().max().item(),
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
          "(library: torch.topk on the precomputed distance matrix); ten "
          f"calls back to back: ms={ten_ms(lambda: qk.knn(adv, adv, kq)):.4f}")
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
        # the kernel's whole output, bit-equal at b=2 to an exact oracle of
        # its chain (also on a ragged cloud of 1000 points)
        pool_oracle_check(torch, pk, f"taps={taps}", x[:2], w3, bias,
                          (pooled[:2], cnt[:2], rows[:2]))
        xr = x[:2, :1000].contiguous()
        pool_oracle_check(torch, pk, f"taps={taps}, n=1000", xr, w3, bias,
                          pk.pool_fwd(xr, w3, bias))
        xs = x.transpose(1, 2).contiguous()
        wt = w3.permute(2, 1, 0).contiguous()
        lib = time_ms(lambda: F.conv1d(xs, wt, bias, padding=taps // 2))
        flops = 2.0 * B * N * CIN * COUT * taps
        pool_rows[taps] = dict(
            err=(pooled - want).abs().max().item(),
            ms=time_ms(lambda: pk.pool_fwd(x, w3, bias)),
            plain_ms=time_ms(lambda: pk.pool_affine_max_plain(x, w3, bias)),
            bound=bound_ms(nbytes(x, w3, bias, pooled, cnt, rows), flops),
            library_ms=lib,
            # ten calls back to back: the wrapper's host time hides behind
            # the device's work, so this reads the kernel's own time
            dev_ms=time_ms(lambda: [pk.pool_fwd(x, w3, bias) for _ in range(10)]) / 10,
            lib_dev_ms=time_ms(lambda: [F.conv1d(xs, wt, bias, padding=taps // 2)
                                        for _ in range(10)]) / 10,
            host_us=host_us(torch, lambda: pk.pool_fwd(x, w3, bias), calls=50),
        )
        r_ = pool_rows[taps]
        print(f"  pool_fwd[taps={taps}]: ms={r_['ms']:.4f} (one call; ten back to "
              f"back: {r_['dev_ms']:.4f} = {flops / r_['dev_ms'] / 1e9:.1f} "
              f"TFLOP/s; wrapper host us per call {r_['host_us']:.2f}) "
              f"plain_ms={r_['plain_ms']:.4f} conv1d_ms={lib:.4f} (ten back "
              f"to back: {r_['lib_dev_ms']:.4f}) bound_ms={r_['bound'][0]:.4f}")

        # backward: the pooled cotangent is kept off columns whose two
        # largest plain values lie within float32 rounding of each other
        # (there the two products may rightly pick different rows), and a
        # run of duplicated rows in instance 0 makes exact ties (> 4 of them)
        # (exact ties: both versions split evenly). The reference runs the
        # plain version in float64, where identical rows stay identical.
        x2 = x.clone()
        x2[0, 100:110] = 3.0 * x2[0, 100]
        pooled2, cnt2, rows2 = pk.pool_fwd(x2, w3, bias)
        pool_oracle_check(torch, pk, f"taps={taps}, duplicated rows", x2[:2],
                          w3, bias, (pooled2[:2], cnt2[:2], rows2[:2]))
        x64, w64, b64 = x2.double(), w3.double(), bias.double()
        z64 = pk.affine_plain(x64, w64, b64)
        top2 = torch.topk(z64, 2, dim=1).values
        gap_ok = (top2[:, 0] - top2[:, 1]) > 1e-4 * scale
        # tie counts and rows against the plain version (cuBLAS sums): held
        # on the columns whose maximum (tied or not) stands clear of every
        # other value, where both must find the same rows
        mx64 = top2[:, 0]
        runner_up = torch.where(z64 == mx64[:, None], -torch.inf, z64).amax(1)
        held = (mx64 - runner_up) > 1e-4 * scale
        del z64, runner_up
        _, cnt_p, rows_p = pk.pool_ties_plain(x2, w3, bias)
        require_equal(torch, f"pool_fwd[taps={taps}, duplicated rows]",
                      cnt2[held], cnt_p[held], "cnt vs pool_ties_plain")
        require_equal(torch, f"pool_fwd[taps={taps}, duplicated rows]",
                      rows2[held], rows_p[held], "rows vs pool_ties_plain")
        print(f"  pool_fwd[taps={taps}]: cnt, rows equal to pool_ties_plain on "
              f"{int(held.sum())}/{B * COUT} columns ({int((cnt_p[held] > 1).sum())} "
              f"tied)")
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
    p3, p1 = pool_rows[3], pool_rows[1]
    entry("pool_fwd", "geoa3_tpu_torch/csrc/pool_matmul.cu",
          "geoa3_tpu/ops/pallas/pool_matmul_kernel.py:73", p3["err"], p3["ms"],
          p3["plain_ms"], p3["bound"], p3["library_ms"],
          "conv5 taps=3 [32,1024,128]->[32,1024] (library: F.conv1d alone, "
          f"no pool; ten calls back to back: ms={p3['dev_ms']:.4f} conv1d_ms="
          f"{p3['lib_dev_ms']:.4f}; wrapper host us {p3['host_us']:.2f}); taps=1 "
          f"T-Net pools: ms={p1['ms']:.4f} plain_ms={p1['plain_ms']:.4f} "
          f"conv1d_ms={p1['library_ms']:.4f} bound_ms={p1['bound'][0]:.4f} "
          f"(back to back: ms={p1['dev_ms']:.4f} conv1d_ms={p1['lib_dev_ms']:.4f})")
    b3, b1 = p3["bwd"], p1["bwd"]
    entry("pool_bwd", "geoa3_tpu_torch/csrc/pool_matmul.cu",
          "geoa3_tpu/ops/pallas/pool_matmul_kernel.py:79", b3["err"], b3["ms"],
          b3["plain_ms"], b3["bound"], None,
          "conv5 taps=3 dx [32,1024,128] (plain: autograd through the plain "
          f"forward); taps=1: ms={b1['ms']:.4f} plain_ms={b1['plain_ms']:.4f} "
          f"bound_ms={b1['bound'][0]:.4f}")
    return out


def curv_float64_gaps(torch, kk, cloud, normal, ref, mask, grad) -> dict:
    """How far the float32 curvature gradients lie from their float64
    evaluations on the same inputs, as a share of the largest entry: the
    kernel's (`grad`) and the plain version's against the direct form in
    float64, and the expansion form's (the port's form before, the JAX
    package's composed path) against its own float64 evaluation."""
    n = cloud.shape[1]

    def expansion(c, nv, rv):
        kap = kk.kappa_from_mask_plain(c, nv, mask, K)
        return kk.kappa_bwd_plain(c, nv, mask, (2.0 / n) * (kap - rv), K,
                                  "expansion")

    c64, n64, r64 = cloud.double(), normal.double(), ref.double()
    d64 = kk.curv_term_plain(c64, n64, r64, mask, K)[1]
    e64 = expansion(c64, n64, r64)

    def rel(g, w):
        return ((g.double() - w).abs().max() / w.abs().max()).item()

    return {"kernel": rel(grad, d64),
            "direct": rel(kk.curv_term_plain(cloud, normal, ref, mask, K)[1], d64),
            "expansion": rel(expansion(cloud, normal, ref), e64)}


def pool_oracle_check(torch, pk, label, x, w3, bias, got) -> None:
    """pool_fwd's (pooled, cnt, rows) bit-equal to an exact oracle of its
    arithmetic: x shifted per tap and concatenated on k (k' = t cin + k), one
    fmaf chain from 0 with k' ascending (`fma_chain`), then + bias in
    float32, and the maximum's ties read off those activations."""
    taps, cin, cout = w3.shape
    b_, n_, _ = x.shape
    if taps == 3:
        zero = x.new_zeros(b_, 1, cin)
        x = torch.cat([torch.cat([zero, x[:, :-1]], 1), x,
                       torch.cat([x[:, 1:], zero], 1)], dim=2)
    z = fma_chain(torch, x.reshape(b_ * n_, taps * cin),
                  w3.reshape(taps * cin, cout)) + bias
    for g_, w_, what in zip(got, pk.max_ties(z.reshape(b_, n_, cout)),
                            ("pooled", "cnt", "rows")):
        require_equal(torch, f"pool_fwd[{label}]", g_, w_,
                      f"{what} vs the fmaf-chain oracle")
    print(f"  pool_fwd[{label}]: pooled, cnt, rows bit-equal to the fmaf-chain "
          f"oracle (required; {int((got[1] > 1).sum())} tied columns)")


def random_mlp(torch, gen, cf, widths):
    """A random folded three-layer MLP at He-like scale."""
    from geoa3_tpu_torch.ops.kernels.group_mlp_kernel import fold_mlp

    parts, cin = [], 3 + cf
    for w in widths:
        parts.append(torch.randn(cin, w, device="cuda", generator=gen)
                     * (2.0 / cin) ** 0.5)
        parts.append(0.1 * torch.randn(w, device="cuda", generator=gen))
        cin = w
    return fold_mlp(*parts)


def group_mlp_case(torch, label, gx_, gf_, p_, randn) -> dict:
    """The grouped-MLP kernels against their plain version at one shape:
    the forward against the float32 plain version, the backward against
    float64 autograd over every row (see the comment below), and the times.
    Returns the row of numbers the kernels line takes."""
    from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk

    b_, m_, ns_, _ = gx_.shape
    pooled, cnt = gk.group_mlp_fwd(gx_, gf_, p_)
    want = gk.group_mlp_maxpool_plain(gx_, gf_, p_)
    scale = want.abs().max().item()
    # three layers of float32 products summed in another order than cuBLAS
    fwd_err = (pooled - want).abs().max().item()
    check(f"group_mlp_fwd[{label}]", fwd_err, 2e-5 * scale, "pooled")
    # the backward is held against autograd in float64, where repeated
    # rows stay exactly tied, through the same three layers with every
    # ReLU's on/off pattern given: float64's own, except on the rows that
    # hold a hidden pre-activation within rounding of 0, where the pattern
    # is the float32 one that the kernel's summation order gives
    # (`fma_chain`), so that every row is held to the one tolerance. The
    # pooled cotangent is kept off the (group, channel)s whose two largest
    # values lie within rounding of each other without being an exact
    # tie, or whose maximum lies within rounding of 0: there the versions
    # may rightly pick different rows.
    p64 = gk.FoldedMLP(*(t.double() for t in p_))
    x0 = gx_ if gf_ is None else torch.cat([gx_, gf_], dim=-1)
    with torch.no_grad():
        z1 = x0.double() @ p64.w1 + p64.b1
        z2 = torch.relu(z1) @ p64.w2 + p64.b2
        on1, on2 = z1 > 0, z2 > 0
        fragile = torch.zeros(b_, m_, ns_, dtype=torch.bool, device="cuda")
        for z in (z1, z2):
            fragile |= (z.abs() < 2e-5 * z.abs().max()).any(-1)
        a1 = torch.relu(fma_chain(torch, x0[fragile], p_.w1) + p_.b1)
        f1 = a1 > 0
        f2 = fma_chain(torch, a1, p_.w2) + p_.b2 > 0
        switched = int((f1 != on1[fragile]).sum() + (f2 != on2[fragile]).sum())
        on1[fragile], on2[fragile] = f1, f2
        del z1, z2, z, a1, f1, f2
    xg = gx_.double().requires_grad_(True)
    fg = gf_.double().requires_grad_(True) if gf_ is not None else None
    z1 = xg @ p64.w1[:3] + p64.b1
    if fg is not None:
        z1 = z1 + fg @ p64.w1[3:]
    z2 = (z1 * on1) @ p64.w2 + p64.b2
    a3 = torch.relu((z2 * on2) @ p64.w3 + p64.b3)
    top2 = torch.topk(a3.detach(), 2, dim=2).values
    gap = top2[:, :, 0] - top2[:, :, 1]
    gap_ok = ((gap > 1e-4 * scale) | (gap == 0)) & (top2[:, :, 0] > 1e-4 * scale)
    gcot = (randn(b_, m_, p_.w3.shape[1]) * gap_ok).contiguous()
    grads = torch.autograd.grad(
        (torch.amax(a3, dim=2) * gcot.double()).sum(),
        [xg] + ([fg] if fg is not None else []))
    del a3, z1, z2, top2, gap, on1, on2
    got = gk.group_mlp_bwd(gcot, gx_, gf_, p_, pooled, cnt)
    tied = int((cnt > 1).sum())
    bwd_errs = []
    for g_, w_, what in zip(got, grads, ("dgx", "dgf")):
        w_ = w_.float()
        err = (g_ - w_).abs().max().item()
        # float32 sums of up to 512 products a layer in another order
        check(f"group_mlp_bwd[{label}]", err, 2e-5 * w_.abs().max().item(),
              f"{what}, every row")
        bwd_errs.append(err)
    print(f"  group_mlp_bwd[{label}]: {int(fragile.sum())} of {fragile.numel()} "
          f"rows hold a pre-activation within rounding of 0, and {switched} "
          f"of their hidden units are on in float32 and off in float64 or "
          f"the reverse; {int(gap_ok.sum())}/{gap_ok.numel()} maxima carry "
          f"a cotangent")
    del grads, xg, fg
    c0, c1_, c2_, c3_ = p_.w1.shape[0], p_.w1.shape[1], p_.w2.shape[1], p_.w3.shape[1]
    flops = 2.0 * b_ * m_ * ns_ * (c0 * c1_ + c1_ * c2_ + c2_ * c3_)
    g_all = randn(b_, m_, c3_)
    xr = gx_.clone().requires_grad_(True)
    fr = gf_.clone().requires_grad_(True) if gf_ is not None else None
    ins = [xr] + ([fr] if fr is not None else [])
    wbytes = nbytes(*p_[:6])
    r_ = dict(
        fwd_err=fwd_err, bwd_err=max(bwd_errs), flops=flops, tied=tied,
        fwd_ms=time_ms(lambda: gk.group_mlp_fwd(gx_, gf_, p_)),
        fwd_plain=time_ms(lambda: gk.group_mlp_maxpool_plain(gx_, gf_, p_), iters=5),
        fwd_bound=bound_ms(nbytes(gx_, pooled, cnt) + wbytes
                           + (nbytes(gf_) if gf_ is not None else 0), flops),
        bwd_ms=time_ms(lambda: gk.group_mlp_bwd(g_all, gx_, gf_, p_, pooled, cnt)),
        bwd_plain=time_ms(lambda: torch.autograd.grad(
            (gk.group_mlp_maxpool_plain(xr, fr, p_) * g_all).sum(), ins), iters=5),
        # the recompute and one dz @ w^T product a layer (no weight
        # gradients): twice the forward
        bwd_bound=bound_ms(2 * nbytes(gx_) + nbytes(g_all, pooled, cnt) + 2 * wbytes
                           + (2 * nbytes(gf_) if gf_ is not None else 0), 2.0 * flops),
    )
    print(f"  group_mlp[{label}]: {tied} (group, channel)s with tied maxima; "
          f"fwd ms={r_['fwd_ms']:.4f} plain={r_['fwd_plain']:.4f} bound="
          f"{r_['fwd_bound'][0]:.4f}; bwd ms={r_['bwd_ms']:.4f} plain="
          f"{r_['bwd_plain']:.4f} bound={r_['bwd_bound'][0]:.4f}")
    return r_


def ssg_kernel_checks(torch) -> list[dict]:
    """Phase 2, second half: the PointNet++ kernels at the SSG victim's three
    set-abstraction shapes (b=32: 1024 -> 512 centres x 64 samples, 512 -> 128
    x 64 with 128 features, GroupAll of 128 points with 256 features)."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.ops.kernels import (
        ballquery_group_kernel as bk,
        fps_kernel as fk,
        scatter_kernel as sk,
    )

    out = []
    entry = entry_into(out)
    pc, nrm, rng = make_batch(torch, B, N, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(7)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    # --- farthest-point sampling -------------------------------------------
    near = pc.clone()
    near[:, 3:40] *= 0.01  # points the skip rule drops
    near[1] *= 1e-3  # a cloud with every point dropped: all picks are 0
    big, _, _ = make_batch(torch, B, 2 * N, seed=4)
    start = torch.from_numpy(rng.randint(0, 2 * N, B).astype(np.int32)).cuda()
    fps_idx = fk.fps(pc, 512)
    cases = {
        "SA1 1024->512, skip": (pc, 512, None, True, fps_idx),
        "512->128, skip": (pc[:, :512].contiguous(), 128, None, True, None),
        "uniform loss 1024->51": (pc, 51, None, True, None),
        "skipped points and a fully skipped cloud": (near, 512, None, True, None),
        "no skip": (near, 512, None, False, None),
        "subsample 2048->1024 from a start, no skip": (big, N, start, False, None),
    }
    for label, (x_, m_, st_, skip_, got_) in cases.items():
        got_ = fk.fps(x_, m_, st_, skip_) if got_ is None else got_
        require_equal(torch, f"fps[{label}]", got_,
                      fk.fps_plain(x_, m_, st_, skip_), "idx")
    fps_big = fk.fps(big, N, start, False)
    if fk.fps(near, 512)[1].any() or not fps_big[:, 0].equal(start):
        _fail("fps: the fully skipped cloud is not all index 0, or a start "
              "index is not the first pick")
    print(f"  fps: idx bit-equal to plain (required) at {list(cases)}")
    entry("fps", "geoa3_tpu_torch/csrc/fps.cu",
          "geoa3_tpu/ops/pallas/fps_kernel.py:29", 0.0,
          time_ms(lambda: fk.fps(pc, 512)),
          time_ms(lambda: fk.fps_plain(pc, 512), iters=3, warm=1),
          bound_ms(nbytes(pc, fps_idx), 9.0 * B * N * 511), None,
          "[32,1024,3] -> [32,512]; sequential depth 511 rounds of a "
          "block-wide argmax on 32 of 132 SMs; subsample [32,2048,3] -> "
          f"[32,1024]: ms={time_ms(lambda: fk.fps(big, N, start, False)):.4f} "
          f"bound_ms={bound_ms(nbytes(big, start, fps_big), 9.0 * B * 2 * N * (N - 1))[0]:.4f}")

    # --- ball query + group, forward and backward --------------------------
    c1 = ops.gather_points(pc, fps_idx)
    c2 = ops.gather_points(c1, fk.fps(c1, 128))
    f1 = randn(B, 512, 128)
    far = c2.clone()
    far[:, ::2] += 100.0  # every other ball is empty
    bq_cases = {
        "SA1 cf=0 r=0.2": (pc, c1, None, 0.2, 64),
        "SA2 cf=128 r=0.4": (c1, c2, f1, 0.4, 64),
        "cf=3 (normals)": (pc, c1, nrm, 0.2, 64),
        "empty balls": (c1, far, f1, 0.4, 64),
        "over-full balls r=2": (c1, c2, None, 2.0, 64),
        "nsample 64 > n 48": (c1[:, :48].contiguous(), c2, None, 0.4, 64),
    }
    kept = {}
    for label, (x_, c_, f_, r_, ns_) in bq_cases.items():
        got = bk.ballquery_group_fwd(x_, c_, f_, r_, ns_)
        want = bk.ballquery_group_plain(x_, c_, f_, r_, ns_)
        for g_, w_, what in zip(got, want, ("idx", "gx", "gf")):
            if w_ is not None:
                require_equal(torch, f"ballquery_group_fwd[{label}]", g_, w_, what)
        require_equal(torch, f"ball_query[{label}]",
                      bk.ballquery_group_fwd(x_, c_, None, r_, ns_, gather=False)[0],
                      want[0], "idx (gathers compiled out)")
        kept[label] = got
    if kept["empty balls"][0][:, ::2].any():
        _fail("ballquery_group_fwd: an empty ball does not hold index 0")
    print("  ballquery_group_fwd: idx, gx, gf bit-equal to plain, with and "
          f"without the gathers (required) at {list(bq_cases)}")

    def scanned(idx_, x_, c_, r_, ns_):
        """Distance tests this data needs: a full ball stops at its last
        slot's point, an under-full one reads the whole cloud."""
        hits = (bk.pairwise_sqdist(c_, x_) < bk._r2(r_)).sum(-1)
        n_ = x_.shape[1]
        return torch.where(hits >= ns_, idx_[..., -1].long() + 1,
                           torch.full_like(hits, n_)).sum().item()

    idx1, gx1, _ = kept["SA1 cf=0 r=0.2"]
    idx2, gx2, gf2 = kept["SA2 cf=128 r=0.4"]
    sa1_ms = time_ms(lambda: bk.ballquery_group_fwd(pc, c1, None, 0.2, 64))
    entry("ballquery_group_fwd", "geoa3_tpu_torch/csrc/ballquery_group.cu",
          "geoa3_tpu/ops/pallas/ballquery_group_kernel.py:177", 0.0,
          time_ms(lambda: bk.ballquery_group_fwd(c1, c2, f1, 0.4, 64)),
          time_ms(lambda: bk.ballquery_group_plain(c1, c2, f1, 0.4, 64)),
          bound_ms(nbytes(c1, c2, f1, idx2, gx2, gf2),
                   10.0 * scanned(idx2, c1, c2, 0.4, 64)), None,
          "SA2 xyz [32,512,3], centres [32,128,3], feats [32,512,128], ns=64 "
          "-> idx [32,128,64], gx [32,128,64,3], gf [32,128,64,128]; SA1 "
          f"[32,1024,3] x [32,512,3], cf=0: ms={sa1_ms:.4f} bound_ms="
          f"{bound_ms(nbytes(pc, c1, idx1, gx1), 10.0 * scanned(idx1, pc, c1, 0.2, 64))[0]:.4f}")

    bwd_err = 0.0
    for label, n_ in (("SA1 cf=0 r=0.2", N), ("SA2 cf=128 r=0.4", 512),
                      ("empty balls", 512)):
        idx_, gx_, gf_ = kept[label]
        dgx = randn(*gx_.shape)
        dgf = randn(*gf_.shape) if gf_ is not None else None
        got = bk.ballquery_group_bwd(idx_, dgx, dgf, n_)
        want = bk.ballquery_group_bwd_plain(idx_, dgx, dgf, n_)
        for g_, w_, what in zip(got, want, ("dxyz", "dcentre", "dfeats")):
            if w_ is None:
                continue
            # float32 sums of up to a few thousand colliding rows (an empty
            # ball sends all its slots to point 0) in atomic order
            err = (g_ - w_).abs().max().item()
            check(f"ballquery_group_bwd[{label}]", err,
                  2e-5 * w_.abs().max().item(), what)
            bwd_err = max(bwd_err, err)
    dgx2, dgf2 = randn(*gx2.shape), randn(*gf2.shape)
    dgx1 = randn(*gx1.shape)
    sa1_bwd_ms = time_ms(lambda: bk.ballquery_group_bwd(idx1, dgx1, None, N))
    sa1_bwd_bound = bound_ms(nbytes(idx1, dgx1, *(
        t for t in bk.ballquery_group_bwd(idx1, dgx1, None, N) if t is not None)),
        3.0 * idx1.numel())[0]
    bout = bk.ballquery_group_bwd(idx2, dgx2, dgf2, 512)
    entry("ballquery_group_bwd", "geoa3_tpu_torch/csrc/ballquery_group.cu",
          "geoa3_tpu/ops/pallas/ballquery_group_kernel.py:224", bwd_err,
          time_ms(lambda: bk.ballquery_group_bwd(idx2, dgx2, dgf2, 512)),
          time_ms(lambda: bk.ballquery_group_bwd_plain(idx2, dgx2, dgf2, 512)),
          bound_ms(nbytes(idx2, dgx2, dgf2, *bout), 131.0 * idx2.numel()), None,
          "SA2 idx [32,128,64], dgx [32,128,64,3], dgf [32,128,64,128] -> "
          "dxyz [32,512,3], dcentre [32,128,3], dfeats [32,512,128]; SA1 "
          f"(cf=0): ms={sa1_bwd_ms:.4f} bound_ms={sa1_bwd_bound:.4f}")

    # --- C-channel scatter -------------------------------------------------
    flat2 = idx2.reshape(B, -1).contiguous()  # S = 8192 into 512 rows
    ct2 = dgf2.reshape(B, -1, 128)
    flat1 = idx1.reshape(B, -1).contiguous()  # S = 32768 into 1024 rows
    ct1 = randn(B, flat1.shape[1], 128)
    sc_err = 0.0
    for label, (i_, c_, n_) in {"S=8192 n=512 C=128": (flat2, ct2, 512),
                                "S=32768 n=1024 C=128": (flat1, ct1, N),
                                "C=5": (flat2, ct2[..., :5].contiguous(), 512)}.items():
        g_ = sk.scatter_add_nc(i_, c_, n_)
        w_ = sk.scatter_add_nc_plain(i_, c_, n_)
        # float32 sums of the rows that collide (tens to hundreds: ball
        # neighbourhoods overlap), in atomic order
        err = (g_ - w_).abs().max().item()
        check(f"scatter_add_nc[{label}]", err, 2e-5 * w_.abs().max().item(), "out")
        sc_err = max(sc_err, err)
    lib_idx = (flat1.long() + N * torch.arange(B, device="cuda")[:, None]).reshape(-1)
    lib_ct = ct1.reshape(-1, 128)
    lib_out = torch.zeros(B * N, 128, device="cuda")
    sc_out = sk.scatter_add_nc(flat1, ct1, N)
    entry("scatter_add_nc", "geoa3_tpu_torch/csrc/scatter.cu",
          "geoa3_tpu/ops/pallas/scatter_kernel.py:94", sc_err,
          time_ms(lambda: sk.scatter_add_nc(flat1, ct1, N)),
          time_ms(lambda: sk.scatter_add_nc_plain(flat1, ct1, N)),
          bound_ms(nbytes(flat1, ct1, sc_out), 1.0 * ct1.numel()),
          time_ms(lambda: lib_out.index_add_(0, lib_idx, lib_ct)),
          "idx [32,32768], ct [32,32768,128] -> [32,1024,128] (library: "
          "index_add_ on the flattened batch); S=8192 into 512 rows: ms="
          f"{time_ms(lambda: sk.scatter_add_nc(flat2, ct2, 512)):.4f}")
    del ct1, lib_ct, lib_out, sc_out

    # --- grouped MLP + max-pool, forward and backward ----------------------
    gx3 = c2[:, None].contiguous()  # GroupAll: [32, 1, 128, 3]
    gf3 = torch.relu(randn(B, 1, 128, 256))
    gx3[:, :, 1::8] = gx3[:, :, 0::8]  # duplicated rows: exact ties
    gf3[:, :, 1::8] = gf3[:, :, 0::8]
    shapes = {
        "SA1": (gx1, None, random_mlp(torch, gen, 0, (64, 64, 128))),
        "SA2": (gx2, torch.relu(gf2), random_mlp(torch, gen, 128, (128, 128, 256))),
        "SA3": (gx3, gf3, random_mlp(torch, gen, 256, (256, 512, 1024))),
    }
    rows = {label: group_mlp_case(torch, label, gx_, gf_, p_, randn)
            for label, (gx_, gf_, p_) in shapes.items()}
    if rows["SA3"]["tied"] == 0 or rows["SA1"]["tied"] == 0:
        _fail("group_mlp: the inputs held no tied maxima, the tie split is unchecked")
    r2_ = rows["SA2"]
    others = lambda k1, k2: "; ".join(  # noqa: E731
        f"{lab}: ms={rows[lab][k1]:.4f} bound_ms={rows[lab][k2][0]:.4f}"
        for lab in ("SA1", "SA3"))
    entry("group_mlp_fwd", "geoa3_tpu_torch/csrc/group_mlp.cu",
          "geoa3_tpu/ops/pallas/group_mlp_kernel.py:158",
          max(r["fwd_err"] for r in rows.values()), r2_["fwd_ms"],
          r2_["fwd_plain"], r2_["fwd_bound"], None,
          "SA2 rows 32*128*64 x (131->128->128->256) -> [32,128,256]; SA1 rows "
          "32*512*64 x (3->64->64->128), SA3 rows 32*1*128 x "
          f"(259->256->512->1024): {others('fwd_ms', 'fwd_bound')}")
    entry("group_mlp_bwd", "geoa3_tpu_torch/csrc/group_mlp.cu",
          "geoa3_tpu/ops/pallas/group_mlp_kernel.py:177",
          max(r["bwd_err"] for r in rows.values()), r2_["bwd_ms"],
          r2_["bwd_plain"], r2_["bwd_bound"], None,
          "SA2 -> dgx [32,128,64,3], dgf [32,128,64,128] (plain: autograd "
          "through the plain forward, forward included; max_abs_err against "
          "float64 autograd over every row, with the float32 ReLU pattern on "
          "the rows that hold a pre-activation within rounding of 0); "
          f"{others('bwd_ms', 'bwd_bound')}")
    return out


def sa_fused_case(torch, label, xyz, cen, feats, radius, ns, p_, randn,
                  timed=False) -> dict:
    """sa_fused_fwd/_bwd against the plain version at one shape: the ball
    query's indices bit-equal to `ball_query_plain`, pooled against the
    float32 plain version, the backward against float64 autograd over every
    row as in `group_mlp_case` (the kernel's float32 ReLU pattern on rows
    with a hidden pre-activation within rounding of 0, read from the
    kernel's own projections P and Yc; the pooled cotangent kept off maxima
    within rounding of a runner-up or of 0). With `timed`, the kernels', the
    plain version's and the split pair's times and the bounds."""
    from geoa3_tpu_torch.ops.kernels import (
        ballquery_group_kernel as bk,
        group_mlp_kernel as gk,
        sa_fused_kernel as sf,
    )
    from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs

    b_, n_ = xyz.shape[:2]
    m_ = cen.shape[1]
    cf = 0 if feats is None else feats.shape[-1]
    pooled, cnt, idx, proj, yc = sf.sa_fused_fwd(xyz, cen, feats, radius, ns, p_)
    require_equal(torch, f"sa_fused_fwd[{label}]", idx,
                  bk.ball_query_plain(xyz, cen, radius, ns), "idx")
    want = sf.sa_query_group_mlp_plain(xyz, cen, feats, radius, ns, p_)
    scale = want.abs().max().item()
    # layer 1 from projections summed in another order than cuBLAS's, two
    # more layers of float32 products
    fwd_err = (pooled - want).abs().max().item()
    check(f"sa_fused_fwd[{label}]", fwd_err, 2e-5 * scale, "pooled")

    p64 = gk.FoldedMLP(*(t.double() for t in p_))

    def layer1(x, c, f, w1):
        prj = x @ w1[:3] + (f @ w1[3:] if f is not None else 0.0)
        return (gather_nbrs(prj, idx) - (c @ w1[:3])[:, :, None]) + p64.b1

    with torch.no_grad():
        z1 = layer1(xyz.double(), cen.double(),
                    feats.double() if feats is not None else None, p64.w1)
        z2 = torch.relu(z1) @ p64.w2 + p64.b2
        on1, on2 = z1 > 0, z2 > 0
        fragile = torch.zeros(b_, m_, ns, dtype=torch.bool, device="cuda")
        for z in (z1, z2):
            fragile |= (z.abs() < 2e-5 * z.abs().max()).any(-1)
        z1k = ((gather_nbrs(proj, idx) - yc[:, :, None]) + p_.b1)[fragile]
        a1 = torch.relu(z1k)
        f1 = a1 > 0
        f2 = fma_chain(torch, a1, p_.w2) + p_.b2 > 0
        switched = int((f1 != on1[fragile]).sum() + (f2 != on2[fragile]).sum())
        on1[fragile], on2[fragile] = f1, f2
        del z1, z2, z, z1k, a1, f1, f2
    xg = xyz.double().requires_grad_(True)
    cg = cen.double().requires_grad_(True)
    fg = feats.double().requires_grad_(True) if feats is not None else None
    z2 = (layer1(xg, cg, fg, p64.w1) * on1) @ p64.w2 + p64.b2
    a3 = torch.relu((z2 * on2) @ p64.w3 + p64.b3)
    top2 = torch.topk(a3.detach(), 2, dim=2).values
    gap = top2[:, :, 0] - top2[:, :, 1]
    gap_ok = ((gap > 1e-4 * scale) | (gap == 0)) & (top2[:, :, 0] > 1e-4 * scale)
    gcot = (randn(b_, m_, p_.w3.shape[1]) * gap_ok).contiguous()
    ins = [xg, cg] + ([fg] if fg is not None else [])
    grads = torch.autograd.grad((torch.amax(a3, dim=2) * gcot.double()).sum(), ins)
    del a3, z2, top2, gap, on1, on2
    got = sf.sa_fused_bwd(gcot, p_, cf, pooled, cnt, idx, proj, yc)
    bwd_errs = []
    for g_, w_, what in zip(got, grads, ("dxyz", "dnew_xyz", "dfeats")):
        w_ = w_.float()
        err = (g_ - w_).abs().max().item()
        # float32 products in another order, and the scatter's atomics
        check(f"sa_fused_bwd[{label}]", err, 2e-5 * w_.abs().max().item(),
              f"{what}, every row")
        bwd_errs.append(err)
    print(f"  sa_fused[{label}]: {int(fragile.sum())} of {fragile.numel()} rows "
          f"hold a pre-activation within rounding of 0 ({switched} hidden units "
          f"switched), {int(gap_ok.sum())}/{gap_ok.numel()} maxima carry a "
          f"cotangent, {int((cnt > 1).sum())} tied maxima")
    del grads, xg, cg, fg
    r_ = dict(fwd_err=fwd_err, bwd_err=max(bwd_errs), idx=idx)
    if not timed:
        return r_
    c1, c2, c3 = p_.w1.shape[1], p_.w2.shape[1], p_.w3.shape[1]
    rows_ = b_ * m_ * ns
    proj_flops = 2.0 * (b_ * n_ * (3 + cf) * c1 + b_ * m_ * 3 * c1)
    mlp_flops = 2.0 * rows_ * (c1 * c2 + c2 * c3)
    wbytes = nbytes(*p_)
    fbytes = nbytes(feats) if feats is not None else 0
    g_all = randn(b_, m_, c3)
    xr = xyz.clone().requires_grad_(True)
    cr = cen.clone().requires_grad_(True)
    fr = feats.clone().requires_grad_(True) if feats is not None else None
    ins = [xr, cr] + ([fr] if fr is not None else [])
    r_.update(
        fwd_ms=time_ms(lambda: sf.sa_fused_fwd(xyz, cen, feats, radius, ns, p_)),
        fwd_plain=time_ms(lambda: sf.sa_query_group_mlp_plain(
            xyz, cen, feats, radius, ns, p_), iters=5),
        fwd_bound=bound_ms(nbytes(xyz, cen, proj, yc, idx, pooled, cnt) + fbytes
                           + wbytes, proj_flops + mlp_flops),
        bwd_ms=time_ms(lambda: sf.sa_fused_bwd(g_all, p_, cf, pooled, cnt, idx,
                                               proj, yc)),
        bwd_plain=time_ms(lambda: torch.autograd.grad(
            (sf.sa_query_group_mlp_plain(xr, cr, fr, radius, ns, p_) * g_all).sum(),
            ins), iters=5),
        # the recompute and the backward of layers 2-3 (twice the layers'
        # forward), the back-projection, one addition a scattered entry
        bwd_bound=bound_ms(nbytes(proj, yc, idx, pooled, cnt, g_all, xyz, cen)
                           + fbytes + wbytes,
                           2.0 * mlp_flops + proj_flops + rows_ * c1),
    )
    # the alternative route a later PR weighs: the split pair (the fused
    # ball query + grouping, then the grouped MLP), forward and backward
    _, sgx, sgf = bk.ballquery_group_fwd(xyz, cen, feats, radius, ns)
    spooled, scnt = gk.group_mlp_fwd(sgx, sgf, p_)

    def split_fwd():
        i_, gx_, gf_ = bk.ballquery_group_fwd(xyz, cen, feats, radius, ns)
        return gk.group_mlp_fwd(gx_, gf_, p_)

    def split_bwd():
        dgx, dgf = gk.group_mlp_bwd(g_all, sgx, sgf, p_, spooled, scnt)
        return bk.ballquery_group_bwd(idx, dgx, dgf, n_)

    r_.update(split_fwd=time_ms(split_fwd), split_bwd=time_ms(split_bwd))
    del sgx, sgf
    print(f"  sa_fused[{label}]: fwd ms={r_['fwd_ms']:.4f} plain={r_['fwd_plain']:.4f} "
          f"bound={r_['fwd_bound'][0]:.4f} split pair={r_['split_fwd']:.4f}; bwd "
          f"ms={r_['bwd_ms']:.4f} plain={r_['bwd_plain']:.4f} bound="
          f"{r_['bwd_bound'][0]:.4f} split pair={r_['split_bwd']:.4f}")
    return r_


def msg_kernel_checks(torch, kernels: list) -> list[dict]:
    """Phase 2, third part: the PointNet++ MSG victim's kernels at its shapes
    (b=32): the whole-scale kernel at SA2's three scales (512 -> 128 centres,
    ns 32/64/128, 320 features), at cf=0 and cf=3 and with empty and
    over-full balls; the grouped MLP at SA1's three scales and at GroupAll
    (128 points, 640 features: the 16-row backward tile), whose numbers join
    the group_mlp entries of `kernels`; and the k-neighbour 3-channel
    scatter at [32,1024,17,3] -> 1024."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.ops.kernels import (
        ballquery_group_kernel as bk,
        fps_kernel as fk,
        knn_kernel as qk,
        scatter_kernel as sk,
    )

    out = []
    entry = entry_into(out)
    pc, nrm, rng = make_batch(torch, B, N, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x1 = ops.gather_points(pc, fk.fps(pc, 512))  # SA1's centres
    x2 = ops.gather_points(x1, fk.fps(x1, 128))  # SA2's centres
    f1 = torch.relu(randn(B, 512, 320))  # SA1's 64 + 128 + 128 features

    # --- the whole set-abstraction scale ------------------------------------
    sa2 = {"SA2 r=0.2 ns=32": (0.2, 32, (64, 64, 128)),
           "SA2 r=0.4 ns=64": (0.4, 64, (128, 128, 256)),
           "SA2 r=0.8 ns=128": (0.8, 128, (128, 128, 256))}
    rows = {label: sa_fused_case(torch, label, x1, x2, f1, r_, ns_,
                                 random_mlp(torch, gen, 320, w_), randn, timed=True)
            for label, (r_, ns_, w_) in sa2.items()}
    far = x2.clone()
    far[:, ::2] += 100.0  # every other ball is empty
    others = {
        "cf=0 r=0.1 ns=16": (pc, x1, None, 0.1, 16),
        "cf=3 (normals) r=0.1 ns=16": (pc, x1, nrm, 0.1, 16),
        "empty balls": (x1, far, f1, 0.2, 32),
        "over-full balls r=2": (x1, x2, f1, 2.0, 32),
    }
    for label, (x_, c_, f_, r_, ns_) in others.items():
        cf_ = 0 if f_ is None else f_.shape[-1]
        rows[label] = sa_fused_case(torch, label, x_, c_, f_, r_, ns_,
                                    random_mlp(torch, gen, cf_, (32, 32, 64)), randn)
    if rows["empty balls"]["idx"][:, ::2].any():
        _fail("sa_fused_fwd: an empty ball does not hold index 0")
    head = rows["SA2 r=0.8 ns=128"]
    rest = lambda k1, k2, ks: "; ".join(  # noqa: E731
        f"{lab}: ms={rows[lab][k1]:.4f} bound_ms={rows[lab][k2][0]:.4f} "
        f"split pair ms={rows[lab][ks]:.4f}"
        for lab in ("SA2 r=0.2 ns=32", "SA2 r=0.4 ns=64"))
    entry("sa_fused_fwd", "geoa3_tpu_torch/csrc/sa_fused.cu",
          "geoa3_tpu/ops/pallas/sa_fused_kernel.py:108",
          max(r["fwd_err"] for r in rows.values()), head["fwd_ms"],
          head["fwd_plain"], head["fwd_bound"], None,
          "MSG SA2 r=0.8 ns=128: xyz [32,512,3], centres [32,128,3], feats "
          "[32,512,320], (323->128->128->256) -> [32,128,256] (projections, "
          "query, gather, MLP, pool; three device kernels); split pair "
          f"(ballquery_group + group_mlp) ms={head['split_fwd']:.4f}; "
          + rest("fwd_ms", "fwd_bound", "split_fwd"))
    entry("sa_fused_bwd", "geoa3_tpu_torch/csrc/sa_fused.cu",
          "geoa3_tpu/ops/pallas/sa_fused_kernel.py:140",
          max(r["bwd_err"] for r in rows.values()), head["bwd_ms"],
          head["bwd_plain"], head["bwd_bound"], None,
          "MSG SA2 r=0.8 ns=128 -> dxyz [32,512,3], dnew_xyz [32,128,3], "
          "dfeats [32,512,320] (recompute + scatter, two back-projections; "
          "plain: autograd through the plain forward, forward included; "
          "max_abs_err against float64 autograd over every row, with the "
          "kernel's float32 ReLU pattern where a pre-activation is within "
          f"rounding of 0); split pair ms={head['split_bwd']:.4f}; "
          + rest("bwd_ms", "bwd_bound", "split_bwd"))

    # --- the grouped MLP at MSG's shapes -------------------------------------
    mshapes = {}
    for r_, ns_, w_ in ((0.1, 16, (32, 32, 64)), (0.2, 32, (64, 64, 128)),
                        (0.4, 128, (64, 96, 128))):
        _, gx_, _ = bk.ballquery_group_fwd(pc, x1, None, r_, ns_)
        mshapes[f"MSG SA1 ns={ns_}"] = (gx_, None, random_mlp(torch, gen, 0, w_))
    gx3 = x2[:, None].contiguous()  # GroupAll: [32, 1, 128, 3]
    gf3 = torch.relu(randn(B, 1, 128, 640))
    gx3[:, :, 1::8] = gx3[:, :, 0::8]  # duplicated rows: exact ties
    gf3[:, :, 1::8] = gf3[:, :, 0::8]
    mshapes["MSG GroupAll cf=640"] = (gx3, gf3,
                                      random_mlp(torch, gen, 640, (256, 512, 1024)))
    mrows = {label: group_mlp_case(torch, label, gx_, gf_, p_, randn)
             for label, (gx_, gf_, p_) in mshapes.items()}
    if mrows["MSG GroupAll cf=640"]["tied"] == 0:
        _fail("group_mlp: GroupAll's inputs held no tied maxima")
    for k in kernels:
        if k["name"] in ("group_mlp_fwd", "group_mlp_bwd"):
            which = "fwd" if k["name"].endswith("fwd") else "bwd"
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                r[f"{which}_err"] for r in mrows.values()])
            k["shape"] += "; MSG (GroupAll's backward on 16-row tiles): " + "; ".join(
                f"{lab}: ms={r[which + '_ms']:.4f} plain_ms="
                f"{r[which + '_plain']:.4f} bound_ms={r[which + '_bound'][0]:.4f}"
                for lab, r in mrows.items())

    # --- the k-neighbour 3-channel scatter ----------------------------------
    kidx = qk.knn(pc, pc, K + 1)[1]  # [32, 1024, 17]: every row hit ~17 times
    kct = randn(B, N, K + 1, 3)
    sg = sk.scatter_add_3(kidx, kct, N)
    sw = sk.scatter_add_3_plain(kidx, kct, N)
    # float32 sums of a few dozen colliding terms in atomic order
    s3_err = (sg - sw).abs().max().item()
    check("scatter_add_3", s3_err, 1e-5 * sw.abs().max().item(), "out")
    bad = kidx.clone()
    bad[:, :, 0] = N  # out of range: dropped
    check("scatter_add_3[out-of-range rows dropped]",
          (sk.scatter_add_3(bad, kct, N) - sk.scatter_add_3_plain(bad, kct, N)).abs().max().item(),
          1e-5 * sw.abs().max().item(), "out")
    lib_idx = (kidx.long() + N * torch.arange(B, device="cuda")[:, None, None]).reshape(-1)
    lib_ct = kct.reshape(-1, 3)
    lib_out = torch.zeros(B * N, 3, device="cuda")
    s3_ms = time_ms(lambda: sk.scatter_add_3(kidx, kct, N))
    s3_lib = time_ms(lambda: lib_out.index_add_(0, lib_idx, lib_ct))
    host = {"scatter_add_3": host_us(torch, lambda: sk.scatter_add_3(kidx, kct, N)),
            "index_add_": host_us(torch, lambda: lib_out.index_add_(0, lib_idx, lib_ct))}
    print(f"  scatter_add_3: ms={s3_ms:.4f} index_add_ms={s3_lib:.4f}; host us "
          "per call (200 calls, no sync inside): " + ", ".join(
              f"{k}={v:.2f}" for k, v in host.items()))
    entry("scatter_add_3", "geoa3_tpu_torch/csrc/scatter.cu",
          "geoa3_tpu/ops/pallas/scatter_kernel.py:31", s3_err, s3_ms,
          time_ms(lambda: sk.scatter_add_3_plain(kidx, kct, N)),
          bound_ms(nbytes(kidx, kct, sg), 1.0 * kct.numel()), s3_lib,
          "idx [32,1024,17], ct [32,1024,17,3] -> [32,1024,3] (row 2's device "
          "kernel at S = 17408; library: index_add_ on the flattened batch); "
          "host us per call: " + ", ".join(f"{k}={v:.2f}" for k, v in host.items()))
    return out


def dense_kernel_checks(torch, kernels: list) -> None:
    """Phase 2, last part: the streaming selection and the mask readers past
    the main path's shapes. Rows 3, 5 and 11 bit-equal to their plain
    versions at a ragged n = 1000 (b=2: most mask rows start off a 16-byte
    boundary), at the reference's dense n = 10000 (b=2) and at 12288 (one
    cloud), the kNN also at one query row against m = 10000 (the partial-
    variable patch query); rows 8 and 9 at n = 1000 and row 8 at 10000;
    row 4 at n = 1000 and 12288. The dense shapes' times and bounds join
    the `shape` notes of `kernels`."""
    from geoa3_tpu_torch.ops.kernels import kappa_kernel as kk, knn_kernel as qk

    notes = {k_["name"]: [] for k_ in kernels}

    def curv_case(label, pc, nrm, rng):
        b_, n_, _ = pc.shape
        mask = kk.kappa_selmask(pc, K)
        ref = torch.from_numpy(np.abs(rng.randn(b_, n_)).astype(np.float32)).cuda()
        adv = (pc + 1e-3 * torch.from_numpy(
            rng.randn(b_, n_, 3).astype(np.float32)).cuda()).contiguous()
        cv, gr = kk.curv_term(adv, nrm, ref, mask, K)
        cv_p, gr_p = kk.curv_term_plain(adv, nrm, ref, mask, K)
        # as at [32,1024]: sums in other orders, analytic against autograd
        check(f"curv_term{label}", (cv - cv_p).abs().max().item(),
              1e-5 * cv_p.abs().max().item(), "curv")
        check(f"curv_term{label}", (gr - gr_p).abs().max().item(),
              1e-4 * gr_p.abs().max().item(), "grad")
        del cv_p, gr_p
        notes["curv_term"].append(
            f"{label}: ms={time_ms(lambda: kk.curv_term(adv, nrm, ref, mask, K), iters=5):.4f} "
            f"bound_ms={bound_ms(nbytes(adv, nrm, ref, mask, cv, gr), 60.0 * b_ * n_ * (K + 1))[0]:.4f}")

    ragged, dense, _ = DENSE_CHECKS
    for b_, n_ in DENSE_CHECKS:
        pc, nrm, rng = make_batch(torch, b_, n_, seed=30 + n_)
        label = f"[{b_},{n_}]"
        mask = kk.kappa_selmask(pc, K)
        require_equal(torch, f"kappa_selmask{label}", mask,
                      kk.kappa_selmask_plain(pc, K), "mask")
        if not torch.all(mask.sum(-1, dtype=torch.int32) == K + 1):
            _fail(f"kappa_selmask{label} rows do not hold k+1 members")
        kp, km = kk.kappa_fwd(pc, nrm, K)
        kp_p, km_p = kk.kappa_fwd_plain(pc, nrm, K)
        require_equal(torch, f"kappa_fwd{label}", km, km_p, "mask")
        # same selection and per-pair terms; the k-term sum in another order
        check(f"kappa_fwd{label}", (kp - kp_p).abs().max().item(),
              1e-5 * kp_p.abs().max().item(), "kappa")
        del kp_p, km_p
        knn_cases = {f"self k={K + 1}": (pc, pc, K + 1)}
        if (b_, n_) == dense:
            knn_cases["one query row k=4"] = (pc[:, 5:6].contiguous(), pc, 4)
        for lab, (q_, p_, k_) in knn_cases.items():
            for g_, w_, what in zip(qk.knn(q_, p_, k_), qk.knn_plain(q_, p_, k_),
                                    ("dists", "idx", "nbrs")):
                require_equal(torch, f"knn{label} {lab}", g_, w_, what)
        print(f"  {label}: kappa_selmask, kappa_fwd's mask, knn at "
              f"{list(knn_cases)} bit-equal to plain (required)")
        g = torch.from_numpy(rng.randn(b_, n_).astype(np.float32)).cuda()
        for radius in {ragged: ("direct", "expansion"), dense: ("direct",)}.get((b_, n_), ()):
            gb = kk.kappa_bwd(pc, nrm, km, g, K, radius)
            gb_p = kk.kappa_bwd_plain(pc, nrm, km, g, K, radius)
            # as at [32,1024]
            check(f"kappa_bwd[{radius}]{label}", (gb - gb_p).abs().max().item(),
                  2e-4 * gb_p.abs().max().item(), "grad")
            del gb_p
        if (b_, n_) == ragged:
            kf = kk.kappa_frommask(pc, nrm, km, K)
            kf_p = kk.kappa_from_mask_plain(pc, nrm, km, K)
            check(f"kappa_frommask{label}", (kf - kf_p).abs().max().item(),
                  1e-5 * kf_p.abs().max().item(), "kappa")
        if (b_, n_) != dense:
            curv_case(label, pc, nrm, rng)
        pairs_d = b_ * n_ * n_
        notes["kappa_selmask"].append(
            f"{label}: ms={time_ms(lambda: kk.kappa_selmask(pc, K), iters=5):.4f} "
            f"bound_ms={bound_ms(nbytes(pc, mask), 11.0 * pairs_d)[0]:.4f}")
        if (b_, n_) == dense:
            kres = qk.knn(pc, pc, K + 1)
            notes["kappa_fwd"].append(
                f"{label}: ms={time_ms(lambda: kk.kappa_fwd(pc, nrm, K), iters=5):.4f} "
                f"bound_ms={bound_ms(nbytes(pc, nrm, kp, km), 11.0 * pairs_d + 20.0 * b_ * n_ * K)[0]:.4f}")
            notes["knn"].append(
                f"{label} self k={K + 1}: ms={time_ms(lambda: qk.knn(pc, pc, K + 1), iters=5):.4f} "
                f"bound_ms={bound_ms(nbytes(pc, pc, *kres), 11.0 * pairs_d)[0]:.4f}")
            notes["kappa_bwd"].append(
                f"{label} direct: ms={time_ms(lambda: kk.kappa_bwd(pc, nrm, km, g, K, 'direct'), iters=5):.4f} "
                f"bound_ms={bound_ms(nbytes(pc, nrm, km, g, gb), 60.0 * b_ * n_ * (K + 1))[0]:.4f}")
            del kres
        del pc, nrm, mask, kp, km, g
    torch.cuda.empty_cache()
    for k_ in kernels:
        if notes[k_["name"]]:
            k_["shape"] += "; dense: " + "; ".join(notes[k_["name"]])
            print(f"  {k_['name']} dense: " + "; ".join(notes[k_["name"]]))


MAIN_PATH = ("nn1_payload", "scatter_add_3t", "kappa_selmask", "curv_term",
             "kappa_fwd", "pool_fwd", "pool_bwd")
# kernels that no engine path launches (as in the JAX package): the public
# ops that reach them are a path of their own
PUBLIC_OPS = ("nn1_dual", "kappa_frommask", "scatter_add_nc", "scatter_add_3")
SSG_PATH = ("nn1_payload", "scatter_add_3t", "kappa_selmask", "curv_term",
            "kappa_fwd", "fps", "ballquery_group_fwd", "ballquery_group_bwd",
            "group_mlp_fwd", "group_mlp_bwd")
MSG_PATH = SSG_PATH + ("sa_fused_fwd", "sa_fused_bwd")


def msg_launches(steps: int, refresh: int) -> dict:
    """Every kernel's launches in `steps` steps of the default attack on the
    MSG victim (one binary step), read from the code: per step one victim
    forward and backward (FPS at SA1 and SA2; the split pair at SA1's three
    scales, cf=0; the whole-scale kernel at SA2's three, cf=320; the grouped
    MLP at SA1's scales and GroupAll; the 3-channel scatter for the
    backward of the two FPS gathers and of the o2a Chamfer term), the 1-NN
    payload and the curvature term; a selection mask every `refresh` steps;
    the kappa prologue once."""
    from geoa3_tpu_torch.ops.kernels import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want.update(nn1_payload=steps, scatter_add_3t=3 * steps,
                kappa_selmask=steps // refresh, curv_term=steps, kappa_fwd=1,
                fps=2 * steps, ballquery_group_fwd=3 * steps,
                ballquery_group_bwd=3 * steps, group_mlp_fwd=4 * steps,
                group_mlp_bwd=4 * steps, sa_fused_fwd=3 * steps,
                sa_fused_bwd=3 * steps)
    return want


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

        covered = set().union(*self.required.values())
        if covered != set(KERNELS):
            _fail(f"no path launches {sorted(set(KERNELS) - covered)}")

    def launches(self, kernel):
        """The count of the first path that names the kernel, and the counts
        of every path."""
        by_path = {label: c[kernel] for label, c in self.counts.items()}
        first = next(label for label, req in self.required.items()
                     if kernel in req)
        return by_path[first], by_path


def timed_attack(torch, fn, args, steps):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    res = fn(*args)
    e.record()
    e.synchronize()
    return res, s.elapsed_time(e) / steps


def check_result(torch, res, steps, label, b=B, n=N):
    for name, t in res._asdict().items():
        if t.is_floating_point() and name != "best_loss" and not torch.isfinite(t).all():
            _fail(f"{label}: attack result {name} is not finite")
    if res.best_attack.shape != (b, n, 3) or res.all_loss.shape != (steps, b):
        _fail(f"{label}: attack result has the wrong shape")


def attack_phase(torch, paths) -> dict:
    """Phase 3: the default attack end to end on the card."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    model, logits_fn = random_victim("PointNet", seed=0)
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


def synthetic_labels(torch, b: int = B):
    """The ModelNet40 ids of workload.synthetic_batch's shape classes. A
    random victim does not predict them, so an untargeted attack against
    them succeeds at once for most instances."""
    from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES

    return torch.tensor([TEN_LABEL_INDEXES[i % 10] for i in range(b)],
                        device="cuda")


def side_modes_phase(torch, paths) -> dict:
    """Phase 4: the engine's side modes through make_attack_fn at full width."""
    import dataclasses

    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.attack import project
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    _, logits_fn = random_victim("PointNet", seed=0)
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
    from geoa3_tpu_torch.workload import random_victim

    root = REPO / "build" / "chip_smoke"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    model, _ = random_victim("PointNet", seed=0)
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


def cli_more_runs(torch, paths) -> dict:
    """Phase 7, last part: the CLI on the PointNet++ SSG and MSG victims, and
    in subsample mode on clouds of 2048 points (into phase 5's directory)."""
    import scipy.io as sio

    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main
    from geoa3_tpu_torch.workload import random_victim

    root = REPO / "build" / "chip_smoke"
    for arch, name in (("PointNetPP", "victim_ssg.pt"),
                       ("PointNetPP_MSG", "victim_msg.pt")):
        model, _ = random_victim(arch, seed=0)
        torch.save(model.state_dict(), root / name)
    per_class = 4
    runs = {
        "CLI PointNetPP": (
            ["--arch", "PointNetPP", "--checkpoint", str(root / "victim_ssg.pt"),
             "--data_dir_file", f"synthetic:{per_class}:{N}",
             "--iter_max_steps", "10"], SSG_PATH, N),
        "CLI PointNetPP_MSG": (
            ["--arch", "PointNetPP_MSG", "--checkpoint",
             str(root / "victim_msg.pt"),
             "--data_dir_file", f"synthetic:{per_class}:{N}",
             "--iter_max_steps", "10"], MSG_PATH, N),
        "CLI subsample": (
            ["--checkpoint", str(root / "victim.pt"), "--is_subsample_opt",
             "--eval_num", "3", "--npoint", str(N),
             "--data_dir_file", f"synthetic:{per_class}:{2 * N}",
             "--iter_max_steps", "10"],
            ("nn1_payload", "scatter_add_3t", "kappa_fwd", "kappa_bwd", "fps",
             "pool_fwd", "pool_bwd"), 2 * N),
    }
    out = {}
    for label, (extra, need, n_saved) in runs.items():
        argv = ["--attack", "GeoA3", "--attack_label", "Untarget", "-b", str(B),
                "--binary_max_steps", "1",
                "--exps_root", str(root / "Exps")] + extra
        t0 = time.time()
        saved, _ = paths.run(label, need,
                             lambda: cli_main(build_parser().parse_args(argv)))
        torch.cuda.synchronize()
        secs = time.time() - t0
        saved = Path(saved)
        mats = sorted(p.name for p in (saved / "Mat").iterdir())
        total = 10 * per_class
        rate = float((saved / "attack_result.txt").read_text().strip()
                     .splitlines()[-1].split(":")[1])
        if not mats or abs(rate - 100.0 * len(mats) / total) > 0.01:
            _fail(f"{label}: attack_result.txt says {rate}% and {len(mats)} of "
                  f"{total} instances were saved")
        cloud = sio.loadmat(saved / "Mat" / mats[0])["adversary_point_clouds"]
        if cloud.shape != (3, n_saved) or not np.isfinite(cloud).all():
            _fail(f"{label}: saved cloud has shape {cloud.shape} or is not finite")
        metrics = json.loads((saved / "attack_metrics.json").read_text())
        if metrics["num_successful"] != len(mats) or not np.isfinite(
                metrics["mean_chamfer"]):
            _fail(f"{label}: attack_metrics.json is off: {metrics}")
        print(f"  {label}: {total} clouds, 1x10 steps, {len(mats)} saved "
              f"({rate:.2f}%), {secs:.1f} s")
        out[label] = dict(saved=len(mats), total=total, seconds=secs)
    return out


def public_ops_phase(torch, paths) -> None:
    """The public ops whose kernels no engine path launches, through their
    differentiable entry points at the paths' shapes: `ops.nn1_dual`,
    `ops.knn_kappa_from_mask`, `ops.group_points` on 128 feature channels
    (its backward is the C-channel scatter), `ops.scatter_add_3` at
    [32,1024,17,3], and the feature-propagation module (`ops.three_nn`,
    `ops.three_interpolate`, 512 points from 128) forward and backward
    against the same module on the CPU."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.models.pointnetpp import PointnetFPModule
    from geoa3_tpu_torch.ops.kernels import scatter_kernel as sk

    pc, nrm, rng = make_batch(torch, B, N, seed=8)
    adv = (pc + 0.01 * torch.from_numpy(
        rng.randn(B, N, 3).astype(np.float32)).cuda()).contiguous()
    unknown, known = pc[:, :512].contiguous(), pc[:, 512:640].contiguous()
    ufeats = torch.from_numpy(rng.randn(B, 512, 128).astype(np.float32))
    kfeats = torch.from_numpy(rng.randn(B, 128, 256).astype(np.float32))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        fp = PointnetFPModule([256 + 128, 256, 256]).eval()
    with torch.no_grad():  # non-trivial BatchNorm statistics
        for bn in (fp.mlp[1], fp.mlp[4]):
            bn.running_mean.uniform_(-0.1, 0.1)
            bn.running_var.uniform_(0.5, 1.5)

    def fp_run(dev):
        """FP forward and the gradients of both feature inputs."""
        uf = ufeats.to(dev).requires_grad_(True)
        kf = kfeats.to(dev).requires_grad_(True)
        _, nn_idx = ops.three_nn(unknown.to(dev), known.to(dev))
        y = fp.to(dev)(unknown.to(dev), known.to(dev), uf, kf)
        duf, dkf = torch.autograd.grad((y * y).sum(), [uf, kf])
        return [t.detach().cpu() for t in (nn_idx, y, duf, dkf)]

    def run():
        a2o, o2a = ops.nn1_dual(adv, pc)
        x = adv.clone().requires_grad_(True)
        kappa = ops.knn_kappa_from_mask(x, nrm, ops.kappa_select_mask(adv, K), K)
        kappa.sum().backward()
        centres = ops.gather_points(pc, ops.furthest_point_sampling(pc, 128))
        idx = ops.ball_query(0.4, 64, pc, centres)
        feats = torch.from_numpy(
            rng.randn(B, N, 128).astype(np.float32)).cuda().requires_grad_(True)
        w = torch.from_numpy(rng.randn(B, 128, 64, 128).astype(np.float32)).cuda()
        (ops.group_points(feats, idx) * w).sum().backward()
        kidx = ops.knn_points(pc, pc, K + 1).idx
        kct = torch.from_numpy(rng.randn(B, N, K + 1, 3).astype(np.float32)).cuda()
        s3 = ops.scatter_add_3(kidx, kct, N)
        return (a2o, o2a, kappa, x.grad, idx, w, feats.grad, kidx, kct, s3,
                fp_run("cuda"))

    (a2o, o2a, kappa, dx, idx, w, dfeats, kidx, kct, s3, fp_card), _ = paths.run(
        "public ops", PUBLIC_OPS + ("kappa_bwd", "knn"), run)
    for name, t in (("kappa", kappa), ("dcloud", dx), ("dfeats", dfeats),
                    ("scatter_add_3", s3)):
        if not torch.isfinite(t).all():
            _fail(f"public ops: {name} is not finite")
    if a2o.shape != (B, N) or o2a.shape != (B, N) or dfeats.shape != (B, N, 128):
        _fail("public ops: an output has the wrong shape")
    want = sk.scatter_add_nc_plain(idx.reshape(B, -1), w.reshape(B, -1, 128), N)
    # float32 sums of the rows that collide, in atomic order
    check("group_points backward", (dfeats - want).abs().max().item(),
          2e-5 * want.abs().max().item(), "dfeats vs the plain scatter")
    want = sk.scatter_add_3_plain(kidx, kct, N)
    check("ops.scatter_add_3", (s3 - want).abs().max().item(),
          1e-5 * want.abs().max().item(), "out vs the plain scatter")
    fp_cpu = fp_run("cpu")
    require_equal(torch, "three_nn (card vs CPU)", fp_card[0], fp_cpu[0], "idx")
    for g_, c_, what in zip(fp_card[1:], fp_cpu[1:],
                            ("output", "unknown features' gradient",
                             "known features' gradient")):
        # float32 products in other orders (cuBLAS against the CPU's);
        # interpolation weights from bit-equal selections
        check("PointnetFPModule, card vs CPU", (g_ - c_).abs().max().item(),
              1e-5 * c_.abs().max().item(), what)


def pointnetpp_phase(torch, paths, arch: str) -> dict:
    """Phases 6 and 8: the default attack on a PointNet++ victim (SSG or MSG)
    at its published width."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    tag, required = ("SSG", SSG_PATH) if arch == "PointNetPP" else ("MSG", MSG_PATH)
    _, logits_fn = random_victim(arch, seed=0)
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    with torch.no_grad():
        logits = logits_fn(pc)
    if logits.shape != (B, 40) or not torch.isfinite(logits).all():
        _fail(f"{tag}: the victim's logits are not finite [32, 40]")
    gt = logits.argmax(-1)

    def run(cfg, seed):
        fn = make_attack_fn(logits_fn, cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return timed_attack(torch, fn, (pc, nrm, gt, gt, gen),
                            cfg.binary_max_steps * cfg.iter_max_steps)

    run(main_path_config(1, 10, arch=arch), 99)  # warm-up
    steps = 30
    cfg = main_path_config(1, steps, arch=arch)
    label = f"{tag} K=10"
    (res, ms_step), counts = paths.run(label, required, lambda: run(cfg, 0))
    check_result(torch, res, steps, label)
    if arch == "PointNetPP":
        # per forward: FPS and the fused query+group at two levels, the
        # grouped MLP at three; per step one forward and one backward
        want = {"fps": 2 * steps, "ballquery_group_fwd": 2 * steps,
                "ballquery_group_bwd": 2 * steps, "group_mlp_fwd": 3 * steps,
                "group_mlp_bwd": 3 * steps, "pool_fwd": 0, "pool_bwd": 0}
    else:
        want = msg_launches(steps, cfg.curv_knn_refresh_every)
    got = {k: counts[k] for k in want}
    if got != want:
        _fail(f"{tag} launches {got}, expected {want}")
    per_step = {k: v / steps for k, v in counts.items() if v}
    print(f"  {label} attack: 1x{steps} steps, {ms_step:.4f} ms/step (CUDA "
          f"events), success {int(res.success.sum())}/{B}; launches per step "
          f"{per_step}")
    return dict(ms_per_step=ms_step, launches_per_step=per_step,
                success=int(res.success.sum()))


def pointnetpp_cpu_agreement(torch, arch: str) -> None:
    """A short attack on a PointNet++ victim on the card against the same
    attack on the CPU (the kernels' plain versions), from the same weights
    and initial offsets; and the victim with normals as features."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.models.pointnetpp import (
        PointNet2ClassificationMSG,
        PointNet2ClassificationSSG,
    )
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    tag = "SSG" if arch == "PointNetPP" else "MSG"
    b, steps = 2, 4
    model, _ = random_victim(arch, seed=2, device="cpu")
    pc, nrm, rng = make_batch(torch, b, N, seed=2)
    off = torch.from_numpy(1e-3 * rng.randn(b, N, 3).astype(np.float32))
    cfg = main_path_config(1, steps, refresh=2, arch=arch)
    results = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        m.requires_grad_(False)
        x, nx = pc.to(dev), nrm.to(dev)
        with torch.no_grad():
            gt = m(x).argmax(-1)
        fn = make_attack_fn(m, cfg, init_offset=lambda i: off)
        results[dev] = fn(x, nx, gt, gt)
    g, c = results["cuda"], results["cpu"]
    a, b_ = g.all_loss.cpu(), c.all_loss
    rel = ((a - b_).abs().mean() / b_.abs().mean()).item()
    # float32 sums in other orders feed 4 Adam steps
    print(f"  card vs CPU {tag} attack ([2,1024], 1x{steps} steps): mean rel "
          f"all_loss diff {rel:.3e} (tol 1e-3), success {g.success.tolist()} "
          f"vs {c.success.tolist()}")
    if not rel <= 1e-3:
        _fail(f"the {tag} attack on the card disagrees with the CPU run")

    # normals as features ([b, n, 6]: three feature channels at the first
    # level, where the layer-1 input is 6 wide and the whole-scale kernel
    # runs): logits and input gradient
    cls = PointNet2ClassificationSSG if arch == "PointNetPP" else PointNet2ClassificationMSG
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        vn = cls(use_normal=True).eval().requires_grad_(False)
    out = {}
    for dev in ("cuda", "cpu"):
        x = torch.cat([pc, nrm], -1).to(dev).requires_grad_(True)
        logits = vn.to(dev)(x)
        (grad,) = torch.autograd.grad((logits ** 2).sum(), x)
        out[dev] = (logits.detach().cpu(), grad.cpu())
    for (g_, c_), what, tol in zip(zip(*out.values()), ("logits", "input gradient"),
                                   (5e-4, 5e-3)):
        # float32 layers in other summation orders; in the gradient a ReLU or
        # a maximum within rounding of a tie may switch, which moves single
        # entries (the bounds of the JAX package's own fused-against-unfused
        # model test)
        check(f"{tag} with normals, card vs CPU", (g_ - c_).abs().max().item(),
              tol * c_.abs().max().item(), what)


def subsample_phase(torch, paths) -> dict:
    """Phase 7: subsample mode with the uniform loss on PointNet: clouds of
    2048 points resampled to 1024 each step, a three-fold resampling vote."""
    import dataclasses

    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    _, logits_fn = random_victim("PointNet", seed=0)
    pc, nrm, _ = make_batch(torch, B, 2 * N, seed=6)
    gt = synthetic_labels(torch)
    steps, votes = 20, 3
    cfg = dataclasses.replace(main_path_config(1, steps), is_subsample_opt=True,
                              eval_num=votes, uniform_loss_weight=1.0)

    def run(seed):
        fn = make_attack_fn(logits_fn, cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return timed_attack(torch, fn, (pc, nrm, gt, gt, gen), steps)

    need = ("nn1_payload", "scatter_add_3t", "kappa_fwd", "kappa_bwd", "fps",
            "ballquery_group_fwd", "knn", "pool_fwd", "pool_bwd")
    (res, ms_step), counts = paths.run("subsample+uniform", need, lambda: run(4))
    check_result(torch, res, steps, "subsample+uniform", n=2 * N)
    # per step: FPS for the loss, for the vote (one launch for all draws) and
    # for the uniform loss's seeds; five ball queries and five kNN launches
    # (the uniform loss's scales); no mask is held, so kappa runs fused
    want = {"fps": 3 * steps, "ballquery_group_fwd": 5 * steps, "knn": 5 * steps,
            "kappa_fwd": steps + 1, "kappa_bwd": steps, "kappa_selmask": 0,
            "curv_term": 0, "ballquery_group_bwd": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        _fail(f"subsample+uniform launches {got}, expected {want}")
    print(f"  subsample+uniform: 1x{steps} steps on [32,2048,3] -> 1024, "
          f"{votes} votes, {ms_step:.4f} ms/step, success "
          f"{int(res.success.sum())}/{B}")
    return dict(ms_per_step=ms_step, success=int(res.success.sum()))


def dense_launches(mode: str, steps: int, phases: int) -> dict:
    """Every kernel's launches in `steps` steps of the dense attack, read
    from the code. Both modes: the kappa prologue at n = 10000 once; per
    step the 1-NN payload, the o2a Chamfer scatter, PointNet's three pools
    forward and backward, and the curvature term through the fused kappa
    forward and its backward (no mask is held). Subsample mode adds per step
    FPS for the loss and for the one-vote resampling (and the vote's forward:
    three more pools), and the FPS gather's backward scatter; kappa runs at
    npoint = 1024. Partial-variable mode runs the victim and kappa on the
    whole cloud and the patch's kNN query once a phase."""
    from geoa3_tpu_torch.ops.kernels import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want.update(nn1_payload=steps, scatter_add_3t=steps, pool_fwd=3 * steps,
                pool_bwd=3 * steps, kappa_fwd=steps + 1, kappa_bwd=steps)
    if mode == "subsample":
        want.update(fps=2 * steps, scatter_add_3t=2 * steps, pool_fwd=6 * steps)
    else:
        want.update(knn=phases)
    return want


def dense_phase(torch, paths) -> dict:
    """Phase 9: dense clouds, the reference's modelnet_pure size (b = 16,
    n = 10000), with runs/bench_dense.py's configuration: PointNet at npoint
    1024, CE + Chamfer + 0.1 Hausdorff + curvature 1.0 with k = 16, subsample
    mode with one resampling vote, 1 x 20 steps; and the same loss in
    partial-variable mode, 1 x 20 steps = 2 phases. The 1-NN payload at
    [16,1024] x [16,10000] and FPS at [16,10000] -> 1024 (the subsample
    path's shapes) are first held bit-equal to their plain versions. Each
    run's launches must equal the counts read from the code; the ms/step
    and the peak device memory are printed."""
    import dataclasses

    from geoa3_tpu_torch import make_attack_fn, ops
    from geoa3_tpu_torch.ops.kernels import fps_kernel as fk, nn1_kernel as nk
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    _, logits_fn = random_victim("PointNet", seed=0)
    pc, nrm, rng = make_batch(torch, DENSE_B, DENSE_N, seed=9)
    gt = synthetic_labels(torch, DENSE_B)

    start = torch.from_numpy(rng.randint(0, DENSE_N, DENSE_B).astype(np.int32)).cuda()
    idx = fk.fps(pc, N, start, False)
    shape = f"[{DENSE_B},{DENSE_N}]"
    require_equal(torch, f"fps{shape}->{N}", idx,
                  fk.fps_plain(pc, N, start, False), "idx")
    sub = ops.gather_points(pc, idx)
    sub = (sub + 1e-3 * torch.from_numpy(
        rng.randn(DENSE_B, N, 3).astype(np.float32)).cuda()).contiguous()
    pay = torch.cat([pc.transpose(1, 2), nrm.transpose(1, 2),
                     torch.zeros(DENSE_B, 2, DENSE_N, device="cuda")], 1).contiguous()
    for g_, w_, what in zip(nk.nn1_dual_payload(sub, pc, pay),
                            nk.nn1_dual_payload_plain(sub, pc, pay),
                            ("a2o", "o2a", "gp", "op")):
        require_equal(torch, f"nn1_payload[{DENSE_B},{N}]x{shape}", g_, w_, what)
    nn1_ms = time_ms(lambda: nk.nn1_dual_payload(sub, pc, pay))
    print(f"  fps {shape}->{N} and nn1_payload [{DENSE_B},{N}]x{shape} "
          f"bit-equal to plain (required); nn1_payload ms={nn1_ms:.4f}")

    steps = 20
    base = dataclasses.replace(main_path_config(1, steps), is_subsample_opt=True,
                               eval_num=1)
    cfgs = {"subsample": base,
            "partial-var": dataclasses.replace(base, is_partial_var=True,
                                               partial_reinit_every=steps // 2)}
    need = {"subsample": ("nn1_payload", "scatter_add_3t", "kappa_fwd",
                          "kappa_bwd", "fps", "pool_fwd", "pool_bwd"),
            "partial-var": ("nn1_payload", "scatter_add_3t", "kappa_fwd",
                            "kappa_bwd", "knn", "pool_fwd", "pool_bwd")}
    out = dict(nn1_payload_ms=nn1_ms)
    for mode, cfg in cfgs.items():
        def run(seed, cfg=cfg):
            fn = make_attack_fn(logits_fn, cfg)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return timed_attack(torch, fn, (pc, nrm, gt, gt, gen), steps)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (res, ms_step), counts = paths.run(f"dense {mode}", need[mode],
                                           lambda: run(5))
        peak = torch.cuda.max_memory_allocated() / 2**30
        check_result(torch, res, steps, f"dense {mode}", b=DENSE_B, n=DENSE_N)
        want = dense_launches("subsample" if mode == "subsample" else "partial",
                              steps, steps // cfg.partial_reinit_every)
        if counts != want:
            _fail(f"dense {mode} launches {counts}, expected {want}")
        print(f"  dense {mode}: {shape}, 1x{steps} steps, {ms_step:.4f} "
              f"ms/step (CUDA events, the n = {DENSE_N} kappa prologue "
              f"included), peak device memory {peak:.2f} GiB, "
              f"success {int(res.success.sum())}/{DENSE_B}")
        out[mode] = dict(ms_per_step=ms_step, peak_gib=peak,
                         success=int(res.success.sum()))
    return out


def cpu_agreement(torch) -> None:
    """A short attack on the card against the same attack on the CPU (the
    kernels' plain versions), from the same weights and initial offsets."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    b, n = 4, 256
    model, _ = random_victim("PointNet", 40, n, seed=2, device="cpu")
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

    def phase(title):
        print(f"{title} (at {time.time() - t0:.1f} s)")

    phase("phase 2: kernels against their plain versions")
    kernels = kernel_checks(torch) + ssg_kernel_checks(torch)
    kernels += msg_kernel_checks(torch, kernels)
    dense_kernel_checks(torch, kernels)
    if args.kernels_only:
        print(json.dumps({"kernels": kernels}))
        return 0

    paths = Paths()
    phase("phase 3: default attack on the card")
    run = attack_phase(torch, paths)
    cpu_agreement(torch)

    phase("phase 4: the engine's side modes at full width")
    side = side_modes_phase(torch, paths)

    phase("phase 5: the attack CLI in process")
    cli = cli_phase(torch, paths)

    phase("phase 6: the attack on the PointNet++ SSG victim at full width")
    ssg = pointnetpp_phase(torch, paths, "PointNetPP")
    pointnetpp_cpu_agreement(torch, "PointNetPP")

    phase("phase 7: subsample mode with the uniform loss; the public ops")
    sub = subsample_phase(torch, paths)
    public_ops_phase(torch, paths)

    phase("phase 8: the attack on the PointNet++ MSG victim at full width; "
          "the CLI on both PointNet++ victims and in subsample mode")
    msg = pointnetpp_phase(torch, paths, "PointNetPP_MSG")
    pointnetpp_cpu_agreement(torch, "PointNetPP_MSG")
    cli.update(cli_more_runs(torch, paths))

    phase("phase 9: dense clouds (n = 10000) in subsample and partial-variable mode")
    dense = dense_phase(torch, paths)

    phase("phase 10: the result")
    paths.check_union()
    for k in kernels:
        k["launches"], k["launches_by_path"] = paths.launches(k["name"])

    print(json.dumps({
        "attack": {"ms_per_step_k10": run["ms_step"],
                   "ms_per_step_exact": run["ms_step_exact"],
                   "launches_exact": run["counts_exact"],
                   "success": run["success"], "batch": B, "card": smi},
        "side_modes": side, "cli": cli, "ssg": ssg, "msg": msg,
        "subsample_uniform": sub, "dense": dense,
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
