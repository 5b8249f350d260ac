#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (geoa3_tpu_torch) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository around the script. Phases:

  1. print the card's name and power limit; build the CUDA kernels (timed);
  2. hold every kernel against its plain PyTorch version at the paths'
     shapes (b=32, n=m=1024, k=16; PointNet's pools at [32, 1024, 128] ->
     1024; kNN also at m != n and at one query row; the dual 1-NN also at
     2048 original against 1024 moved points, and both its variants at
     exact ties, clouds whose points coincide, ragged shapes, one adv row
     and the dense [16,1024] x [16,10000]; PointNet++ SSG's sampling,
     grouping and grouped MLPs at its three set-abstraction shapes, with
     empty, over-full and larger-than-the-cloud balls and duplicated rows,
     the ball query + grouping also at MSG SA1's three scales, a ragged
     n = 1000, n = 8192 (past its shared-memory plan) and the uniform
     loss's five index-only queries, its backward also at cf = 3 and
     with empty balls; kappa from a mask and the kappa backward (both
     radii) also at k = 40, on coincident points and at n = 1000, 2048,
     10000 and 12288 (the last two reading the cloud through L2);
     the MSG victim's whole-scale kernel at SA2's three scales and SA1's
     three with normals (cf=3), at cf=0, with empty and over-full balls and
     at widths of 1024, its grouped MLPs at SA1's three scales and at
     GroupAll with 640 features, the grouped MLPs also at GroupAll with 896
     and 1536 features (16-row tiles) and 2048 and 4096 (layer 1's input in
     slices), and the k-neighbour scatter; the C-channel scatter at its
     path shapes (SSG SA1 and SA2 ball indices, a kNN's and
     three_interpolate's), at C = 1, 5 and 130, on a flat index whose S is
     not a multiple of the group, on empty balls, every slot into point 0,
     and with out-of-range indices; FPS at the paths' shapes (the
     vote's [96, 2048] -> 1024 among them), at a ragged n = 1000, at the
     limit n = 14336, at m > n and with skipped points and a fully skipped
     cloud; the single-pass bf16 grouped MLP at the SSG and MSG victims'
     shapes and at GroupAll with 1536 features (its staged kernels); the
     single-pass bf16 pools of the bf16 victim at its three
     pool shapes (taps 3 on float32 x, taps 1 on bf16 and on float32 x), at
     a ragged n = 1000, on runs of duplicated rows that send columns
     down the backward's recompute and on one critical point that wins
     most columns; two calls of the backward give the same bits, and its
     entries by row are printed), with the tolerance stated, and time
     both (CUDA events, warm,
     median of 20), plus one PyTorch library call where one computes the same
     function, and for the whole-scale kernel the split pair it stands in for.
     The pool forward's whole output (maximum, tie count, first tied rows) is
     held bit-equal to an exact oracle of its fmaf chain at b=2, and so are
     the grouped-MLP forward's maxima and tie counts at all seven PointNet++
     shapes and the two wider GroupAll ones (the first two clouds),
     GroupAll's with ties placed across the blocks a cloud is split over,
     and the grouped-MLP backward against float64 and bit-equal between two
     calls, and timed ten calls back to back beside its forward; the 3-channel
     scatter also in the o2a backward's strided plane layout and on its
     global-atomic route for clouds too large for shared memory; the
     scatter's and the pool wrapper's host time per call are printed. The
     self-kNN selection (mask and fused kappa) and the kNN are also held
     bit-equal at a ragged n = 1000, at n = 10000 and at 12288, the kappa
     backward at 1000 and 10000, the curvature term (direct form) at 1000
     and 12288, with its float32 gradient's distance
     from float64 printed beside the expansion form's; the selection, the
     curvature term, the fused kappa, the kNN and both dual 1-NN variants
     (the payload one also at the dense shape) are also timed ten calls
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
  10. the defense CLI with its three types (random drop, fixed-count and
     variance outlier removal) on phase 5's outputs and the PointNet
     victim, beside 8 synthetic clouds of 2048 points that FPS resamples,
     each run with its launch counts read from the code; every defended
     batch against the CPU (kept points, and PointNet's logits at float32's
     tolerance; the masked forward with TF32 allowed is printed beside it);
     PointNet's forward timed unmasked and masked; the PointNet++ SSG
     victim on the variance defense's padded clouds against the shrunken
     ones; the smoothness CLI, and its point values against the CPU; the
     attack-set distillation CLI on synthetic shapes; two eval forwards of
     each victim bit-equal;
  11. victim training on the card: the training CLI in process for
     PointNet, PointNet++ SSG and MSG at full width (40 classes, 1024
     points, b = 32, 120 synthetic training clouds and 40 test clouds, 2
     epochs, no epoch retry) into build/chip_smoke/train/, with the launch
     counts of the whole run, of one train step and of one eval batch read
     from the code (a train step: FPS, the index-only ball query and the
     C-channel scatter on PointNet++, no kernel on PointNet; an eval batch:
     the eval kernels); result.txt and both checkpoints; two evaluations
     of each trained model bit-equal; the checkpoints loaded by
     `load_victim` bit-equal to the trained model; a train step's and an
     eval batch's times and the peak device memory; a resume of PointNet to
     epoch 3; readiness on PointNet's model_best.pth.tar with phase 10's
     distilled set (exit 0); one train step of each arch on the card
     against the same step on the CPU in float64 with the card's
     selections (PointNet at b = 32, PointNet++ at b = 4);
  12. multi-GPU (parallel/mesh.py) on the one card: (a) a one-rank NCCL
     group in process: the sharded attack on PointNet at full width (b=32,
     1 x 20 steps, K=10) against make_attack_fn at the same seed (success
     and best steps equal, clouds within 1e-4, the losses within 1e-3 mean
     relative; launches read from the code), one sharded train step of
     PointNet at b = 32 against the plain step, a NaN planted in a kernel's
     input caught by utils.profiling.debug_nans at the launch path, and
     phase 3's step as a share of the float32 peak (utils.flops.mfu);
     (b) two ranks sharing the card over gloo, spawned (this script with
     --rank) with a FileStore under build/chip_smoke/mgpu/ and a time limit:
     the attack CLI with --mesh_data_parallel on phase 5's 40 clouds (20
     rows a rank) against one process's CLI (the same Mat/ names, clouds
     within 1e-4; rank 1 writes nothing), and one train step each of
     PointNet at data 2 and at data 1 x model 2 (conv5 512 rows a rank) and
     of PointNet++ SSG at data 2 against one process's step, each rank's
     launches as read from the code;
  13. the bf16 PointNet victim (`--victim_dtype bfloat16`) at full width:
     the health check at [32, 1024, 3], the default attack 1 x 50 (K=10)
     with the bf16 twin's gradient and the float32 victim judging, its
     launch counts read from the code (three single-pass bf16 pool
     launches forward and three backward a step, three float32 pools a
     step for the judge), its ms/step beside the float32 attack's in turns,
     the twin's logits and input gradient card vs CPU, the pool
     backward's entries by row in one attack step, and the attack CLI
     with --victim_dtype bfloat16 on phase 5's 40 clouds and victim
     (build/chip_smoke/bf16/);
  14. print one JSON line listing the kernels, then the result line.

Every path runs with the kernels' launch counts set to 0 just before and
read just after, and fails if a kernel it names was not launched; together
the paths must cover every kernel. `--kernels-only` stops after phase 2.
`--times ROW [--tree DIR]` only builds the kernels and times row ROW's
kernels at its path shapes, with their plain versions and bounds, checking
nothing: those of this checkout, or those of the checkout at DIR (say a
`git archive` of another commit under `build/`), so that two commits are
timed on the same inputs in one call. Row 16, the grouped MLP: the seven
PointNet++ shapes, and for this checkout the wider GroupAll ones; with
`--tree`, this checkout's bf16 forward also runs beside the other's on the
same inputs, with the count of pooled / cnt elements whose bits differ, and
this checkout's bf16 backward on this forward's outputs beside the other's
backward on its own, with the count of dgx / dgf elements whose bits
differ. Row 17,
the whole-scale kernels: MSG SA2's three scales and SA1's three with
normals, with the forward's device time by kernel (torch.profiler) and the
split pair beside it, and for this checkout the backward built without
its scatter epilogue. Row 12, farthest-point sampling: its six path
shapes (ms ten back to back, us a round, the bound). Row 15, the ball
query + grouping: forward and backward at SSG SA1 and SA2 and MSG SA1's
three scales, and the index-only query at the uniform loss's five shapes
(one call and ten back to back, the plain versions' one call, the bounds
for the run's data). Row 13, the C-channel scatter: its four path shapes
(one call and ten back to back, the plain version, `scatter_add_` and
`index_add_` one call each, the bound). Row 8, the kappa backward, with
row 9 (kappa from a mask) and row 4 (the curvature term) beside it: rows
9, 8 (both radii) and 4 at [32,1024] and row 8 (direct) at [16,1024] and
[2,10000] (one call and ten back to back, the plain version's one call,
the bound). Row 6 and 7, the pool kernels (`--times 6`): both
precisions at the bf16 victim's three pool shapes (one call and ten back
to back, the plain versions, the bounds; the bf16 library yardsticks).
`--times step`: the attack step
of phases 3, 6 and 8 (PointNet, SSG, MSG), three runs each.

Any failed check raises, and the script exits non-zero. It never falls back
to the CPU: without a CUDA device it exits non-zero before printing results.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PEAK_F32_FLOPS = None  # the card's float32 peak, set by main (card_peak_flops)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12  # H100 SXM tensor cores, dense bf16
CIN, COUT = 128, 1024  # conv5's channels, the largest pool
DENSE_B, DENSE_N = 16, 10000  # runs/bench_dense.py's batch and cloud size
# (b, n) of the selection's checks past the main path: a ragged n, the
# dense n, and the JAX package's largest padded n
DENSE_CHECKS = ((2, 1000), (2, DENSE_N), (1, 12288))
# GroupAll rows that repeat row 0: on the 32-row tiles of row 16's float32
# kernels at the victims' widths (and past cf = 1837, where layer 1's input
# is staged in slices), they sit in the second, third and fourth block; on
# the 16-row tiles of cf = 896 and 1536, in the fourth, fifth and eighth; on
# the bf16 streamed kernels' 64-row tiles, in the first and second
SPLIT_TIES = [63, 64, 127]
# GroupAll feature counts past the victims': past 32-row forward tiles (16
# rows, 8 blocks a cloud), and past the whole input's limit (32-row tiles,
# layer 1's input staged in slices), run as kernel cases beside the
# victims' shapes
WIDE_GROUPALL = (896, 1536, 2048, 4096)
# a cloud past row 15's shared-memory plan (the walk reads device memory)
BQ_PAST_N = 8192


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


# the checkout whose package runs: this one, or with `--tree DIR` (beside
# `--times`) another one, whose kernels are timed on this script's
# inputs
CODE = (Path(sys.argv[sys.argv.index("--tree") + 1]).resolve()
        if "--tree" in sys.argv[1:-1] else REPO)
if not (CODE / "geoa3_tpu_torch" / "csrc").is_dir():
    _fail(f"geoa3_tpu_torch/ not found in {CODE}")
sys.path.insert(0, str(CODE))
from geoa3_tpu_torch.workload import BATCH as B, KNN as K, NPOINT as N  # noqa: E402


def card_peak_flops() -> float:
    """The card's float32 peak outside the tensor cores, from the
    geoa3_tpu_torch/utils/flops.py beside this script, so that the kernels'
    bounds and utils.flops.mfu share one figure. It is loaded by its path,
    not from the package that runs: with `--tree`, an older checkout may
    have no utils/flops.py, and its times keep this checkout's figure."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "geoa3_card_flops", REPO / "geoa3_tpu_torch" / "utils" / "flops.py")
    flops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flops)
    peak = flops.device_peak_flops()
    if peak is None:
        _fail("utils/flops.py knows no float32 peak for this card")
    return peak


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


def bound_ms(nbytes: float, flops: float, peak: float = None) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over `peak`
    (the card's float32 rate unless given: the bf16 kernels' products run
    on the tensor cores at PEAK_BF16_FLOPS)."""
    tb = nbytes / PEAK_BYTES * 1e3
    tf = flops / (peak or PEAK_F32_FLOPS) * 1e3
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
    """a [r, k] @ w [k, c] in float32 as the grouped-MLP and pool kernels sum
    it: from 0, one fused multiply-add a term, k ascending, each step rounded
    once, as `fmaf` does. The product of two float32 values is exact in
    float64; the float64 sum s = acc + p may round, so its error e (TwoSum,
    exact) is kept, and where s falls on a float32 midpoint with e != 0 the
    result is the float32 neighbour on e's side (what rounding acc + p in
    one step gives), not the even one."""
    acc = torch.zeros(a.shape[0], w.shape[1], device=a.device)
    a64, w64 = a.double(), w.double()
    for k in range(w.shape[0]):
        x, p = acc.double(), a64[:, k:k + 1] * w64[k]
        s = x + p
        bp = s - x
        e = (x - (s - bp)) + (p - bp)
        f = s.float()
        up = s > f.double()
        g = torch.nextafter(f, torch.where(up, torch.full_like(f, float("inf")),
                                           torch.full_like(f, -float("inf"))))
        tie = (s == (f.double() + g.double()) * 0.5) & (e != 0)
        # on a tie the exact sum lies past s on e's side: take that neighbour
        want_up = e > 0
        hi = torch.maximum(f, g)
        lo = torch.minimum(f, g)
        acc = torch.where(tie, torch.where(want_up, hi, lo), f)
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


def nn1_cases(torch, nk, adv, pc, rng):
    """Both dual 1-NN variants bit-equal to their plain versions (a2o, o2a,
    gp, op; a2o, o2a) where an order-free fold could go wrong: exact ties,
    clouds whose points coincide, ragged shapes, one adv row, and the dense
    subsample shape [16,1024] x [16,10000]. Returns the dense case's inputs
    and the payload kernel's outputs there."""
    def case(a_, o_):
        b_, m_ = o_.shape[0], o_.shape[1]
        return a_, o_, torch.from_numpy(rng.randn(b_, 8, m_).astype(np.float32)).cuda()

    def cloud(b, n):
        return torch.from_numpy(rng.randn(b, n, 3).astype(np.float32)).cuda()

    ori_t = pc.clone()
    ori_t[:, N // 2] = ori_t[:, 10]  # duplicated ori points
    ori_t[:, N - 1] = ori_t[:, 10]
    adv_t = adv.clone()
    adv_t[:, 20] = ori_t[:, 10]  # adv rows on (duplicated) ori points
    adv_t[:, N - 24] = ori_t[:, 0]
    adv_t[:, 3 * N // 4] = adv_t[:, 3]  # two adv rows that tie for every column
    # one point with an exact square norm: every distance between copies is 0
    pt = torch.tensor([0.5, -0.25, 0.125], device="cuda")
    ori_d = make_batch(torch, DENSE_B, DENSE_N, seed=9)[0]
    dense = f"dense [{DENSE_B},{N}]x[{DENSE_B},{DENSE_N}]"
    cases = {
        f"ties [{B},{N}]x[{B},{N}]": case(adv_t, ori_t),
        "all coincident [2,1000]x[2,1500]": case(
            pt.expand(2, 1000, 3).contiguous(), pt.expand(2, 1500, 3).contiguous()),
        "ori coincident [2,1000]x[2,1500]": case(
            cloud(2, 1000), pt.expand(2, 1500, 3).contiguous()),
        "ragged [3,1000]x[3,1500]": case(cloud(3, 1000), cloud(3, 1500)),
        "ragged [2,1500]x[2,1000]": case(cloud(2, 1500), cloud(2, 1000)),
        f"n=1 [{B},1]x[{B},{N}]": case(adv[:, 5:6].contiguous(), pc),
        dense: case((ori_d[:, :N] + 1e-3 * cloud(DENSE_B, N)).contiguous(), ori_d),
    }
    for label, (a_, o_, p_) in cases.items():
        got = nk.nn1_dual_payload(a_, o_, p_)
        for g_, w_, what in zip(got, nk.nn1_dual_payload_plain(a_, o_, p_),
                                ("a2o", "o2a", "gp", "op")):
            require_equal(torch, f"nn1_payload[{label}]", g_, w_, what)
        for g_, w_, what in zip(nk.nn1_dual(a_, o_), nk.nn1_dual_plain(a_, o_),
                                ("a2o", "o2a")):
            require_equal(torch, f"nn1_dual[{label}]", g_, w_, what)
        if label.startswith("all coincident") and (
                got[0].any().item() or got[1].any().item()):
            _fail(f"nn1_payload[{label}]: index 0 did not win every tie")
    print("  nn1_payload and nn1_dual bit-equal to plain (required) at: "
          + "; ".join(cases))
    return cases[dense], got  # the dense case runs last


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
    (sub_d, ori_d, pay_d), got_d = nn1_cases(torch, nk, adv, pc, rng)
    bound_d = bound_ms(nbytes(sub_d, ori_d, pay_d, *got_d),
                       10.0 * DENSE_B * N * DENSE_N)
    nn1_ten = ten_ms(lambda: nk.nn1_dual_payload(adv, pc, pay))
    dense_ms = time_ms(lambda: nk.nn1_dual_payload(sub_d, ori_d, pay_d))
    dense_ten = ten_ms(lambda: nk.nn1_dual_payload(sub_d, ori_d, pay_d))
    print(f"  nn1_payload ten calls back to back: ms={nn1_ten:.4f} at "
          f"[{B},{N}]x[{B},{N}]; [{DENSE_B},{N}]x[{DENSE_B},{DENSE_N}]: one call "
          f"ms={dense_ms:.4f}, ten ms={dense_ten:.4f}, bound ms={bound_d[0]:.4f} "
          f"({bound_d[1]})")
    entry("nn1_payload", "geoa3_tpu_torch/csrc/nn1.cu",
          "geoa3_tpu/ops/pallas/nn1_kernel.py:200", 0.0,
          time_ms(lambda: nk.nn1_dual_payload(adv, pc, pay)),
          time_ms(lambda: nk.nn1_dual_payload_plain(adv, pc, pay)),
          bound_ms(nbytes(adv, pc, pay, *got), 10.0 * pairs), None,
          f"[32,1024,3]x[32,1024,3], payload [32,8,1024]; ten calls back to "
          f"back: ms={nn1_ten:.4f}; [{DENSE_B},{N}]x[{DENSE_B},{DENSE_N}]: one "
          f"call ms={dense_ms:.4f}, ten ms={dense_ten:.4f}, bound "
          f"ms={bound_d[0]:.4f} ({bound_d[1]})")
    del sub_d, ori_d, pay_d, got_d
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

    # rows 9 and 8 at k = 40 (two member slots a lane), on a cloud with
    # coincident points (a duplicated point in every cloud, a run of six in
    # one), and at [2,2048] (8 rows a stage, fewer than the warps), each on
    # its own mask; the tolerances above
    dup = adv.clone()
    dup[:, 5] = dup[:, 900]
    dup[0, 6:12] = dup[0, 6]
    pc2k, nrm2k, rng2k = make_batch(torch, 2, 2 * N, seed=21)
    g2k = torch.from_numpy(rng2k.randn(2, 2 * N).astype(np.float32)).cuda()
    for label, cloud_c, nrm_c, g_c, k_ in (
            ("k=40", adv, normal_b, gk, 40), ("coincident points", dup, normal_b, gk, K),
            (f"[2,{2 * N}]", pc2k, nrm2k, g2k, K)):
        mask_c = kk.kappa_selmask(cloud_c, k_)
        kf = kk.kappa_frommask(cloud_c, nrm_c, mask_c, k_)
        kf_p = kk.kappa_from_mask_plain(cloud_c, nrm_c, mask_c, k_)
        check(f"kappa_frommask[{label}]", (kf - kf_p).abs().max().item(),
              1e-5 * kf_p.abs().max().item(), "kappa")
        for radius in kk.RADII:
            gb = kk.kappa_bwd(cloud_c, nrm_c, mask_c, g_c, k_, radius)
            gb_p = kk.kappa_bwd_plain(cloud_c, nrm_c, mask_c, g_c, k_, radius)
            if not torch.isfinite(gb).all():
                _fail(f"kappa_bwd[{radius}][{label}] is not finite")
            check(f"kappa_bwd[{radius}][{label}]", (gb - gb_p).abs().max().item(),
                  2e-4 * gb_p.abs().max().item(), "grad")
    del dup, pc2k, nrm2k, g2k, mask_c, kf_p, gb_p

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
          "[32,1024,3]x[32,1024,3] -> int32 [32,1024] x2; ten calls back to "
          f"back: ms={ten_ms(lambda: nk.nn1_dual(adv, pc)):.4f}")

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
        # the gather sums in a fixed order: a second call gives the same bits
        again = pk.pool_bwd(gcot.contiguous(), x2, w3, w3t, bias, pooled2, cnt2, rows2)
        differ = int((dx.view(torch.int32) != again.view(torch.int32)).sum())
        if differ:
            _fail(f"pool_bwd[taps={taps}]: {differ} dx elements differ between two calls")
        print(f"  pool_bwd[taps={taps}]: {int((cnt2 > 4).sum())} columns with "
              f"more than 4 tied rows, {int(gap_ok.sum())}/{B * COUT} columns "
              f"with a cotangent; bit-identical in two calls; entries "
              f"{entries_text(tile_entries(torch, pk, x2, w3, bias, gcot, pooled2, cnt2, rows2))}")
        # timed on the tie-free input, as the main path's activations are:
        # the run of duplicates sends columns down the recompute path
        g_all = torch.randn(B, COUT, device="cuda", generator=gen)
        print(f"  pool_bwd[taps={taps}] entries (g as timed): "
              f"{entries_text(tile_entries(torch, pk, x, w3, bias, g_all, pooled, cnt, rows))}")
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

    # --- pool forward / backward, single-pass bf16 (the bf16 victim) ------
    bf = pool_bf16_checks(torch, pk, gen)
    c5, ti, tf = (bf[label] for label, _, _ in BF16_POOLS)
    others = "; ".join(
        f"{label}: ms={r_['ms']:.4f} ten={r_['ten']:.4f} plain_ms={r_['plain_ms']:.4f} "
        f"library_ms={r_['library_ms']:.4f} (ten {r_['lib_ten']:.4f}) "
        f"bound_ms={r_['bound'][0]:.4f}" for label, r_ in ((BF16_POOLS[1][0], ti),
                                                          (BF16_POOLS[2][0], tf)))
    entry("pool_fwd_bf16", "geoa3_tpu_torch/csrc/pool_matmul_bf16.cu",
          "geoa3_tpu/ops/pallas/pool_matmul_kernel.py:73", c5["err"], c5["ms"],
          c5["plain_ms"], c5["bound"], c5["library_ms"],
          f"{BF16_POOLS[0][0]} [32,1024,128]->[32,1024] (library: F.conv1d in "
          f"bf16 alone, no pool; taps=1 torch.matmul in bf16); ten calls back to "
          f"back: ms={c5['ten']:.4f} library {c5['lib_ten']:.4f}; {others}")
    entry("pool_bwd_bf16", "geoa3_tpu_torch/csrc/pool_matmul_bf16.cu",
          "geoa3_tpu/ops/pallas/pool_matmul_kernel.py:79", c5["dx_err"],
          c5["bwd_ms"], c5["bwd_plain_ms"], c5["bwd_bound"], None,
          f"{BF16_POOLS[0][0]} dx [32,1024,128] (plain: pool_bwd_bf16_plain, "
          f"recompute included); ten calls back to back: ms={c5['bwd_ten']:.4f}; "
          + "; ".join(f"{label}: ms={r_['bwd_ms']:.4f} ten={r_['bwd_ten']:.4f} "
                      f"plain_ms={r_['bwd_plain_ms']:.4f} bound_ms="
                      f"{r_['bwd_bound'][0]:.4f}"
                      for label, r_ in ((BF16_POOLS[1][0], ti), (BF16_POOLS[2][0], tf))))
    return out


# the bf16 victim's three pools: (label, taps, x's type)
BF16_POOLS = (("conv5 taps=3, float32 x", 3, "float32"),
              ("input T-Net taps=1, bf16 x", 1, "bfloat16"),
              ("feature T-Net taps=1, float32 x", 1, "float32"))


def pool_bf16_inputs(torch, taps: int, xdt: str, gen, b: int = B, n: int = N):
    """(x, w3, bias, w3t) of a bf16 victim's pool: x (xdt) after a ReLU,
    w3 and w3t in bf16, bias float32 holding bf16 values."""
    x = torch.relu(torch.randn(b, n, CIN, device="cuda", generator=gen))
    w3 = (torch.randn(taps, CIN, COUT, device="cuda", generator=gen)
          / (taps * CIN) ** 0.5).to(torch.bfloat16).contiguous()
    bias = (0.1 * torch.randn(COUT, device="cuda", generator=gen)).to(
        torch.bfloat16).float()
    return (x.to(getattr(torch, xdt)).contiguous(), w3, bias,
            w3.transpose(1, 2).contiguous())


def pool_bf16_hold(torch, pk, label, x, w3, bias, w3t, gen) -> dict:
    """pool_fwd_bf16 and pool_bwd_bf16 against their plain versions (and
    the backward against itself: two calls give the same bits): pooled
    within 2e-5 of max |z| (the tensor cores' float32 sums against cuBLAS's,
    of the same exact bf16 products); tie counts and rows equal to
    `pool_ties_bf16_plain`'s on the columns whose maximum stands clear of
    every other value by 1e-4 of max |z| in float64 (identical rows tie in
    both); dx within 1e-5 of max |dx| of a float64 backward through those
    ties (2^-8 where x, and so dx, is bf16: one bf16 step at the largest
    entry), the cotangent g / cnt rounded to bf16, with the pooled
    cotangent kept off the other columns."""
    taps = w3.shape[0]
    pooled, cnt, rows = pk.pool_fwd_bf16(x, w3, bias)
    want = pk.pool_affine_max_bf16_plain(x, w3, bias)
    scale = want.abs().max().item()
    err = (pooled - want).abs().max().item()
    check(f"pool_fwd_bf16[{label}]", err, 2e-5 * scale, "pooled")
    z64 = pk.affine_plain(x.to(torch.bfloat16).double(),
                          w3.double(), bias.double())
    mx64 = z64.amax(1)
    tied = z64 == mx64[:, None]
    runner_up = torch.where(tied, -torch.inf, z64).amax(1)
    held = (mx64 - runner_up) > 1e-4 * scale
    _, cnt_p, rows_p = pk.pool_ties_bf16_plain(x, w3, bias)
    require_equal(torch, f"pool_fwd_bf16[{label}]", cnt[held], cnt_p[held],
                  "cnt vs pool_ties_bf16_plain")
    require_equal(torch, f"pool_fwd_bf16[{label}]", rows[held], rows_p[held],
                  "rows vs pool_ties_bf16_plain")
    gcot = torch.randn(*pooled.shape, device="cuda", generator=gen) * held
    coef = (gcot.double()[:, None] / tied.sum(1, keepdim=True)).to(
        torch.bfloat16).double()
    m = torch.where(tied, coef, 0.0)
    w64 = w3.double()
    dx_p = m @ w64[1 if taps == 3 else 0].T
    if taps == 3:
        dx_p[:, :-1] += m[:, 1:] @ w64[0].T
        dx_p[:, 1:] += m[:, :-1] @ w64[2].T
    del z64, tied, m
    dx = pk.pool_bwd_bf16(gcot.contiguous(), x, w3, w3t, bias, pooled, cnt, rows)
    if dx.dtype != x.dtype:
        _fail(f"pool_bwd_bf16[{label}] returned {dx.dtype} for {x.dtype} x")
    # the gather sums in a fixed order: a second call gives the same bits
    again = pk.pool_bwd_bf16(gcot.contiguous(), x, w3, w3t, bias, pooled, cnt, rows)
    bits = torch.int16 if dx.dtype == torch.bfloat16 else torch.int32
    differ = int((dx.view(bits) != again.view(bits)).sum())
    if differ:
        _fail(f"pool_bwd_bf16[{label}]: {differ} dx elements differ between two calls")
    dx_err = (dx.double() - dx_p).abs().max().item()
    # a bf16 x takes its dx in bf16: one bf16 step at the largest entry
    rel = 2.0 ** -8 if x.dtype == torch.bfloat16 else 1e-5
    check(f"pool_bwd_bf16[{label}]", dx_err, rel * dx_p.abs().max().item(), "dx")
    print(f"  pool_bf16[{label}]: pooled err / max |z| {err / scale:.3e}; cnt, "
          f"rows equal to pool_ties_bf16_plain on {int(held.sum())}/{held.numel()} "
          f"columns ({int((cnt_p[held] > 1).sum())} tied, "
          f"{int((cnt[held] > pk.MAX_TIES).sum())} past {pk.MAX_TIES} rows: the "
          f"backward's recompute); dx err / max |dx| "
          f"{dx_err / dx_p.abs().max().item():.3e}, bit-identical in two calls")
    return dict(err=err, dx_err=dx_err, pooled=pooled, cnt=cnt, rows=rows,
                recomputed=int((cnt[held] > pk.MAX_TIES).sum()))


def pool_bf16_times(torch, pk, x, w3, bias, w3t, gen, pooled, cnt, rows) -> dict:
    """The bf16 pool kernels' times at one path shape: one call and ten back
    to back, their plain versions, the bounds (the forward's operations at
    the tensor cores' bf16 rate; the backward's bytes), and the library's
    bf16 product without the pool (F.conv1d for taps 3, torch.matmul for
    taps 1)."""
    import torch.nn.functional as F

    b_, n_, _ = x.shape
    taps = w3.shape[0]
    xb = x.to(torch.bfloat16)
    if taps == 3:
        xs, wt = xb.transpose(1, 2).contiguous(), w3.permute(2, 1, 0).contiguous()
        bb = bias.to(torch.bfloat16)

        def lib():
            return F.conv1d(xs, wt, bb, padding=1)
    else:
        w0 = w3[0].contiguous()

        def lib():
            return torch.matmul(xb, w0)
    g_all = torch.randn(b_, COUT, device="cuda", generator=gen)
    tied_rows = int(cnt.sum().item())
    bwd_flops = 2.0 * tied_rows * taps * CIN
    return dict(
        ms=time_ms(lambda: pk.pool_fwd_bf16(x, w3, bias)),
        ten=ten_ms(lambda: pk.pool_fwd_bf16(x, w3, bias)),
        plain_ms=time_ms(lambda: pk.pool_affine_max_bf16_plain(x, w3, bias), iters=5),
        bound=bound_ms(nbytes(x, w3, bias, pooled, cnt, rows),
                       2.0 * b_ * n_ * CIN * COUT * taps, PEAK_BF16_FLOPS),
        library_ms=time_ms(lib), lib_ten=ten_ms(lib),
        bwd_ms=time_ms(lambda: pk.pool_bwd_bf16(g_all, x, w3, w3t, bias, pooled, cnt, rows)),
        bwd_ten=ten_ms(lambda: pk.pool_bwd_bf16(g_all, x, w3, w3t, bias, pooled, cnt, rows)),
        bwd_plain_ms=time_ms(lambda: pk.pool_bwd_bf16_plain(g_all, x, w3, bias, pooled),
                             iters=5),
        # g, cnt, rows and w3t read once, dx written once in x's type (the
        # formula before the gather wrote float32 dx: `bwd_bound_f32dx`)
        bwd_bound=bound_ms(nbytes(g_all, cnt, rows, w3t) + x.element_size() * x.numel(),
                           bwd_flops),
        bwd_bound_f32dx=bound_ms(nbytes(g_all, cnt, rows, w3t) + 4 * x.numel(), bwd_flops),
        entries=tile_entries(torch, pk, x, w3, bias, g_all, pooled, cnt, rows),
    )


def tile_entries(torch, pk, x, w3, bias, g, pooled, cnt, rows, tile: int = 128) -> dict:
    """The pool backward's entries (a tied z row of a column with a
    cotangent, at each tap) by dx row: the most on one row and on one
    `tile`-row tile (the gather's block), and the rows with any entry. Ties
    past MAX_TIES come from the plain z of w3's precision
    (`affine_bf16_plain` or `affine_plain`: cuBLAS's sums, which may part
    identical rows the kernels' forwards tie)."""
    b_, n_, _ = x.shape
    taps = w3.shape[0]
    cout = cnt.shape[1]
    tied = torch.zeros(b_, n_, cout, dtype=torch.bool, device=x.device)
    s_ = torch.arange(pk.MAX_TIES, device=x.device)
    bi, ci, si = torch.nonzero((s_ < cnt[..., None]) & (cnt[..., None] <= pk.MAX_TIES),
                               as_tuple=True)
    tied[bi, rows[bi, ci, si].long(), ci] = True
    many = cnt > pk.MAX_TIES
    if bool(many.any()):
        affine = pk.affine_bf16_plain if w3.dtype == torch.bfloat16 else pk.affine_plain
        z = affine(x, w3, bias)
        tied |= (z == pooled[:, None]) & many[:, None, :]
    per_p = (tied & (g != 0)[:, None, :]).sum(2)  # [b, n] for one tap
    per_r = per_p.clone()
    if taps == 3:  # dx row r gets z row r + 1 through tap 0, r - 1 through tap 2
        per_r[:, :-1] += per_p[:, 1:]
        per_r[:, 1:] += per_p[:, :-1]
    pad = (-n_) % tile
    per_t = torch.nn.functional.pad(per_r, (0, pad)).view(b_, -1, tile).sum(2)
    return dict(row_max=int(per_r.max()), tile_max=int(per_t.max()),
                rows_any=int((per_r > 0).sum()), rows=per_r.numel(),
                total=int(per_r.sum()))


def entries_text(e: dict) -> str:
    return (f"most on a row {e['row_max']}, on a 128-row tile {e['tile_max']}, rows "
            f"with any {e['rows_any']}/{e['rows']}, in all {e['total']}")


def pool_bf16_checks(torch, pk, gen) -> dict:
    """Phase 2's single-pass bf16 pool kernels: held (`pool_bf16_hold`) and
    timed at the bf16 victim's three pool shapes (with the backward's entries
    by row), then held at a ragged n = 1000, on runs of duplicated rows (more
    than four ties: the backward's recompute, which must find the forward's
    ties: identical rows give identical z) and on one critical point that
    wins most columns of its cloud."""
    out = {}
    for label, taps, xdt in BF16_POOLS:
        x, w3, bias, w3t = pool_bf16_inputs(torch, taps, xdt, gen)
        h = pool_bf16_hold(torch, pk, label, x, w3, bias, w3t, gen)
        out[label] = dict(err=h["err"], dx_err=h["dx_err"], **pool_bf16_times(
            torch, pk, x, w3, bias, w3t, gen, h["pooled"], h["cnt"], h["rows"]))
        r_ = out[label]
        flops = 2.0 * B * N * CIN * COUT * taps
        print(f"  pool_fwd_bf16[{label}]: ms={r_['ms']:.4f} ten={r_['ten']:.4f} "
              f"({flops / r_['ten'] / 1e9:.1f} TFLOP/s) plain_ms={r_['plain_ms']:.4f} "
              f"library_ms={r_['library_ms']:.4f} (ten {r_['lib_ten']:.4f}) "
              f"bound_ms={r_['bound'][0]:.4f}; pool_bwd_bf16 ms={r_['bwd_ms']:.4f} "
              f"ten={r_['bwd_ten']:.4f} plain_ms={r_['bwd_plain_ms']:.4f} "
              f"bound_ms={r_['bwd_bound'][0]:.4f}"
              + (f" (with dx as float32, the formula before the gather: "
                 f"{r_['bwd_bound_f32dx'][0]:.4f})" if x.dtype == torch.bfloat16 else ""))
        print(f"  pool_bwd_bf16[{label}] entries (g as timed): "
              f"{entries_text(r_['entries'])}")
    for label, taps, xdt, n_, runs in (
            ("conv5 taps=3, float32 x, n=1000", 3, "float32", 1000, ()),
            ("conv5 taps=3, float32 x, duplicated rows", 3, "float32", N,
             ((0, 100, 10), (1, 27, 9), (2, 120, 12))),
            ("input T-Net taps=1, bf16 x, duplicated rows", 1, "bfloat16", N,
             ((0, 124, 9), (3, 500, 6))),
            # rows 60-69 cross a 64-row stage of the wgmma forward
            ("feature T-Net taps=1, float32 x, duplicated rows across a stage", 1,
             "float32", N, ((1, 60, 10), (5, 1020, 4))),
            ("conv5 taps=3, float32 x, duplicated rows across a stage", 3, "float32",
             N, ((2, 60, 10), (4, 956, 8))),
            # row 100 of cloud 0 scaled 8x wins most columns: hundreds of
            # entries on each of rows 99-101, split across the gather's warps
            ("conv5 taps=3, float32 x, a critical point", 3, "float32", N, "critical")):
        x, w3, bias, w3t = pool_bf16_inputs(torch, taps, xdt, gen, n=n_)
        if runs == "critical":
            x[0, 100] *= 8.0
            runs = ()
        for b_, r0, length in runs:  # rows in a warp, across warps, across stages
            x[b_, r0:r0 + length] = 3.0 * x[b_, r0]
        h = pool_bf16_hold(torch, pk, label, x, w3, bias, w3t, gen)
        if runs and not h["recomputed"]:
            _fail(f"pool_bf16[{label}]: no column took the backward's recompute")
        if "critical" in label:
            e = tile_entries(torch, pk, x, w3, bias, torch.ones_like(h["pooled"]),
                             h["pooled"], h["cnt"], h["rows"])
            print(f"  pool_bwd_bf16[{label}] entries (every g nonzero): {entries_text(e)}")
            if e["row_max"] < 200:
                _fail(f"pool_bf16[{label}]: the critical point holds {e['row_max']} "
                      "entries on a row, not hundreds")
    return out


def pool_times_phase(torch) -> dict:
    """`--times 6`: rows 6 and 7 in both precisions at the bf16 victim's
    three pool shapes (the float32 kernels on the same x in float32 and w3
    lifted to float32), one call and ten back to back, with the plain
    versions and bounds, checking nothing; the float32 backward also ten
    back to back on x with a run of duplicated rows (`f32_bwd_dup_ten`). A
    checkout without the bf16 kernels (`--tree`) times the float32 ones
    only."""
    from geoa3_tpu_torch.ops.kernels import _build, pool_matmul_kernel as pk

    print(f"pool kernel times of {CODE}")
    _build.lib()
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for label, taps, xdt in BF16_POOLS:
        x, w3, bias, w3t = pool_bf16_inputs(torch, taps, xdt, gen)
        x32, w32 = x.float(), w3.float().contiguous()
        w32t = w32.transpose(1, 2).contiguous()
        pooled, cnt, rows = pk.pool_fwd(x32, w32, bias)
        xd = x32.clone()
        xd[0, 100:110] = 3.0 * xd[0, 100]
        dup = pk.pool_fwd(xd, w32, bias)
        g_all = torch.randn(B, COUT, device="cuda", generator=gen)
        flops = 2.0 * B * N * CIN * COUT * taps
        r_ = dict(
            f32_ms=time_ms(lambda: pk.pool_fwd(x32, w32, bias)),
            f32_ten=ten_ms(lambda: pk.pool_fwd(x32, w32, bias)),
            f32_bound=bound_ms(nbytes(x32, w32, bias, pooled, cnt, rows), flops),
            f32_bwd_ms=time_ms(lambda: pk.pool_bwd(g_all, x32, w32, w32t, bias,
                                                   pooled, cnt, rows)),
            f32_bwd_ten=ten_ms(lambda: pk.pool_bwd(g_all, x32, w32, w32t, bias,
                                                   pooled, cnt, rows)),
            # with phase 2's run of ten duplicated rows in cloud 0: its
            # columns past MAX_TIES ties take the recompute
            f32_bwd_dup_ten=ten_ms(lambda: pk.pool_bwd(g_all, xd, w32, w32t, bias,
                                                       *dup)),
            # g, cnt, rows and w3t read once, dx written once (float32)
            f32_bwd_bound=bound_ms(nbytes(g_all, cnt, rows, w32t) + 4 * x.numel(),
                                   2.0 * int(cnt.sum()) * taps * CIN))
        if hasattr(pk, "pool_fwd_bf16"):
            pb, cb, rb = pk.pool_fwd_bf16(x, w3, bias)
            r_.update({f"bf16_{k}": v for k, v in pool_bf16_times(
                torch, pk, x, w3, bias, w3t, gen, pb, cb, rb).items()})
        out[label] = r_
        print(f"  {label}: " + " ".join(
            f"{k}={v[0] if isinstance(v, tuple) else v:.4f}" for k, v in r_.items()
            if not isinstance(v, dict)), flush=True)
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


def group_mlp_inputs(torch, victim: str) -> dict:
    """The grouped MLP's inputs, label -> (gx, gf, folded MLP), at b=32, made
    from seeds by the checkout's own sampling and grouping kernels. "SSG":
    the SSG victim's three set-abstraction shapes (1024 -> 512 centres x 64
    samples, r=0.2; 512 -> 128 x 64 with 128 features, r=0.4; GroupAll of
    128 points with 256 features). "MSG": its SA1 at the MSG victim's three
    scales (ns 16, 32, 128) and GroupAll with 640 features. "wide": GroupAll
    with 896 and 1536 features, past 32-row forward tiles, and with 2048 and
    4096, past the whole input's limit (its input staged in slices).
    Under-full balls
    repeat their first hit; GroupAll repeats every eighth row (exact ties)
    and row 0 at `SPLIT_TIES` (ties across the blocks a cloud is split
    over)."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.ops.kernels import (
        ballquery_group_kernel as bk,
        fps_kernel as fk,
    )

    pc, _, _ = make_batch(torch, B, N, seed=3 if victim == "SSG" else 11)
    gen = torch.Generator(device="cuda").manual_seed(
        {"SSG": 7, "MSG": 13, "wide": 17}[victim])

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    x1 = ops.gather_points(pc, fk.fps(pc, 512))  # SA1's centres
    x2 = ops.gather_points(x1, fk.fps(x1, 128))  # SA2's centres

    def group_all(cf):
        gx_ = x2[:, None].clone()  # [32, 1, 128, 3], its own copy
        gf_ = torch.relu(randn(B, 1, 128, cf))
        for t in (gx_, gf_):
            t[:, :, 1::8] = t[:, :, 0::8]
            t[:, :, SPLIT_TIES] = t[:, :, :1]
        return gx_, gf_, random_mlp(torch, gen, cf, (256, 512, 1024))

    if victim == "SSG":
        f1 = randn(B, 512, 128)
        _, gx2, gf2 = bk.ballquery_group_fwd(x1, x2, f1, 0.4, 64)
        return {
            "SSG SA1": (bk.ballquery_group_fwd(pc, x1, None, 0.2, 64)[1], None,
                        random_mlp(torch, gen, 0, (64, 64, 128))),
            "SSG SA2": (gx2, torch.relu(gf2),
                        random_mlp(torch, gen, 128, (128, 128, 256))),
            "SSG SA3": group_all(256),
        }
    if victim == "MSG":
        out = {f"MSG SA1 ns={ns_}": (bk.ballquery_group_fwd(pc, x1, None, r_, ns_)[1],
                                     None, random_mlp(torch, gen, 0, w_))
               for r_, ns_, w_ in ((0.1, 16, (32, 32, 64)), (0.2, 32, (64, 64, 128)),
                                   (0.4, 128, (64, 96, 128)))}
        out["MSG GroupAll cf=640"] = group_all(640)
        return out
    return {f"GroupAll cf={cf_} ("
            f"{'16-row tiles' if cf_ < 1838 else 'input in slices'})": group_all(cf_)
            for cf_ in WIDE_GROUPALL}


def group_mlp_oracle_check(torch, gk, label, gx_, gf_, p_, pooled, cnt) -> int:
    """group_mlp_fwd's pooled and cnt bit-equal to an exact oracle of its
    arithmetic on the first two clouds' groups: each layer one fmaf chain
    from 0, k ascending, x's 3 channels first (`fma_chain`), + bias in
    float32, the ReLU; then each group's maximum and its number of tied
    rows. Returns how many (group, channel)s hold a maximum tied across two
    of the blocks a split group's rows go to (0 where groups are not split)."""
    b2 = min(2, gx_.shape[0])
    _, m_, ns_, _ = gx_.shape
    x0 = gx_[:b2] if gf_ is None else torch.cat([gx_[:b2], gf_[:b2]], dim=-1)
    a = x0.reshape(b2 * m_ * ns_, -1)
    for w_, bias in ((p_.w1, p_.b1), (p_.w2, p_.b2), (p_.w3, p_.b3)):
        a = torch.relu(fma_chain(torch, a, w_) + bias)
    a3 = a.reshape(b2, m_, ns_, -1)
    want = a3.amax(dim=2)
    ties = a3 == want[:, :, None]
    require_equal(torch, f"group_mlp_fwd[{label}]", pooled[:b2], want,
                  "pooled vs the fmaf-chain oracle")
    require_equal(torch, f"group_mlp_fwd[{label}]", cnt[:b2],
                  ties.sum(dim=2, dtype=torch.int32), "cnt vs the fmaf-chain oracle")
    cf = 0 if gf_ is None else gf_.shape[-1]
    rows, parts = gk.fwd_plan(ns_, cf, (p_.w1.shape[1], p_.w2.shape[1], p_.w3.shape[1]))
    across = 0
    if parts > 1:
        part = torch.arange(ns_, device=ties.device) // rows  # a row's block
        hit = torch.stack([ties[:, :, part == q].any(dim=2) for q in range(parts)])
        across = int((hit.sum(dim=0) > 1).sum())
    print(f"  group_mlp_fwd[{label}]: pooled, cnt bit-equal to the fmaf-chain "
          f"oracle on {b2} clouds (required; {rows}-row tiles, {parts} block(s) "
          f"a group; {across} (group, channel)s tied across two blocks)")
    return across


def group_mlp_case(torch, label, gx_, gf_, p_, randn) -> dict:
    """The grouped-MLP kernels against their plain version at one shape:
    the forward against the float32 plain version and bit-equal to the
    exact oracle of its fmaf chains, the backward against float64 autograd
    over every row (see the comment below), and the times. Returns the row
    of numbers the kernels line takes."""
    from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk

    b_, m_, ns_, _ = gx_.shape
    pooled, cnt = gk.group_mlp_fwd(gx_, gf_, p_)
    want = gk.group_mlp_maxpool_plain(gx_, gf_, p_)
    scale = want.abs().max().item()
    # three layers of float32 products summed in another order than cuBLAS
    fwd_err = (pooled - want).abs().max().item()
    check(f"group_mlp_fwd[{label}]", fwd_err, 2e-5 * scale, "pooled")
    across = group_mlp_oracle_check(torch, gk, label, gx_, gf_, p_, pooled, cnt)
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
    # no atomics: a second call on the same inputs gives the same bits
    again = gk.group_mlp_bwd(gcot, gx_, gf_, p_, pooled, cnt)
    for g_, a_, what in zip(got, again, ("dgx", "dgf")):
        if g_ is not None:
            require_equal(torch, f"group_mlp_bwd[{label}]", a_, g_,
                          f"{what} of a second call")
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
    r_ = dict(fwd_err=fwd_err, bwd_err=max(bwd_errs), tied=tied, across=across,
              **group_mlp_times(torch, gk, gx_, gf_, p_, pooled, cnt,
                                randn(b_, m_, p_.w3.shape[1])))
    print(f"  group_mlp[{label}]: {tied} (group, channel)s with tied maxima; "
          + group_mlp_times_line(r_))
    return r_


def group_mlp_times(torch, gk, gx_, gf_, p_, pooled, cnt, g_all) -> dict:
    """The grouped-MLP kernels' times at one shape (CUDA events: one call,
    median of 20, and `ten_ms`), their plain versions' (the backward's:
    autograd through the plain forward, forward included) and both bounds
    for this run's inputs. The backward's operations are what its function
    needs on this data: the three layers' recompute over every row (it
    finds the rows that hold the maxima); dz3 @ w3t over dz3's nonzero
    entries only, c2 multiply-adds each (cnt of them for each (group,
    channel) whose maximum is above 0 and whose cotangent is not); d2 @ w2t
    and d1 @ w1t over the rows that carry a cotangent, read from the plain
    version's gradient (every other row's d2 and d1 are 0). ReLU zeros
    inside a row count as work, as in the forward's bound."""
    b_, m_, ns_, _ = gx_.shape
    c0, c1 = p_.w1.shape
    c2, c3 = p_.w3.shape
    flops = 2.0 * b_ * m_ * ns_ * (c0 * c1 + c1 * c2 + c2 * c3)
    xr = gx_.clone().requires_grad_(True)
    fr = gf_.clone().requires_grad_(True) if gf_ is not None else None
    ins = [xr] + ([fr] if fr is not None else [])

    def plain_bwd():
        return torch.autograd.grad(
            (gk.group_mlp_maxpool_plain(xr, fr, p_) * g_all).sum(), ins)

    carried = torch.stack([(d != 0).any(-1) for d in plain_bwd()]).any(0).sum().item()
    hits = (cnt * ((pooled > 0) & (g_all != 0))).sum().item()
    wbytes = nbytes(*p_[:6])
    fbytes = nbytes(gf_) if gf_ is not None else 0
    return dict(
        flops=flops, hits=hits, carried=carried,
        fwd_ms=time_ms(lambda: gk.group_mlp_fwd(gx_, gf_, p_)),
        fwd_ten=ten_ms(lambda: gk.group_mlp_fwd(gx_, gf_, p_)),
        fwd_plain=time_ms(lambda: gk.group_mlp_maxpool_plain(gx_, gf_, p_), iters=5),
        fwd_bound=bound_ms(nbytes(gx_, pooled, cnt) + wbytes + fbytes, flops),
        bwd_ms=time_ms(lambda: gk.group_mlp_bwd(g_all, gx_, gf_, p_, pooled, cnt)),
        bwd_ten=ten_ms(lambda: gk.group_mlp_bwd(g_all, gx_, gf_, p_, pooled, cnt)),
        bwd_plain=time_ms(plain_bwd, iters=5),
        bwd_plain_ten=ten_ms(plain_bwd, iters=5),
        bwd_bound=bound_ms(
            2 * nbytes(gx_) + nbytes(g_all, pooled, cnt) + 2 * wbytes + 2 * fbytes,
            flops + 2.0 * (hits * c2 + carried * (c2 * c1 + c1 * c0))),
    )


def group_mlp_times_line(r_: dict) -> str:
    fb, bb = r_["fwd_bound"][0], r_["bwd_bound"][0]
    return (f"fwd ms={r_['fwd_ms']:.4f} (ten back to back: {r_['fwd_ten']:.4f}) "
            f"plain={r_['fwd_plain']:.4f} bound={fb:.4f} share of the bound="
            f"{fb / r_['fwd_ms']:.3f} (ten: {fb / r_['fwd_ten']:.3f}); bwd ms="
            f"{r_['bwd_ms']:.4f} (ten back to back: {r_['bwd_ten']:.4f}) plain="
            f"{r_['bwd_plain']:.4f} (ten: {r_['bwd_plain_ten']:.4f}) bound={bb:.4f} "
            f"share of the bound={bb / r_['bwd_ms']:.3f} (ten: "
            f"{bb / r_['bwd_ten']:.3f}; {r_['hits']} nonzero dz3 entries, "
            f"{r_['carried']} rows carry a cotangent)")


def group_mlp_times_phase(torch) -> dict:
    """`--times 16`: the checkout's grouped-MLP kernels timed at the seven
    PointNet++ shapes (for this checkout, and not with `--tree`: the two
    wider GroupAll ones too, which older checkouts refuse) on
    `group_mlp_inputs`' inputs, as phase 2 times them, with no check run;
    then, where the checkout has them, the single-pass bf16 kernels at the
    seven shapes (`group_mlp_bf16_inputs`). With `--tree`, this checkout's
    bf16 kernels (its csrc/group_mlp_bf16.cu built alone) also run on the
    same inputs as the other checkout's: the elements of pooled / cnt whose
    bits differ between the two forwards are counted (`fwd_differ`), and
    those of dgx / dgf between this checkout's backward on this forward's
    outputs and the other's backward on its own (`differ`). Without
    `--tree`, the shapes on the streamed kernels also time their weight
    stream alone (the source built with GEOA3_GMLP_STREAM_ONLY) and print
    the weights they read a call (`wgmma_traffic_mb`)."""
    from geoa3_tpu_torch.ops.kernels import _build, group_mlp_kernel as gk

    print(f"grouped-MLP times of {gk.__file__}")
    wide = CODE == REPO
    names = ("geoa3_group_mlp_fwd_bf16", "geoa3_group_mlp_bwd_bf16")
    this = (None if wide else variant_entry(
        "group_mlp_bf16.cu", None, names, REPO / "geoa3_tpu_torch" / "csrc"))
    # this checkout's streamed kernels with their products left out: the
    # weight stream alone (not with `--tree`, whose wrapper passes other
    # arguments)
    stream = (variant_entry("group_mlp_bf16.cu", "GEOA3_GMLP_STREAM_ONLY", names)
              if wide else None)
    _build.lib()
    this = this and this()
    stream = stream and stream()
    gen = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for victim in ("SSG", "MSG") + (("wide",) if wide else ()):
        for label, (gx_, gf_, p_) in group_mlp_inputs(torch, victim).items():
            pooled, cnt = gk.group_mlp_fwd(gx_, gf_, p_)
            g_all = torch.randn(*pooled.shape, device="cuda", generator=gen)
            out[label] = group_mlp_times(torch, gk, gx_, gf_, p_, pooled, cnt, g_all)
            print(f"  group_mlp[{label}]: " + group_mlp_times_line(out[label]),
                  flush=True)
    if not hasattr(gk, "group_mlp_fwd_bf16"):
        return out
    for victim in ("SSG", "MSG"):  # the single-pass bf16 mode
        for label, (gx_, gf_, p_) in group_mlp_bf16_inputs(torch, victim).items():
            pooled, cnt = gk.group_mlp_fwd_bf16(gx_, gf_, p_)
            g_all = torch.randn(*pooled.shape, device="cuda", generator=gen)
            r_ = out[label + " bf16"] = group_mlp_bf16_times(torch, gk, gx_, gf_, p_,
                                                             pooled, cnt, g_all)
            if this:
                mine = this_fold(p_)
                r_["fwd_differ"], ours = fwd_bf16_differ(
                    torch, this["geoa3_group_mlp_fwd_bf16"], gx_, gf_, mine, pooled, cnt)
                r_["differ"] = bwd_bf16_differ(
                    torch, gk, this["geoa3_group_mlp_bwd_bf16"], g_all, gx_, gf_, p_, mine,
                    (pooled, cnt), ours)
            widths = (p_.w1.shape[1], p_.w2.shape[1], p_.w3.shape[1])
            cf = 0 if gf_ is None else gf_.shape[-1]
            if stream and gk.bf16_kernel(gx_.shape[2], cf, widths, False).endswith("wgmma"):
                r_["stream_fwd_ten"] = with_entry(
                    _build, names[0], stream[names[0]],
                    lambda: ten_ms(lambda: gk.group_mlp_fwd_bf16(gx_, gf_, p_)))
                r_["stream_bwd_ten"] = with_entry(
                    _build, names[1], stream[names[1]],
                    lambda: ten_ms(lambda: gk.group_mlp_bwd_bf16(g_all, gx_, gf_, p_,
                                                                  pooled, cnt)))
            print(f"  group_mlp_bf16[{label}] ({gk.bf16_kernel(gx_.shape[2], cf, widths, False)}"
                  f", {gk.bf16_kernel(gx_.shape[2], cf, widths, True)}): "
                  if hasattr(gk, "bf16_kernel") else f"  group_mlp_bf16[{label}]: ",
                  end="")
            if "stream_fwd_ten" in r_:
                r_["traffic_mb"] = wgmma_traffic_mb(
                    gk, gx_.shape[0] * gx_.shape[1], gx_.shape[2], cf, widths, r_["hits"])
            print(group_mlp_times_line(r_)
                  + (f"; weight stream alone (ten back to back): fwd "
                     f"{r_['stream_fwd_ten']:.4f} bwd {r_['stream_bwd_ten']:.4f}; weights "
                     f"read from L2 a call (MB, from the plan): fwd {r_['traffic_mb'][0]:.1f} "
                     f"bwd {r_['traffic_mb'][1]:.1f}" if "stream_fwd_ten" in r_ else "")
                  + (f"; pooled/cnt elements whose bits differ from this checkout's "
                     f"forward: {r_['fwd_differ']}; dgx/dgf elements whose bits differ "
                     f"from this checkout's backward on its forward's outputs: "
                     f"{r_['differ']}" if this else ""), flush=True)
    return out


def wgmma_traffic_mb(gk, groups: int, ns: int, cf: int, widths, hits: int = 0,
                     sms: int = 132) -> tuple[float, float]:
    """The megabytes of packed weights the bf16 streamed kernels read from L2
    a call (forward, backward) at a shape, from their plans: every block
    copies its passes' slabs (the forward's split blocks share a tile's
    layer 3), and the backward reads W3^T's row (c2 bf16) once a dz3 hit
    and block column half; no measurement."""
    def slabs(passes):
        return sum(-(-ps.k // ps.ks) * ps.ks * ps.nb * 2 for ps in passes)

    pf, _ = gk.bf16_wgmma_passes(cf, widths, False)
    l12 = [ps for ps in pf if ps.src != "kw3"]
    l3 = [ps for ps in pf if ps.src == "kw3"]
    blocks = gk.bf16_wgmma_grid(groups, ns, cf, widths, False, sms)
    tiles = gk.bf16_wgmma_grid(groups, ns, cf, widths, True, sms)
    fwd = blocks * slabs(l12) + tiles * slabs(l3)
    bwd_p = gk.bf16_wgmma_passes(cf, widths, True)
    bwd = (tiles * (slabs(bwd_p[0]) + slabs(bwd_p[1])) + hits * widths[1] * 2
           if bwd_p else 0)
    return fwd / 1e6, bwd / 1e6


def with_entry(_build, name, fn, run):
    """run() with the package's C entry `name` bound to `fn` (another
    build's), restored after."""
    entry, _build._entries[name] = _build._entries[name], fn
    try:
        return run()
    finally:
        _build._entries[name] = entry


_THIS = {}


def this_module(name: str):
    """This checkout's `geoa3_tpu_torch/ops/kernels/<name>.py`, loaded from
    beside this script: under `--tree` the package that runs is another
    checkout's, whose modules may not match this checkout's C entries."""
    import importlib.util

    if name not in _THIS:
        spec = importlib.util.spec_from_file_location(
            f"geoa3_tpu_torch.ops.kernels._this_{name}",
            REPO / "geoa3_tpu_torch" / "ops" / "kernels" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _THIS[name] = mod
    return _THIS[name]


def this_fold(p_):
    """This checkout's `fold_mlp_bf16` of a folded MLP's bf16 weights
    (p_[:6]), with the packed weights this checkout's C entries read."""
    return this_module("group_mlp_kernel").fold_mlp_bf16(*p_[:6])


def _call_entry(torch, fn, name, *args) -> None:
    """Another build's C entry `fn` on the current stream (tensors by their
    pointers), synchronised; fails on its error code."""
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
             torch.cuda.current_stream().cuda_stream)
    if err:
        _fail(f"this checkout's {name} failed with error {err}")
    torch.cuda.synchronize()


def fwd_bf16_differ(torch, fn, gx_, gf_, p_, pooled, cnt):
    """The elements of pooled and cnt whose bits differ between the running
    checkout's bf16 forward (pooled, cnt) and `fn` (this checkout's C entry
    geoa3_group_mlp_fwd_bf16, built alone; p_ this checkout's fold) on the
    same inputs, and fn's (pooled, cnt), which start as NaN and -1. fn's
    scratch has room for a split group at any tile height."""
    got = torch.full_like(pooled, math.nan), torch.full_like(cnt, -1)
    b_, m_, ns_, _ = gx_.shape
    c3 = p_.w3.shape[1]
    scratch = torch.empty(2 * b_ * m_ * -(-ns_ // 16) * c3, dtype=torch.int32,
                          device="cuda")
    _call_entry(torch, fn, "geoa3_group_mlp_fwd_bf16", gx_, gf_, p_.kw1, p_.kb1, p_.kw2,
                p_.kb2, p_.kw3, p_.kb3, p_.kpf, b_ * m_, ns_,
                0 if gf_ is None else gf_.shape[-1], p_.w1.shape[1], p_.w2.shape[1], c3,
                got[0], got[1], scratch)
    return (int((got[0].view(torch.int32) != pooled.view(torch.int32)).sum())
            + int((got[1] != cnt).sum())), got


def bwd_bf16_differ(torch, gk, fn, g_all, gx_, gf_, p_, mine, theirs, ours) -> int:
    """The elements of dgx and dgf whose bits differ between the running
    checkout's bf16 backward (its fold p_) on its forward's (pooled, cnt)
    `theirs` and `fn` (this checkout's C entry geoa3_group_mlp_bwd_bf16,
    built alone; `mine` this checkout's fold) on `ours`; fn's outputs start
    as NaN."""
    want = [t for t in gk.group_mlp_bwd_bf16(g_all, gx_, gf_, p_, *theirs)
            if t is not None]
    got = [torch.full_like(t, math.nan) for t in want]
    b_, m_, ns_, _ = gx_.shape
    q = mine
    _call_entry(torch, fn, "geoa3_group_mlp_bwd_bf16", gx_, gf_, q.kw1, q.kb1, q.kw2,
                q.kb2, q.kw3, q.kb3, q.kw1t, q.kw2t, q.kw3t, q.kpf, q.kpb, *ours, g_all,
                b_ * m_, ns_, 0 if gf_ is None else gf_.shape[-1], q.w1.shape[1],
                q.w2.shape[1], q.w3.shape[1], got[0], got[1] if len(got) > 1 else None)
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
               for g, w in zip(got, want))


# ------------------------------------------- row 16 in the single-pass bf16 mode


def group_mlp_bf16_inputs(torch, victim: str) -> dict:
    """`group_mlp_inputs` as the bf16 victims' grouped MLPs take them: gx and
    gf rounded to bf16 and the folded MLP to bf16 (`fold_mlp_bf16`, which
    pads it for the kernels). Under-full balls and GroupAll's repeated rows
    keep their exact ties; GroupAll's rows at `SPLIT_TIES` tie across the
    tiles a cloud is split over."""
    from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk

    return {label: (gx_.to(torch.bfloat16).contiguous(),
                    None if gf_ is None else gf_.to(torch.bfloat16).contiguous(),
                    gk.fold_mlp_bf16(*p_[:6]))
            for label, (gx_, gf_, p_) in group_mlp_inputs(torch, victim).items()}


def group_mlp_bf16_hold(torch, gk, label, gx_, gf_, p_, randn) -> dict:
    """group_mlp_fwd_bf16 and group_mlp_bwd_bf16 against their plain
    versions at one shape. The tensor cores sum the same exact bf16 products
    in another order than cuBLAS, so a bf16 rounding of a1 or a2 may fall
    the other way: pooled within 2^-8 of max |pooled| (one bf16 step at the
    largest maximum); the tie counts equal to the plain version's on the
    (group, channel)s whose maximum stands clear of 0 and of every other
    row's value by 2^-8 of max |pooled|, or ties it exactly with rows of
    the same inputs (repeated rows give identical z in both; distinct rows
    whose bf16 activations coincide in one order of the sums need not in
    another); for a pooled cotangent kept on those (group,
    channel)s, dgx and dgf at a relative L2 distance of at most 2^-7, with
    at least 99% of their rows within 2^-7 of the largest entry: where the
    other order moves a hidden pre-activation across 0, a ReLU switches
    and the row's cotangent moves by a whole term (a1 and a2 that round to
    the next bf16 value move only the forward's sums)."""
    pooled, cnt = gk.group_mlp_fwd_bf16(gx_, gf_, p_)
    z1, z2, z3 = gk.mlp_bf16_plain(gx_, gf_, p_)
    a3 = torch.relu(z3)
    del z3
    want = a3.amax(dim=2)
    scale = want.abs().max().item()
    fwd_err = (pooled - want).abs().max().item()
    check(f"group_mlp_fwd_bf16[{label}]", fwd_err, 2.0 ** -8 * scale, "pooled")
    tied = a3 == want[:, :, None]
    cnt_p = tied.sum(dim=2, dtype=torch.int32)
    runner_up = torch.where(tied, -1.0, a3).amax(dim=2)
    held = ((want - runner_up) > 2.0 ** -8 * scale) & (want > 2.0 ** -8 * scale)
    # a tie held only where the tied rows have the same inputs (an exact
    # repeat ties in any order of the sums; distinct rows whose bf16
    # activations happen to coincide need not): a random float64 key a row
    key = gx_.double() @ randn(3).double()
    if gf_ is not None:
        key = key + gf_.double() @ randn(gf_.shape[-1]).double()
    key = key[..., None]
    repeats = (torch.where(tied, key, -torch.inf).amax(dim=2)
               == torch.where(tied, key, torch.inf).amin(dim=2))
    coincident = int((held & ~repeats).sum())
    held &= repeats
    del key, repeats
    require_equal(torch, f"group_mlp_fwd_bf16[{label}]", cnt[held], cnt_p[held],
                  "cnt where the maximum stands clear")
    _, _, ns_, _ = gx_.shape
    cf = 0 if gf_ is None else gf_.shape[-1]
    rows, parts = gk.bf16_plan(ns_, cf, (p_.w1.shape[1], p_.w2.shape[1],
                                         p_.w3.shape[1]), False)[:2]
    across = 0
    if parts > 1:
        part = torch.arange(ns_, device=tied.device) // rows  # a row's tile
        hit = torch.stack([tied[:, :, part == q].any(dim=2) for q in range(parts)])
        across = int(((hit.sum(dim=0) > 1) & held).sum())
    del a3, tied, runner_up, z1, z2
    g = (randn(*pooled.shape) * held).to(torch.bfloat16).float().contiguous()
    got = gk.group_mlp_bwd_bf16(g, gx_, gf_, p_, pooled, cnt)
    wants = gk.group_mlp_bwd_bf16_plain(g, gx_, gf_, p_, want, cnt_p)
    bwd_errs, moved = [], []
    for g_, w_, what in zip(got, wants, ("dgx", "dgf")):
        if w_ is None:
            continue
        top = w_.abs().max().item()
        rel = ((g_ - w_).norm() / w_.norm()).item()
        check(f"group_mlp_bwd_bf16[{label}]", rel, 2.0 ** -7,
              f"{what} relative L2 distance")
        row_err = (g_ - w_).abs().amax(dim=-1)
        moved.append(int((row_err > 2.0 ** -7 * top).sum()))
        if moved[-1] > 0.01 * row_err.numel():
            _fail(f"group_mlp_bwd_bf16[{label}]: {moved[-1]} of {row_err.numel()} "
                  f"rows of {what} are more than 2^-7 of its largest entry off")
        bwd_errs.append(row_err.max().item())
    print(f"  group_mlp_bf16[{label}]: pooled err / max {fwd_err / scale:.3e}, "
          f"{int((pooled == want).sum())}/{want.numel()} maxima bit-equal to "
          f"plain; cnt equal on {int(held.sum())}/{held.numel()} clear maxima "
          f"({coincident} more tie distinct rows: not held) "
          f"({int((cnt_p[held] > 1).sum())} tied, {across} tied across the "
          f"{parts} tile(s) a group; {rows}-row tiles); rows of dgx / dgf "
          f"more than 2^-7 of the largest entry off: {moved} of "
          f"{got[0].shape[:3].numel()}; largest row errors {bwd_errs}")
    return dict(fwd_err=fwd_err, bwd_err=max(bwd_errs), pooled=pooled, cnt=cnt,
                tied=int((cnt_p[held] > 1).sum()), across=across)


def group_mlp_bf16_times(torch, gk, gx_, gf_, p_, pooled, cnt, g_all) -> dict:
    """The bf16 kernels' times at one shape, as `group_mlp_times` takes the
    float32 ones (one call, ten back to back, the plain versions), and the
    bounds for this run's data at the tensor cores' bf16 rate: the forward's
    products over every row; the backward's recompute, dz3 @ w3t over dz3's
    nonzero entries and d2 @ w2t, d1 @ w1t over the rows that carry a
    cotangent; bytes: the bf16 inputs and weights read once, the outputs
    written once (dgx and dgf as float32)."""
    b_, m_, ns_, _ = gx_.shape
    c0, c1 = p_.w1.shape
    c2, c3 = p_.w3.shape
    flops = 2.0 * b_ * m_ * ns_ * (c0 * c1 + c1 * c2 + c2 * c3)
    dx, df = gk.group_mlp_bwd_bf16_plain(
        g_all, gx_, gf_, p_, *gk.group_mlp_fwd_bf16_plain(gx_, gf_, p_))
    carried = (dx != 0).any(-1)
    if df is not None:
        carried |= (df != 0).any(-1)
    carried = carried.sum().item()
    del dx, df
    hits = (cnt * ((pooled > 0) & (g_all != 0))).sum().item()
    wbytes = nbytes(p_.kw1, p_.kb1, p_.kw2, p_.kb2, p_.kw3, p_.kb3)
    fbytes = nbytes(gf_) if gf_ is not None else 0
    return dict(
        flops=flops, hits=hits, carried=carried,
        fwd_ms=time_ms(lambda: gk.group_mlp_fwd_bf16(gx_, gf_, p_)),
        fwd_ten=ten_ms(lambda: gk.group_mlp_fwd_bf16(gx_, gf_, p_)),
        fwd_plain=time_ms(lambda: gk.group_mlp_fwd_bf16_plain(gx_, gf_, p_), iters=5),
        fwd_bound=bound_ms(nbytes(gx_, pooled, cnt) + wbytes + fbytes, flops,
                           PEAK_BF16_FLOPS),
        bwd_ms=time_ms(lambda: gk.group_mlp_bwd_bf16(g_all, gx_, gf_, p_, pooled, cnt)),
        bwd_ten=ten_ms(lambda: gk.group_mlp_bwd_bf16(g_all, gx_, gf_, p_, pooled, cnt)),
        bwd_plain=time_ms(lambda: gk.group_mlp_bwd_bf16_plain(
            g_all, gx_, gf_, p_, pooled, cnt), iters=5),
        bwd_plain_ten=ten_ms(lambda: gk.group_mlp_bwd_bf16_plain(
            g_all, gx_, gf_, p_, pooled, cnt), iters=5),
        bwd_bound=bound_ms(
            3 * nbytes(gx_) + nbytes(g_all, pooled, cnt) + nbytes(
                p_.kw1t, p_.kw2t, p_.kw3t) + wbytes + 3 * fbytes,
            flops + 2.0 * (hits * c2 + carried * (c2 * c1 + c1 * c0)),
            PEAK_BF16_FLOPS),
    )


def group_mlp_bf16_checks(torch) -> list[dict]:
    """Phase 2's row 16 in the single-pass bf16 mode: both kernels held
    (`group_mlp_bf16_hold`) and timed at the SSG victim's three shapes and
    the MSG victim's SA1 scales and GroupAll (cf = 640), and at the first of
    the wider GroupAll shapes whose plans pick the staged kernels
    (gmlp_bf16_*_tiles: cf = 1536, past the streamed plan's whole input),
    GroupAll's clouds split over tiles with maxima tied across them."""
    from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk

    out = []
    entry = entry_into(out)
    gen = torch.Generator(device="cuda").manual_seed(23)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    def kinds(gx_, gf_, p_):
        widths = (p_.w1.shape[1], p_.w2.shape[1], p_.w3.shape[1])
        return [gk.bf16_kernel(gx_.shape[2], 0 if gf_ is None else gf_.shape[-1], widths,
                               bwd) for bwd in (False, True)]

    shapes = {**group_mlp_bf16_inputs(torch, "SSG"), **group_mlp_bf16_inputs(torch, "MSG")}
    staged = [(label, v) for label, v in group_mlp_bf16_inputs(torch, "wide").items()
              if all(k.endswith("_tiles") for k in kinds(*v))]
    if not staged:
        _fail("group_mlp_bf16: no wider GroupAll shape picks the staged kernels, "
              "which are left unheld")
    shapes.update(staged[:1])
    rows = {}
    for label, (gx_, gf_, p_) in shapes.items():
        r_ = group_mlp_bf16_hold(torch, gk, label, gx_, gf_, p_, randn)
        r_.update(group_mlp_bf16_times(torch, gk, gx_, gf_, p_, r_.pop("pooled"),
                                       r_.pop("cnt"), randn(*gx_.shape[:2], p_.w3.shape[1])))
        # the device kernels the C entries' plans pick
        r_["fwd_kernel"], r_["bwd_kernel"] = kinds(gx_, gf_, p_)
        rows[label] = r_
        print(f"  group_mlp_bf16[{label}] ({r_['fwd_kernel']}, {r_['bwd_kernel']}): "
              + group_mlp_times_line(r_), flush=True)
    for label in ("SSG SA3", "MSG GroupAll cf=640", staged[0][0]):
        if rows[label]["across"] == 0:
            _fail(f"group_mlp_fwd_bf16[{label}]: no maximum is tied across two "
                  "tiles, the split's merge is unchecked")
    if rows["SSG SA1"]["tied"] == 0:
        _fail("group_mlp_bf16: no tied maxima, the tie split is unchecked")
    r2_ = rows["SSG SA2"]

    def others(k1, k2):
        return "; ".join(
            f"{lab} ({r[k1[:3] + '_kernel']}): ms={r[k1]:.4f} ten={r[k1[:3] + '_ten']:.4f} "
            f"plain={r[k1[:3] + '_plain']:.4f} bound_ms={r[k2][0]:.4f}"
            for lab, r in rows.items() if lab != "SSG SA2")

    entry("group_mlp_fwd_bf16", "geoa3_tpu_torch/csrc/group_mlp_bf16.cu",
          "geoa3_tpu/ops/pallas/group_mlp_kernel.py:158",
          max(r["fwd_err"] for r in rows.values()), r2_["fwd_ms"],
          r2_["fwd_plain"], r2_["fwd_bound"], None,
          f"single-pass bf16 ({r2_['fwd_kernel']} where the weights fit beside a "
          "tile, else gmlp_bf16_fwd_wgmma, streamed, past that gmlp_bf16_fwd_tiles): "
          "SSG SA2 rows 32*128*64 x "
          f"(131->128->128->256) -> [32,128,256] (ten back to back: {r2_['fwd_ten']:.4f}); "
          + others("fwd_ms", "fwd_bound"))
    entry("group_mlp_bwd_bf16", "geoa3_tpu_torch/csrc/group_mlp_bf16.cu",
          "geoa3_tpu/ops/pallas/group_mlp_kernel.py:177",
          max(r["bwd_err"] for r in rows.values()), r2_["bwd_ms"],
          r2_["bwd_plain"], r2_["bwd_bound"], None,
          f"single-pass bf16 ({r2_['bwd_kernel']} where the weights fit beside a "
          "tile, else gmlp_bf16_bwd_wgmma, streamed, past that gmlp_bf16_bwd_tiles): "
          "SSG SA2 -> dgx [32,128,64,3], dgf [32,128,64,128] "
          f"float32 (ten back to back: {r2_['bwd_ten']:.4f}; max_abs_err: the "
          "largest row error, on a row where another order of the sums switched "
          "a ReLU; relative L2 within 2^-7); " + others("bwd_ms", "bwd_bound"))
    return out


def ssg_kernel_checks(torch) -> list[dict]:
    """Phase 2, second half: the PointNet++ kernels at the SSG victim's three
    set-abstraction shapes (b=32: 1024 -> 512 centres x 64 samples, 512 -> 128
    x 64 with 128 features, GroupAll of 128 points with 256 features)."""
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
    votes = torch.from_numpy(rng.randint(0, 2 * N, 3 * B).astype(np.int32)).cuda()
    limit, _, _ = make_batch(torch, 4, fk.MAX_N, seed=5)
    limit[:, ::7] *= 0.01  # skipped points, the coordinates in shared memory
    fps_idx = fk.fps(pc, 512)
    cases = {
        "SA1 1024->512, skip": (pc, 512, None, True, fps_idx),
        "512->128, skip": (pc[:, :512].contiguous(), 128, None, True, None),
        "uniform loss 1024->51": (pc, 51, None, True, None),
        "skipped points and a fully skipped cloud": (near, 512, None, True, None),
        "no skip": (near, 512, None, False, None),
        "subsample 2048->1024 from a start, no skip": (big, N, start, False, None),
        "ragged 1000->512, skip": (pc[:, :1000].contiguous(), 512, None, True, None),
        f"[4,{fk.MAX_N}] (the limit)->256, skip": (limit, 256, None, True, None),
        "m > n: 40->64, skipped points, skip": (near[:, :40].contiguous(), 64,
                                                None, True, None),
        "vote [96,2048]->1024 from starts, no skip": (big.repeat(3, 1, 1), N,
                                                      votes, False, None),
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
    dense = fps_inputs(torch)[f"dense [{DENSE_B},{DENSE_N}]->{N}"]
    sub_t, dense_t = (fps_time(torch, fk, big, N, start, False),
                      fps_time(torch, fk, *dense))
    entry("fps", "geoa3_tpu_torch/csrc/fps.cu",
          "geoa3_tpu/ops/pallas/fps_kernel.py:29", 0.0,
          time_ms(lambda: fk.fps(pc, 512)),
          time_ms(lambda: fk.fps_plain(pc, 512), iters=3, warm=1),
          bound_ms(nbytes(pc, fps_idx), 9.0 * B * N * 511), None,
          "[32,1024,3] -> [32,512]; sequential depth 511 rounds of a "
          "block-wide argmax on 32 of 132 SMs; ten back to back "
          f"{fps_time(torch, fk, pc, 512, None, True)['ms']:.4f}; subsample "
          f"[32,2048,3] -> [32,1024] ten back to back: ms={sub_t['ms']:.4f} "
          f"us_round={sub_t['us_round']:.4f} bound_ms={sub_t['bound_ms']:.4f}; "
          f"dense [{DENSE_B},{DENSE_N},3] -> [{DENSE_B},{N}] ten back to back: "
          f"ms={dense_t['ms']:.4f} us_round={dense_t['us_round']:.4f} "
          f"bound_ms={dense_t['bound_ms']:.4f}")

    # --- ball query + group, forward and backward --------------------------
    shapes = ballquery_inputs(torch, pc, fps_idx, f1=randn(B, 512, 128))
    c1, c2, f1 = shapes["SSG SA2 cf=128 r=0.4"][:3]
    far = c2.clone()
    far[:, ::2] += 100.0  # every other ball is empty
    past, _, _ = make_batch(torch, 4, BQ_PAST_N, seed=6)
    past_c = past[:, ::BQ_PAST_N // 256].contiguous()  # 256 centres
    bq_cases = {
        **{k: v[:5] for k, v in shapes.items() if not v[5]},
        "cf=3 (normals)": (pc, c1, nrm, 0.2, 64),
        "empty balls": (c1, far, f1, 0.4, 64),
        "over-full balls r=2": (c1, c2, None, 2.0, 64),
        "nsample 64 > n 48": (c1[:, :48].contiguous(), c2, None, 0.4, 64),
        "ragged n=1000 cf=128": (pc[:, :1000].contiguous(), c1,
                                 randn(B, 1000, 128), 0.2, 64),
        f"n={BQ_PAST_N} (past the shared-memory plan) cf=8":
            (past, past_c, randn(4, BQ_PAST_N, 8), 0.2, 64),
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
    index_only = {k: v for k, v in shapes.items() if v[5]}
    for label, (x_, c_, _, r_, ns_, _) in index_only.items():
        require_equal(torch, f"ball_query[{label}]", bk.ball_query(x_, c_, r_, ns_),
                      bk.ball_query_plain(x_, c_, r_, ns_), "idx")
    print("  ballquery_group_fwd: idx, gx, gf bit-equal to plain, with and "
          f"without the gathers (required) at {list(bq_cases)}; ball_query "
          f"at {list(index_only)}")

    idx2, gx2, gf2 = kept["SSG SA2 cf=128 r=0.4"]
    sa1 = ballquery_time(torch, bk, *shapes["SSG SA1 cf=0 r=0.2"])
    sa2 = ballquery_time(torch, bk, *shapes["SSG SA2 cf=128 r=0.4"])
    entry("ballquery_group_fwd", "geoa3_tpu_torch/csrc/ballquery_group.cu",
          "geoa3_tpu/ops/pallas/ballquery_group_kernel.py:177", 0.0,
          time_ms(lambda: bk.ballquery_group_fwd(c1, c2, f1, 0.4, 64)),
          time_ms(lambda: bk.ballquery_group_plain(c1, c2, f1, 0.4, 64)),
          (sa2["fwd_bound"], sa2["fwd_by"]), None,
          "SA2 xyz [32,512,3], centres [32,128,3], feats [32,512,128], ns=64 "
          "-> idx [32,128,64], gx [32,128,64,3], gf [32,128,64,128] (ten back "
          f"to back: {sa2['fwd_ten']:.4f}); SA1 [32,1024,3] x [32,512,3], "
          f"cf=0: ms={sa1['fwd_ms']:.4f} ten={sa1['fwd_ten']:.4f} "
          f"bound_ms={sa1['fwd_bound']:.4f}")

    bwd_err = 0.0
    # MSG SA1's ns=16 scale runs the backward's several centres a warp
    for label, n_ in (("SSG SA1 cf=0 r=0.2", N), ("SSG SA2 cf=128 r=0.4", 512),
                      ("MSG SA1 ns=16 r=0.1", N), ("MSG SA1 ns=32 r=0.2", N),
                      ("MSG SA1 ns=128 r=0.4", N), ("empty balls", 512),
                      ("cf=3 (normals)", N)):
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
    entry("ballquery_group_bwd", "geoa3_tpu_torch/csrc/ballquery_group.cu",
          "geoa3_tpu/ops/pallas/ballquery_group_kernel.py:224", bwd_err,
          time_ms(lambda: bk.ballquery_group_bwd(idx2, dgx2, dgf2, 512)),
          time_ms(lambda: bk.ballquery_group_bwd_plain(idx2, dgx2, dgf2, 512)),
          (sa2["bwd_bound"], sa2["bwd_by"]), None,
          "SA2 idx [32,128,64], dgx [32,128,64,3], dgf [32,128,64,128] -> "
          "dxyz [32,512,3], dcentre [32,128,3], dfeats [32,512,128] (ten back "
          f"to back: {sa2['bwd_ten']:.4f}); SA1 (cf=0): ms={sa1['bwd_ms']:.4f} "
          f"ten={sa1['bwd_ten']:.4f} bound_ms={sa1['bwd_bound']:.4f}")

    # --- C-channel scatter -------------------------------------------------
    sc_shapes = scatter_inputs(torch, pc)
    sa1_idx, sa2_idx = (sc_shapes[k][0] for k in SCATTER_BALLS)
    outside = sa2_idx.clone()
    outside[:, ::3, ::5] = 512  # n itself
    outside[:, 1::3, ::7] = -1
    outside[:, ::11] = outside[:, ::11, :1]  # repeats of the first index
    outside[:, ::13, :4] = 10**6  # a group whose first index is outside
    sc_cases = {
        **sc_shapes,
        "SSG SA2 ball idx, C=1": (sa2_idx, 512, 1),
        "SSG SA2 ball idx, C=5": (sa2_idx, 512, 5),
        "SSG SA2 ball idx, C=130 (rows not of float4s)": (sa2_idx, 512, 130),
        "flat S=1000, not a multiple of the group": (
            torch.randint(0, 300, (B, 1000), device="cuda", generator=gen,
                          dtype=torch.int32), 300, 128),
        "empty balls (every other ball into point 0)": (kept["empty balls"][0], 512, 128),
        "every slot into point 0": (torch.zeros_like(sa2_idx), 512, 128),
        "out-of-range indices (dropped)": (outside, 512, 128),
    }
    sc_err = 0.0
    for label, (i_, n_, c_) in sc_cases.items():
        flat_ = i_.reshape(B, -1).contiguous()
        ct_ = randn(B, flat_.shape[1], c_)
        # a gather's last dimension, or 64 for the flat call (short last group)
        g_ = sk.scatter_add_nc(flat_, ct_, n_, i_.shape[-1] if i_.dim() > 2 else 64)
        w_ = sk.scatter_add_nc_plain(flat_, ct_, n_)
        # float32 sums of the rows that collide (tens to hundreds: ball
        # neighbourhoods overlap; 8192 where every slot is point 0), in
        # atomic order
        err = (g_ - w_).abs().max().item()
        check(f"scatter_add_nc[{label}]", err, 2e-5 * w_.abs().max().item(), "out")
        sc_err = max(sc_err, err)
    gen13 = torch.Generator(device="cuda").manual_seed(13)
    t1, t2 = (scatter_time(torch, sk, *sc_shapes[k], gen13) for k in SCATTER_BALLS)
    msg_t = {k: scatter_time(torch, sk, *sc_shapes[k], gen13) for k in MSG_SA2_BALLS}
    msg_line = "; ".join(
        f"{k}: ms={t['ms']:.4f} ten={t['ten']:.4f} plain={t['plain']:.4f} "
        f"scatter_={t['scatter_']:.4f} index_add_={t['index_add_']:.4f} "
        f"bound_ms={t['bound']:.4f} ({t['by']})" for k, t in msg_t.items())
    entry("scatter_add_nc", "geoa3_tpu_torch/csrc/scatter.cu",
          "geoa3_tpu/ops/pallas/scatter_kernel.py:94", sc_err, t1["ms"],
          t1["plain"], (t1["bound"], t1["by"]), t1["index_add_"],
          "SSG SA1 ball idx [32,512,64] -> [32,1024,128], group 64 (ten back "
          f"to back: {t1['ten']:.4f}; scatter_add_: {t1['scatter_']:.4f}; "
          "library: index_add_ on the flattened batch); SSG SA2 [32,128,64] "
          f"-> 512: ms={t2['ms']:.4f} ten={t2['ten']:.4f} "
          f"plain={t2['plain']:.4f} index_add_={t2['index_add_']:.4f} "
          f"bound_ms={t2['bound']:.4f}; the training path's {msg_line}")

    # --- grouped MLP + max-pool, forward and backward ----------------------
    shapes = group_mlp_inputs(torch, "SSG")
    rows = {label: group_mlp_case(torch, label, gx_, gf_, p_, randn)
            for label, (gx_, gf_, p_) in shapes.items()}
    if rows["SSG SA3"]["tied"] == 0 or rows["SSG SA1"]["tied"] == 0:
        _fail("group_mlp: the inputs held no tied maxima, the tie split is unchecked")
    if rows["SSG SA3"]["across"] == 0:
        _fail("group_mlp_fwd[SSG SA3]: no maximum is tied across two blocks, the "
              "split's merge is unchecked")
    r2_ = rows["SSG SA2"]
    others = lambda k1, k2: "; ".join(  # noqa: E731
        f"{lab}: ms={rows[lab][k1]:.4f} bound_ms={rows[lab][k2][0]:.4f} "
        f"ten={rows[lab][k1[:3] + '_ten']:.4f}"
        for lab in ("SSG SA1", "SSG SA3"))
    entry("group_mlp_fwd", "geoa3_tpu_torch/csrc/group_mlp.cu",
          "geoa3_tpu/ops/pallas/group_mlp_kernel.py:158",
          max(r["fwd_err"] for r in rows.values()), r2_["fwd_ms"],
          r2_["fwd_plain"], r2_["fwd_bound"], None,
          "SA2 rows 32*128*64 x (131->128->128->256) -> [32,128,256] (ten "
          f"back to back: {r2_['fwd_ten']:.4f}); SA1 rows 32*512*64 x "
          "(3->64->64->128), SA3 rows 32*1*128 x (259->256->512->1024), each "
          "cloud split over 4 blocks and a finishing kernel: "
          f"{others('fwd_ms', 'fwd_bound')}")
    entry("group_mlp_bwd", "geoa3_tpu_torch/csrc/group_mlp.cu",
          "geoa3_tpu/ops/pallas/group_mlp_kernel.py:177",
          max(r["bwd_err"] for r in rows.values()), r2_["bwd_ms"],
          r2_["bwd_plain"], r2_["bwd_bound"], None,
          f"SA2 -> dgx [32,128,64,3], dgf [32,128,64,128] (ten back to back: "
          f"{r2_['bwd_ten']:.4f}; plain: autograd "
          "through the plain forward, forward included; max_abs_err against "
          "float64 autograd over every row, with the float32 ReLU pattern on "
          "the rows that hold a pre-activation within rounding of 0); "
          f"{others('bwd_ms', 'bwd_bound')}")
    return out


def sa_fused_recompute(torch, p_, idx, proj, yc):
    """Row 17's activations as its kernels compute them from the forward's
    idx, P and Yc: a1 = relu((P[idx] - Yc) + b1), then each layer one fmaf
    chain from 0, k ascending (`fma_chain`), + bias, the ReLU."""
    from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs

    a1 = torch.relu((gather_nbrs(proj, idx) - yc[:, :, None]) + p_.b1)
    a2 = torch.relu(fma_chain(torch, a1.reshape(-1, a1.shape[-1]), p_.w2) + p_.b2)
    a3 = torch.relu(fma_chain(torch, a2, p_.w3) + p_.b3)
    return a1, a2.reshape(*a1.shape[:-1], -1), a3.reshape(*a1.shape[:-1], -1)


def sa_fused_pattern_hold(torch, sf, label, p_, cf, pooled, cnt, idx, proj,
                          yc, g) -> float:
    """sa_fused_bwd against the backward taken in float64 through the
    kernel's own float32 ReLU patterns and tie sets (what
    tests/cuda_emu/sa_fused_bwd.cpp holds on the CPU): dz3 = g / cnt on the
    rows whose recomputed a3 equals pooled > 0, back through w3 and w2 with
    the masks a2 > 0 and a1 > 0, into P and Yc, projected back by w1. Every
    output within 2e-5 of its largest entry; returns the largest error."""
    from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk
    from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs

    a1, a2, a3 = sa_fused_recompute(torch, p_, idx, proj, yc)
    p64 = gk.FoldedMLP(*(t.double() for t in p_))
    P64 = proj.double().requires_grad_(True)
    Y64 = yc.double().requires_grad_(True)
    z1 = ((gather_nbrs(P64, idx) - Y64[:, :, None]) + p64.b1) * (a1 > 0)
    z2 = (z1 @ p64.w2 + p64.b2) * (a2 > 0)
    hit = (a3 == pooled[:, :, None]) & (pooled[:, :, None] > 0)
    dz3 = hit * (g.double() / cnt.clamp(min=1))[:, :, None]
    gP, gY = torch.autograd.grad(((z2 @ p64.w3) * dz3).sum(), [P64, Y64])
    del a1, a2, a3, z1, z2, hit, dz3
    wants = (gP @ p64.w1[:3].t(), gY @ p64.w1[:3].t(),
             gP @ p64.w1[3:].t() if cf else None)
    errs = []
    for g_, w_, what in zip(sf.sa_fused_bwd(g, p_, cf, pooled, cnt, idx, proj, yc),
                            wants, ("dxyz", "dnew_xyz", "dfeats")):
        if w_ is None:
            continue
        err = (g_.double() - w_).abs().max().item()
        # float32 products in another order, and the scatter's atomics
        check(f"sa_fused_bwd[{label}]", err, 2e-5 * w_.abs().max().item(),
              f"{what} vs float64 through the kernel's patterns and ties")
        errs.append(err)
    return max(errs)


def sa_fused_autograd_hold(torch, sf, label, xyz, cen, feats, ns, p_, scale,
                           pooled, cnt, idx, proj, yc, randn) -> float:
    """sa_fused_bwd against float64 autograd over every row (see
    `sa_fused_case`); returns the largest error."""
    from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk
    from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs

    b_, m_ = cen.shape[:2]
    cf = 0 if feats is None else feats.shape[-1]
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
    # each maximum's gap to the largest value below it, not to the runner-up:
    # an exact tie of an under-full ball's repeated rows may hide a distinct
    # row within rounding of it, which float32 sums may rightly lift above
    with torch.no_grad():
        top = a3.amax(dim=2, keepdim=True)
        below = torch.where(a3 < top, a3, torch.full_like(a3, -1.0)).amax(dim=2)
        top = top[:, :, 0]
        gap_ok = (top - below > 1e-4 * scale) & (top > 1e-4 * scale)
        del top, below
    gcot = (randn(b_, m_, p_.w3.shape[1]) * gap_ok).contiguous()
    ins = [xg, cg] + ([fg] if fg is not None else [])
    grads = torch.autograd.grad((torch.amax(a3, dim=2) * gcot.double()).sum(), ins)
    del a3, z2, on1, on2
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
    return max(bwd_errs)


def sa_fused_case(torch, label, xyz, cen, feats, radius, ns, p_, randn,
                  timed=False, patterns=False) -> dict:
    """sa_fused_fwd/_bwd against the plain version at one shape: the ball
    query's indices bit-equal to `ball_query_plain`, pooled against the
    float32 plain version and, on the first two clouds, the projections P
    and Yc, then pooled and cnt, bit-equal to an exact oracle of the
    kernels' fmaf chains (the tie sets the backward's recompute finds
    again); the backward against float64
    autograd over every row as in `group_mlp_case` (the kernel's float32
    ReLU pattern on rows with a hidden pre-activation within rounding of 0,
    read from the kernel's own projections P and Yc; the pooled cotangent
    kept off maxima within rounding of a lower value or of 0), and, with
    `patterns`, by `sa_fused_pattern_hold` too. With `timed`, the times of
    `sa_fused_times`."""
    from geoa3_tpu_torch.ops.kernels import (
        ballquery_group_kernel as bk,
        sa_fused_kernel as sf,
    )

    b_ = xyz.shape[0]
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
    b2 = min(2, b_)
    c1 = p_.w1.shape[1]
    want_p = fma_chain(torch, xyz[:b2].reshape(-1, 3), p_.w1[:3])
    if cf:  # the feats chain, added last
        want_p = want_p + fma_chain(torch, feats[:b2].reshape(-1, cf), p_.w1[3:])
    require_equal(torch, f"sa_fused_fwd[{label}]", proj[:b2].reshape(-1, c1), want_p,
                  "P vs the fmaf-chain oracle")
    require_equal(torch, f"sa_fused_fwd[{label}]", yc[:b2].reshape(-1, c1),
                  fma_chain(torch, cen[:b2].reshape(-1, 3), p_.w1[:3]),
                  "Yc vs the fmaf-chain oracle")
    del want_p
    a3 = sa_fused_recompute(torch, p_, idx[:b2], proj[:b2], yc[:b2])[2]
    top = a3.amax(dim=2)
    require_equal(torch, f"sa_fused_fwd[{label}]", pooled[:b2], top,
                  "pooled vs the fmaf-chain oracle")
    require_equal(torch, f"sa_fused_fwd[{label}]", cnt[:b2],
                  (a3 == top[:, :, None]).sum(dim=2, dtype=torch.int32),
                  "cnt vs the fmaf-chain oracle")
    del a3, top
    bwd_err = sa_fused_autograd_hold(torch, sf, label, xyz, cen, feats, ns, p_,
                                     scale, pooled, cnt, idx, proj, yc, randn)
    if patterns:
        bwd_err = max(bwd_err, sa_fused_pattern_hold(
            torch, sf, label, p_, cf, pooled, cnt, idx, proj, yc,
            randn(*pooled.shape)))
    r_ = dict(fwd_err=fwd_err, bwd_err=bwd_err, idx=idx)
    if not timed:
        return r_
    r_.update(sa_fused_times(torch, sf, xyz, cen, feats, radius, ns, p_,
                             randn(b_, m_, p_.w3.shape[1])))
    print(f"  sa_fused[{label}]: " + sa_fused_times_line(r_))
    return r_


def sa_fused_inputs(torch) -> dict:
    """Row 17's inputs, label -> (xyz, centres, feats, radius, nsample,
    folded MLP), at b=32 from seeds, centres by the checkout's own FPS: the
    MSG victim's SA2 at its three scales (512 -> 128 centres, 320
    features) and its SA1 with normals (1024 -> 512 centres, cf = 3)."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.ops.kernels import fps_kernel as fk

    pc, nrm, _ = make_batch(torch, B, N, seed=11)
    gen = torch.Generator(device="cuda").manual_seed(13)
    x1 = ops.gather_points(pc, fk.fps(pc, 512))  # SA1's centres
    x2 = ops.gather_points(x1, fk.fps(x1, 128))  # SA2's centres
    f1 = torch.relu(torch.randn(B, 512, 320, device="cuda", generator=gen))
    out = {}
    for r_, ns_, w_ in ((0.2, 32, (64, 64, 128)), (0.4, 64, (128, 128, 256)),
                        (0.8, 128, (128, 128, 256))):
        out[f"SA2 r={r_} ns={ns_}"] = (x1, x2, f1, r_, ns_,
                                       random_mlp(torch, gen, 320, w_))
    for r_, ns_, w_ in ((0.1, 16, (32, 32, 64)), (0.2, 32, (64, 64, 128)),
                        (0.4, 128, (64, 96, 128))):
        out[f"SA1 normals r={r_} ns={ns_}"] = (pc, x1, nrm, r_, ns_,
                                               random_mlp(torch, gen, 3, w_))
    return out


def kernel_ms(torch, fn, calls: int = 10) -> dict:
    """The device time of each kernel `fn` launches, ms a call: `calls` calls
    under torch.profiler after a warm one, summed by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            out[evt.key] = out.get(evt.key, 0.0) + us / 1e3 / calls
    return out


def kernels_matching(by_kernel: dict, pattern: str) -> float:
    return sum(ms for name, ms in by_kernel.items() if re.search(pattern, name))


def sa_fused_times(torch, sf, xyz, cen, feats, radius, ns, p_, g_all,
                   variant=None) -> dict:
    """Row 17's times at one shape (CUDA events: one call, median of 20, and
    `ten_ms`), its plain version's (the backward's: autograd through the
    plain forward, forward included) and both bounds for this run's inputs.
    The forward's device time by kernel (`kernel_ms`): the ball query pass,
    the tiles with their finish, the projections (in a checkout whose
    forward runs the queries inside its tiles, the query pass is 0). The
    split pair, the alternative route (row 15's fused ball query +
    grouping, then row 16's grouped MLP), forward and backward: one call,
    ten back to back, and its query + grouping kernel's device time.
    The backward's operations are what its function needs on this data: the
    recompute of layers 2-3 over every row (it finds the rows that hold the
    maxima); dz3 @ w3t over dz3's nonzero entries only, c2 multiply-adds
    each (cnt of them for each (ball, channel) whose maximum is above 0 and
    whose cotangent is not); d2 @ w2t over the rows that carry a cotangent
    (a nonzero layer-2 cotangent in the plain version's graph); one add a
    scattered entry of dz1 (c1 a carrying row); the back-projections of dP
    and dYc.
    The projections' own rows: the device time a call of the projection
    kernel (P and Yc) and of the back-projection kernel (dxyz, dfeats and
    dcentres) from the profiler, their bounds for this run's inputs (2 (b n
    (3 + cf) c1 + b m 3 c1) operations each way; the bytes of their inputs
    and outputs), their plain versions (the matrix products of
    `sa_query_group_mlp_plain`'s layer 1, and dP @ W1^T, dYc @ W1x^T) and
    `torch.matmul` of [b n, 3 + cf] (pre-concatenated) by W1 and of dP [b n,
    c1] by W1^T, the centres' rows left out (one call and ten back to back;
    float32, TF32 off).
    `variant`: another build's C entry of the backward (the epilogue-less
    one of `variant_entry`), timed ten back to back in its place."""
    from geoa3_tpu_torch.ops.kernels import (
        _build,
        ballquery_group_kernel as bk,
        group_mlp_kernel as gk,
    )
    from geoa3_tpu_torch.ops.kernels.knn_kernel import gather_nbrs

    b_, n_ = xyz.shape[:2]
    m_ = cen.shape[1]
    cf = 0 if feats is None else feats.shape[-1]
    c1, c2, c3 = p_.w1.shape[1], p_.w2.shape[1], p_.w3.shape[1]
    rows_ = b_ * m_ * ns
    pooled, cnt, idx, proj, yc = sf.sa_fused_fwd(xyz, cen, feats, radius, ns, p_)
    with torch.enable_grad():
        a1 = torch.relu((gather_nbrs(proj, idx) - yc[:, :, None]) + p_.b1)
        z2 = (a1 @ p_.w2 + p_.b2).requires_grad_(True)
        a3 = torch.relu(torch.relu(z2) @ p_.w3 + p_.b3)
        (dz2,) = torch.autograd.grad((torch.amax(a3, dim=2) * g_all).sum(), [z2])
    carried = (dz2 != 0).any(-1).sum().item()
    hits = (cnt * ((pooled > 0) & (g_all != 0))).sum().item()
    del a1, z2, a3, dz2
    proj_flops = 2.0 * (b_ * n_ * (3 + cf) * c1 + b_ * m_ * 3 * c1)
    mlp_flops = 2.0 * rows_ * (c1 * c2 + c2 * c3)
    wbytes = nbytes(*p_)
    fbytes = nbytes(feats) if feats is not None else 0
    xr = xyz.clone().requires_grad_(True)
    cr = cen.clone().requires_grad_(True)
    fr = feats.clone().requires_grad_(True) if feats is not None else None
    ins = [xr, cr] + ([fr] if fr is not None else [])

    def plain_bwd():
        return torch.autograd.grad(
            (sf.sa_query_group_mlp_plain(xr, cr, fr, radius, ns, p_) * g_all).sum(),
            ins)

    def bwd():
        return sf.sa_fused_bwd(g_all, p_, cf, pooled, cnt, idx, proj, yc)

    def fwd():
        return sf.sa_fused_fwd(xyz, cen, feats, radius, ns, p_)

    _, sgx, sgf = bk.ballquery_group_fwd(xyz, cen, feats, radius, ns)
    spooled, scnt = gk.group_mlp_fwd(sgx, sgf, p_)

    def split_fwd():
        i_, gx_, gf_ = bk.ballquery_group_fwd(xyz, cen, feats, radius, ns)
        return gk.group_mlp_fwd(gx_, gf_, p_)

    def split_bwd():
        dgx, dgf = gk.group_mlp_bwd(g_all, sgx, sgf, p_, spooled, scnt)
        return bk.ballquery_group_bwd(idx, dgx, dgf, n_)

    by_kernel = kernel_ms(torch, fwd)
    w1 = p_.w1
    xf = (torch.cat([xyz, feats], -1) if feats is not None else xyz).reshape(-1, 3 + cf)
    dp_, dy_ = proj.reshape(-1, c1), yc.reshape(-1, c1)  # dP's, dYc's shapes

    def plain_proj():
        out = xyz @ w1[:3]
        return (out + feats @ w1[3:] if feats is not None else out), cen @ w1[:3]

    def plain_bproj():
        return dp_ @ w1[:3].t(), dp_ @ w1[3:].t(), dy_ @ w1[:3].t()

    r_ = dict(
        proj_ms=kernels_matching(by_kernel, r"(?<!back)project_kernel"),
        proj_plain=time_ms(plain_proj),
        proj_lib=time_ms(lambda: torch.matmul(xf, w1)),
        proj_lib_ten=ten_ms(lambda: torch.matmul(xf, w1)),
        proj_bound=bound_ms(nbytes(xyz, cen, proj, yc, w1) + fbytes, proj_flops),
        bproj_ms=kernels_matching(kernel_ms(torch, bwd), r"backproject_kernel"),
        bproj_plain=time_ms(plain_bproj),
        bproj_lib=time_ms(lambda: torch.matmul(dp_, w1.t())),
        bproj_lib_ten=ten_ms(lambda: torch.matmul(dp_, w1.t())),
        bproj_bound=bound_ms(nbytes(proj, yc, p_.w1t) + 4 * (b_ * n_ * (3 + cf)
                                                            + b_ * m_ * 3), proj_flops),
        hits=hits, carried=carried,
        fwd_ms=time_ms(fwd),
        fwd_ten=ten_ms(fwd),
        fwd_query=kernels_matching(by_kernel, r"sa_query_kernel"),
        fwd_tiles=kernels_matching(by_kernel, r"sa_fwd_(tiles|finish|kernel)"),
        split_fwd=time_ms(split_fwd),
        split_ten=ten_ms(split_fwd),
        split_query=kernels_matching(kernel_ms(torch, split_fwd),
                                     r"ballquery_(kernel|fwd)"),
        split_bwd=time_ms(split_bwd),
        fwd_plain=time_ms(lambda: sf.sa_query_group_mlp_plain(
            xyz, cen, feats, radius, ns, p_), iters=5),
        fwd_bound=bound_ms(nbytes(xyz, cen, proj, yc, idx, pooled, cnt) + fbytes
                           + wbytes, proj_flops + mlp_flops),
        bwd_ms=time_ms(bwd),
        bwd_ten=ten_ms(bwd),
        bwd_plain=time_ms(plain_bwd, iters=5),
        bwd_plain_ten=ten_ms(plain_bwd, iters=5),
        bwd_bound=bound_ms(
            nbytes(proj, yc, idx, pooled, cnt, g_all, xyz, cen) + fbytes + wbytes,
            mlp_flops + 2.0 * (hits * c2 + carried * c2 * c1)
            + 2.0 * (b_ * n_ * c1 * (3 + cf) + b_ * m_ * c1 * 3) + carried * c1),
    )
    del sgx, sgf, spooled, scnt, xf
    if variant is not None:
        name = "geoa3_sa_fused_bwd"
        entry, _build._entries[name] = _build._entries[name], variant
        try:
            r_["bwd_ten_no_scatter"] = ten_ms(bwd)
        finally:
            _build._entries[name] = entry
    return r_


def sa_fused_times_line(r_: dict) -> str:
    fb, bb = r_["fwd_bound"][0], r_["bwd_bound"][0]
    line = (f"fwd ms={r_['fwd_ms']:.4f} (ten back to back: {r_['fwd_ten']:.4f}) "
            f"plain={r_['fwd_plain']:.4f} bound={fb:.4f} share of the bound="
            f"{fb / r_['fwd_ten']:.3f} (ten); bwd ms={r_['bwd_ms']:.4f} (ten back "
            f"to back: {r_['bwd_ten']:.4f}) plain={r_['bwd_plain']:.4f} (ten: "
            f"{r_['bwd_plain_ten']:.4f}) bound={bb:.4f} share of the bound="
            f"{bb / r_['bwd_ten']:.3f} (ten; {r_['hits']} nonzero dz3 entries, "
            f"{r_['carried']} rows carry a cotangent)")
    if "bwd_ten_no_scatter" in r_:
        ns_ = r_["bwd_ten_no_scatter"]
        line += (f"; without the scatter epilogue ten={ns_:.4f} (the epilogue: "
                 f"{(r_['bwd_ten'] - ns_) / r_['bwd_ten']:.3f} of the backward)")
    line += (f"; fwd by kernel (profiler, ms a call): query pass "
             f"{r_['fwd_query']:.4f}, tiles + finish {r_['fwd_tiles']:.4f}, "
             f"projections {r_['proj_ms']:.4f}; split pair fwd={r_['split_fwd']:.4f} "
             f"(ten back to back: {r_['split_ten']:.4f}; its query + grouping "
             f"{r_['split_query']:.4f}) bwd={r_['split_bwd']:.4f}; "
             + projection_line(r_))
    return line


def projection_line(r_: dict) -> str:
    """Row 17's projection and back-projection kernels at one shape."""
    return "; ".join(
        f"{what} kernel_ms={r_[k + '_ms']:.4f} bound={r_[k + '_bound'][0]:.4f} "
        f"({r_[k + '_bound'][1]}) plain={r_[k + '_plain']:.4f} torch.matmul "
        f"one call={r_[k + '_lib']:.4f} ten={r_[k + '_lib_ten']:.4f}"
        for what, k in (("projection", "proj"), ("back-projection", "bproj")))


def variant_entry(source: str, define, names: tuple, csrc: Path = None):
    """Starts building csrc/`source` alone with `define` set (a timing
    variant, never the package's; None: no define) into build/variants/
    (named by the sources' digest, so a built one is reused); returns a
    function that waits for the build and returns the variant's C entries
    `names` (name -> function), bound as _build binds the package's. The
    sources are the running package's, or those in `csrc` (this
    checkout's, beside another checkout's package under `--tree`: bound by
    this checkout's `_build.SIGNATURES`, whose entries may take other
    arguments)."""
    import ctypes
    import hashlib

    from geoa3_tpu_torch.ops.kernels import _build

    signatures = this_module("_build").SIGNATURES if csrc else _build.SIGNATURES
    csrc = csrc or _build.CSRC
    digest = hashlib.sha256(b"".join(
        p.name.encode() + p.read_bytes()
        for p in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")))).hexdigest()[:16]
    stem = Path(source).stem
    out = REPO / "build" / "variants" / f"{stem}_{define or 'plain'}_{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = None if out.exists() else subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *([f"-D{define}"] if define else []),
         "-I", str(csrc), "-shared", str(csrc / source), "-o", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        log, _ = proc.communicate(timeout=900) if proc else ("", None)
        if proc and proc.returncode != 0:
            _fail(f"the {define} variant of {source} did not build:\n{log}")
        so = ctypes.CDLL(str(out))
        fns = {}
        for name in names:
            fns[name] = getattr(so, name)
            fns[name].argtypes = signatures[name]
            fns[name].restype = ctypes.c_int
        return fns

    return wait


def sa_fused_times_phase(torch) -> dict:
    """`--times 17`: the checkout's row 17 kernels timed at MSG SA2's three
    scales and SA1 with normals (`sa_fused_inputs`), as phase 2 times them,
    with no check run; for this checkout (not with `--tree`, whose source
    may have no such variant) the backward built without its scatter
    epilogue too, built beside the kernels."""
    from geoa3_tpu_torch.ops.kernels import _build, sa_fused_kernel as sf

    print(f"row 17 times of {sf.__file__}")
    variant = (variant_entry("sa_fused.cu", "GEOA3_SA_BWD_NO_SCATTER",
                             ("geoa3_sa_fused_bwd",)) if CODE == REPO else None)
    _build.lib()
    variant = variant and variant()["geoa3_sa_fused_bwd"]
    gen = torch.Generator(device="cuda").manual_seed(31)
    out = {}
    for label, (x_, c_, f_, r_, ns_, p_) in sa_fused_inputs(torch).items():
        g_all = torch.randn(B, c_.shape[1], p_.w3.shape[1], device="cuda",
                            generator=gen)
        out[label] = sa_fused_times(torch, sf, x_, c_, f_, r_, ns_, p_, g_all,
                                    variant)
        print(f"  sa_fused[{label}]: " + sa_fused_times_line(out[label]), flush=True)
    return out


# row 13's two ball shapes, the first one phase 2's kernel entry
SCATTER_BALLS = ("SSG SA1 ball idx [32,512,64] -> 1024, C=128",
                 "SSG SA2 ball idx [32,128,64] -> 512, C=128")
# row 13 on the training path at MSG SA2 (label -> radius, nsample)
MSG_SA2_BALLS = {f"MSG SA2 ball idx [32,128,{ns}] -> 512, C=320": (r, ns)
                 for r, ns in ((0.2, 32), (0.4, 64), (0.8, 128))}


def scatter_inputs(torch, pc) -> dict:
    """Row 13's path shapes, label -> (idx [b, ..., g] int32, rows, C): the
    backward of `group_points` at SSG SA1's and SA2's ball indices (128
    channels), of `knn_gather` at the self-kNN's k = 17 (64 channels), of
    `three_interpolate` from 1024 points into SA1's 512 centres (128
    channels, PointNet++'s first feature propagation), and the training
    path's: the backward of MSG SA2's feature gathers at its three scales
    (320 channels, groups of 32, 64 and 128; SSG SA2's is the second)."""
    from geoa3_tpu_torch import ops

    c1 = ops.gather_points(pc, ops.furthest_point_sampling(pc, 512)).contiguous()
    c2 = ops.gather_points(c1, ops.furthest_point_sampling(c1, 128)).contiguous()
    sa1, sa2 = SCATTER_BALLS
    return {sa1: (ops.ball_query(0.2, 64, pc, c1), N, 128),
            sa2: (ops.ball_query(0.4, 64, c1, c2), 512, 128),
            f"knn_gather idx [32,1024,{K + 1}] -> 1024, C=64":
                (ops.knn_points(pc, pc, K + 1).idx, N, 64),
            "three_interpolate idx [32,1024,3] -> 512, C=128":
                (ops.three_nn(pc, c1)[1], 512, 128),
            **{label: (ops.ball_query(r, ns, c1, c2), 512, 320)
               for label, (r, ns) in MSG_SA2_BALLS.items()}}


def scatter_time(torch, sk, idx, n, c, gen) -> dict:
    """One row-13 shape: the kernel (grouped by idx's last dimension where
    the checkout's wrapper takes a group) one call (`time_ms`) and ten back
    to back (`ten_ms`); its plain version, `scatter_add_` and `index_add_`
    (on the flattened batch), one call each; and the bound: idx and the
    cotangents read once, the output written once, one add an entry."""
    import inspect

    b = idx.shape[0]
    flat = idx.reshape(b, -1).contiguous()
    ct = torch.randn(b, flat.shape[1], c, device="cuda", generator=gen)
    grouped = "group" in inspect.signature(sk.scatter_add_nc).parameters
    kw = {"group": idx.shape[-1]} if grouped else {}
    run = lambda: sk.scatter_add_nc(flat, ct, n, **kw)  # noqa: E731
    lidx = flat.long()
    sc_idx, sc_out = lidx[..., None].expand(-1, -1, c), torch.zeros(b, n, c, device="cuda")
    lib_idx = (lidx + n * torch.arange(b, device="cuda")[:, None]).reshape(-1)
    lib_ct, lib_out = ct.reshape(-1, c), torch.zeros(b * n, c, device="cuda")
    bound, by = bound_ms(nbytes(flat, ct, run()), 1.0 * ct.numel())
    return {"ms": time_ms(run), "ten": ten_ms(run),
            "plain": time_ms(lambda: sk.scatter_add_nc_plain(flat, ct, n)),
            "scatter_": time_ms(lambda: sc_out.scatter_add_(1, sc_idx, ct)),
            "index_add_": time_ms(lambda: lib_out.index_add_(0, lib_idx, lib_ct)),
            "bound": bound, "by": by}


def scatter_times_phase(torch) -> dict:
    """`--times 13`: the checkout's row 13 timed at its path shapes
    (`scatter_inputs`), with no check run."""
    from geoa3_tpu_torch.ops.kernels import _build, scatter_kernel as sk

    print(f"row 13 times of {sk.__file__}")
    _build.lib()
    pc, _, _ = make_batch(torch, B, N, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(13)
    out = {}
    for label, (idx, n, c) in scatter_inputs(torch, pc).items():
        out[label] = r_ = scatter_time(torch, sk, idx, n, c, gen)
        print(f"  {label}: ms={r_['ms']:.4f} ten={r_['ten']:.4f} "
              f"plain={r_['plain']:.4f} scatter_={r_['scatter_']:.4f} "
              f"index_add_={r_['index_add_']:.4f} bound={r_['bound']:.4f} "
              f"({r_['by']})", flush=True)
    return out


def ballquery_inputs(torch, pc, fps_idx, f1) -> dict:
    """Row 15's path shapes, label -> (xyz, centres, feats, radius, ns,
    index_only): PointNet++ SSG SA1 and SA2, MSG SA1's three scales (the
    fused query + grouping) and the uniform loss's five index-only queries
    at n = 1024 (51 seeds by FPS; ns = int(n * 4p), r = sqrt(4p) for
    p = 0.004 .. 0.012, `losses.uniform_loss`). `fps_idx` picks SA1's 512
    centres from `pc`; `f1` are SA2's 128 features."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.ops.kernels import fps_kernel as fk

    c1 = ops.gather_points(pc, fps_idx).contiguous()
    c2 = ops.gather_points(c1, fk.fps(c1, 128)).contiguous()
    seeds = ops.gather_points(pc, fk.fps(pc, int(N * 0.05))).contiguous()
    out = {"SSG SA1 cf=0 r=0.2": (pc, c1, None, 0.2, 64, False),
           "SSG SA2 cf=128 r=0.4": (c1, c2, f1, 0.4, 64, False)}
    for r_, ns_ in ((0.1, 16), (0.2, 32), (0.4, 128)):
        out[f"MSG SA1 ns={ns_} r={r_}"] = (pc, c1, None, r_, ns_, False)
    for p_ in (0.004, 0.006, 0.008, 0.010, 0.012):
        ns_ = int(N * 4 * p_)
        out[f"uniform loss ns={ns_}"] = (pc, seeds, None, math.sqrt(4 * p_), ns_, True)
    return out


def ballquery_time(torch, bk, x_, c_, f_, r_, ns_, index_only) -> dict:
    """One row-15 shape: the forward (index-only where `index_only`) and
    the backward, each one call (`time_ms`) and ten back to back
    (`ten_ms`), the plain versions' one-call times, and the bounds for the
    run's data. Forward: every input read and output written once; 10
    operations a distance test, a full ball's walk ending at its last
    slot's point, an under-full ball's reading the whole cloud. Backward:
    idx, dgx and dgf read once, dxyz, dcentre and dfeats written once, one
    add a scattered entry."""
    fwd = ((lambda: bk.ball_query(x_, c_, r_, ns_)) if index_only else
           (lambda: bk.ballquery_group_fwd(x_, c_, f_, r_, ns_)))
    plain = ((lambda: bk.ball_query_plain(x_, c_, r_, ns_)) if index_only else
             (lambda: bk.ballquery_group_plain(x_, c_, f_, r_, ns_)))
    got = fwd()
    idx_ = got if index_only else got[0]
    hits = (bk.pairwise_sqdist(c_, x_) < bk._r2(r_)).sum(-1)
    scanned = torch.where(hits >= ns_, idx_[..., -1].long() + 1,
                          torch.full_like(hits, x_.shape[1])).sum().item()
    outs = [idx_] if index_only else [t for t in got if t is not None]
    fb, fby = bound_ms(nbytes(x_, c_, *outs) + (nbytes(f_) if f_ is not None
                                                and not index_only else 0),
                       10.0 * scanned)
    r = {"fwd_ms": time_ms(fwd), "fwd_ten": ten_ms(fwd), "fwd_plain": time_ms(plain),
         "fwd_bound": fb, "fwd_by": fby}
    if index_only:
        return r
    gen = torch.Generator(device="cuda").manual_seed(11)
    dgx = torch.randn(*got[1].shape, device="cuda", generator=gen)
    dgf = (torch.randn(*got[2].shape, device="cuda", generator=gen)
           if got[2] is not None else None)
    n_ = x_.shape[1]
    bwd = lambda: bk.ballquery_group_bwd(idx_, dgx, dgf, n_)  # noqa: E731
    cf = 0 if dgf is None else dgf.shape[-1]
    bb, bby = bound_ms(nbytes(idx_, dgx, *[t for t in bwd() if t is not None])
                       + (nbytes(dgf) if cf else 0), (3.0 + cf) * idx_.numel())
    r.update(bwd_ms=time_ms(bwd), bwd_ten=ten_ms(bwd),
             bwd_plain=time_ms(lambda: bk.ballquery_group_bwd_plain(idx_, dgx, dgf, n_)),
             bwd_bound=bb, bwd_by=bby)
    return r


def ballquery_times_phase(torch) -> dict:
    """`--times 15`: the checkout's row 15 timed at its path shapes
    (`ballquery_inputs`), with no check run."""
    from geoa3_tpu_torch.ops.kernels import _build, ballquery_group_kernel as bk
    from geoa3_tpu_torch.ops.kernels import fps_kernel as fk

    print(f"row 15 times of {bk.__file__}")
    _build.lib()
    pc, _, _ = make_batch(torch, B, N, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(7)
    shapes = ballquery_inputs(torch, pc, fk.fps(pc, 512),
                              torch.randn(B, 512, 128, device="cuda", generator=gen))
    out = {}
    for label, args_ in shapes.items():
        out[label] = r_ = ballquery_time(torch, bk, *args_)
        line = (f"  {label}: fwd ms={r_['fwd_ms']:.4f} ten={r_['fwd_ten']:.4f} "
                f"plain={r_['fwd_plain']:.4f} bound={r_['fwd_bound']:.4f} "
                f"({r_['fwd_by']})")
        if "bwd_ms" in r_:
            line += (f"; bwd ms={r_['bwd_ms']:.4f} ten={r_['bwd_ten']:.4f} "
                     f"plain={r_['bwd_plain']:.4f} bound={r_['bwd_bound']:.4f} "
                     f"({r_['bwd_by']})")
        print(line, flush=True)
    return out


def kappa_inputs(torch) -> dict:
    """Rows 9, 8 and 4's path shapes, label -> (kernel, inputs): at the
    main path's [32,1024] (k = 16), row 9 and row 8 with both radii on a
    moved cloud and its stale mask (the public ops' and the partial-variable
    step's inputs), row 4 (the control) on the same inputs; row 8 with the
    direct radius also at the dense runs' [16,1024] (after FPS) and
    [16,10000] (the dense partial-variable step) and at the dense cloud
    [2,10000]. Masks by the checkout's own selection."""
    from geoa3_tpu_torch.ops.kernels import kappa_kernel as kk

    pc, nrm, rng = make_batch(torch, B, N, seed=8)
    adv = (pc + 0.01 * torch.from_numpy(
        rng.randn(B, N, 3).astype(np.float32)).cuda()).contiguous()
    mask = kk.kappa_selmask(pc, K)
    g = torch.from_numpy(rng.randn(B, N).astype(np.float32)).cuda()
    ref = torch.from_numpy(np.abs(rng.randn(B, N)).astype(np.float32)).cuda()
    out = {f"kappa_frommask [{B},{N}]": ("frommask", (adv, nrm, mask)),
           f"kappa_bwd direct [{B},{N}]": ("direct", (adv, nrm, mask, g)),
           f"kappa_bwd expansion [{B},{N}]": ("expansion", (adv, nrm, mask, g)),
           f"curv_term [{B},{N}] (control)": ("curv", (adv, nrm, ref, mask))}
    for b_, n_ in ((DENSE_B, N), (DENSE_B, DENSE_N), (2, DENSE_N)):
        pc_, nrm_, rng_ = make_batch(torch, b_, n_, seed=80 + b_)
        g_ = torch.from_numpy(rng_.randn(b_, n_).astype(np.float32)).cuda()
        out[f"kappa_bwd direct [{b_},{n_}]"] = (
            "direct", (pc_, nrm_, kk.kappa_selmask(pc_, K), g_))
    return out


def kappa_time(torch, kk, kind, args, stream_only=None) -> dict:
    """One shape of rows 9, 8 or 4: one call (`time_ms`), ten back to back
    (`ten_ms`), the plain version's one call, and the bound as phase 2
    counts it (inputs read and outputs written once; 30 operations a
    member pair for kappa, 60 with the gradient). `stream_only`: the C
    entries of kappa.cu built with GEOA3_KAPPA_STREAM_ONLY (rows 9 and 8
    stream the mask through the ring and do no row's work), timed ten back
    to back in place of the real ones (`stream_ten`): the stream's share."""
    b_, n_, _ = args[0].shape
    pairs = b_ * n_ * (K + 1)
    if kind == "frommask":
        fn, plain, ops_ = (lambda: kk.kappa_frommask(*args, K),
                           lambda: kk.kappa_from_mask_plain(*args, K), 30.0)
    elif kind == "curv":
        fn, plain, ops_ = (lambda: kk.curv_term(*args, K),
                           lambda: kk.curv_term_plain(*args, K), 60.0)
    else:
        fn, plain, ops_ = (lambda: kk.kappa_bwd(*args, K, kind),
                           lambda: kk.kappa_bwd_plain(*args, K, kind), 60.0)
    got = fn()
    bound = bound_ms(nbytes(*args, *(got if isinstance(got, tuple) else (got,))),
                     ops_ * pairs)
    r_ = {"ms": time_ms(fn), "ten": ten_ms(fn),
          "plain": time_ms(plain, iters=5, warm=1),
          "bound": bound[0], "by": bound[1]}
    name = {"frommask": "geoa3_kappa_frommask", "curv": None}.get(kind, "geoa3_kappa_bwd")
    if stream_only is not None and name is not None:
        from geoa3_tpu_torch.ops.kernels import _build

        r_["stream_ten"] = with_entry(_build, name, stream_only[name], lambda: ten_ms(fn))
    return r_


def kappa_times_phase(torch) -> dict:
    """`--times 8`: the checkout's rows 9 and 8 (and row 4, their control)
    timed at their path shapes (`kappa_inputs`), with no check run; for this
    checkout (not with `--tree`) rows 9 and 8 also with the stream alone
    (`kappa_time`'s `stream_only`), built beside the kernels."""
    from geoa3_tpu_torch.ops.kernels import _build, kappa_kernel as kk

    print(f"rows 9, 8 and 4 times of {kk.__file__}")
    variant = (variant_entry("kappa.cu", "GEOA3_KAPPA_STREAM_ONLY",
                             ("geoa3_kappa_frommask", "geoa3_kappa_bwd"))
               if CODE == REPO else None)
    _build.lib()
    variant = variant and variant()
    out = {}
    for label, (kind, args_) in kappa_inputs(torch).items():
        out[label] = r_ = kappa_time(torch, kk, kind, args_, variant)
        print(f"  {label}: ms={r_['ms']:.4f} ten={r_['ten']:.4f} "
              f"plain={r_['plain']:.4f} bound={r_['bound']:.4f} ({r_['by']})"
              + (f" stream alone ten={r_['stream_ten']:.4f}" if "stream_ten" in r_ else ""),
              flush=True)
    return out


def fps_inputs(torch) -> dict:
    """FPS's six path shapes, label -> (xyz, m, start, skip), from seeds:
    PointNet++ SA1 and SA2 (SA1's centres by the checkout's own FPS), the
    uniform loss's seeds, subsample mode's resampling and its three-fold
    vote from random starts, and the dense subsample path."""
    from geoa3_tpu_torch import ops
    from geoa3_tpu_torch.ops.kernels import fps_kernel as fk

    pc, _, rng = make_batch(torch, B, N, seed=3)
    big, _, _ = make_batch(torch, B, 2 * N, seed=4)
    dense, _, _ = make_batch(torch, DENSE_B, DENSE_N, seed=9)

    def starts(b, n):
        return torch.from_numpy(rng.randint(0, n, b).astype(np.int32)).cuda()

    x1 = ops.gather_points(pc, fk.fps(pc, 512)).contiguous()
    return {
        f"SA1 [{B},{N}]->512": (pc, 512, None, True),
        f"SA2 [{B},512]->128": (x1, 128, None, True),
        f"uniform loss [{B},{N}]->51": (pc, 51, None, True),
        f"subsample [{B},{2 * N}]->{N}": (big, N, starts(B, 2 * N), False),
        f"vote [{3 * B},{2 * N}]->{N}": (big.repeat(3, 1, 1), N,
                                         starts(3 * B, 2 * N), False),
        f"dense [{DENSE_B},{DENSE_N}]->{N}": (dense, N,
                                              starts(DENSE_B, DENSE_N), False),
    }


def fps_time(torch, fk, x_, m_, st_, skip_) -> dict:
    """One FPS shape: ten calls back to back (`ten_ms`), the time a round
    (ms / (m-1)) and the bound (the cloud and starts read once, the indices
    written once; 9 operations a point a round)."""
    b_, n_, _ = x_.shape
    ms = ten_ms(lambda: fk.fps(x_, m_, st_, skip_))
    bound = bound_ms(nbytes(x_) + (0 if st_ is None else nbytes(st_)) + 4 * b_ * m_,
                     9.0 * b_ * n_ * (m_ - 1))
    return {"ms": ms, "us_round": ms * 1e3 / max(m_ - 1, 1),
            "bound_ms": bound[0], "bound_by": bound[1]}


def fps_times_phase(torch) -> dict:
    """`--times 12`: the checkout's FPS timed at its six path shapes
    (`fps_inputs`), with no check run."""
    from geoa3_tpu_torch.ops.kernels import _build, fps_kernel as fk

    print(f"row 12 times of {fk.__file__}")
    inputs = fps_inputs(torch)
    _build.lib()
    out = {}
    for label, args_ in inputs.items():
        out[label] = r_ = fps_time(torch, fk, *args_)
        print(f"  fps[{label}]: ms={r_['ms']:.4f} us_round={r_['us_round']:.4f} "
              f"bound_ms={r_['bound_ms']:.4f} ({r_['bound_by']})", flush=True)
    return out


def msg_kernel_checks(torch, kernels: list) -> list[dict]:
    """Phase 2, third part: the PointNet++ MSG victim's kernels at its shapes
    (b=32): the whole-scale kernel at SA2's three scales (512 -> 128 centres,
    ns 32/64/128, 320 features) and SA1's three with normals (cf=3), at
    cf=0, with empty and over-full balls, and at widths of 1024 (8 clouds);
    the grouped MLP at SA1's three scales and at GroupAll (128 points, 640
    features; and 896 and 1536 features, past 32-row forward tiles, and
    2048 and 4096, with layer 1's input in slices), whose numbers join the
    group_mlp entries of `kernels`; and the k-neighbour 3-channel scatter at
    [32,1024,17,3] -> 1024."""
    from geoa3_tpu_torch.ops.kernels import (
        knn_kernel as qk,
        scatter_kernel as sk,
    )

    out = []
    entry = entry_into(out)
    gen = torch.Generator(device="cuda").manual_seed(13)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    # --- the whole set-abstraction scale ------------------------------------
    sa_in = sa_fused_inputs(torch)
    # SA1 with normals at r=0.2 ns=32, where exact ties of repeated rows
    # hide distinct rows within rounding of the maximum (the autograd hold
    # keeps its cotangent off those), also held through the kernel's own
    # patterns and ties
    rows = {label: sa_fused_case(torch, label, x_, c_, f_, r_, ns_, p_, randn,
                                 timed=True,
                                 patterns=label == "SA1 normals r=0.2 ns=32")
            for label, (x_, c_, f_, r_, ns_, p_) in sa_in.items()}
    x1, x2, f1 = sa_in["SA2 r=0.2 ns=32"][:3]
    pc = sa_in["SA1 normals r=0.1 ns=16"][0]
    far = x2.clone()
    far[:, ::2] += 100.0  # every other ball is empty
    others = {
        "cf=0 r=0.1 ns=16": (pc, x1, None, 0.1, 16, (32, 32, 64)),
        "empty balls": (x1, far, f1, 0.2, 32, (32, 32, 64)),
        "over-full balls r=2": (x1, x2, f1, 2.0, 32, (32, 32, 64)),
        # the widest MLP the JAX package's gate admits: 16-row tiles, 8-row
        # ring stages, hit bits, each ball split over 4 tiles
        "widths 1024, 8 clouds, r=0.2 ns=64": (x1[:8], x2[:8], f1[:8], 0.2, 64,
                                               (1024, 1024, 1024)),
    }
    for label, (x_, c_, f_, r_, ns_, w_) in others.items():
        cf_ = 0 if f_ is None else f_.shape[-1]
        rows[label] = sa_fused_case(torch, label, x_, c_, f_, r_, ns_,
                                    random_mlp(torch, gen, cf_, w_), randn)
    if rows["empty balls"]["idx"][:, ::2].any():
        _fail("sa_fused_fwd: an empty ball does not hold index 0")
    head = rows["SA2 r=0.8 ns=128"]
    rest = lambda k1, k2, ks: "; ".join(  # noqa: E731
        f"{lab}: ms={rows[lab][k1]:.4f} ten={rows[lab][k1[:3] + '_ten']:.4f} "
        f"bound_ms={rows[lab][k2][0]:.4f} split pair ms={rows[lab][ks]:.4f}"
        for lab in sa_in if lab != "SA2 r=0.8 ns=128")
    entry("sa_fused_fwd", "geoa3_tpu_torch/csrc/sa_fused.cu",
          "geoa3_tpu/ops/pallas/sa_fused_kernel.py:108",
          max(r["fwd_err"] for r in rows.values()), head["fwd_ms"],
          head["fwd_plain"], head["fwd_bound"], None,
          "MSG SA2 r=0.8 ns=128: xyz [32,512,3], centres [32,128,3], feats "
          "[32,512,320], (323->128->128->256) -> [32,128,256] (projections, "
          "query pass, tiles: gather, MLP, pool; three device kernels and a "
          "finishing one where balls are split; ten back to back: "
          f"{head['fwd_ten']:.4f}); split pair "
          f"(ballquery_group + group_mlp) ms={head['split_fwd']:.4f}; "
          + rest("fwd_ms", "fwd_bound", "split_fwd"))
    entry("sa_fused_bwd", "geoa3_tpu_torch/csrc/sa_fused.cu",
          "geoa3_tpu/ops/pallas/sa_fused_kernel.py:140",
          max(r["bwd_err"] for r in rows.values()), head["bwd_ms"],
          head["bwd_plain"], head["bwd_bound"], None,
          "MSG SA2 r=0.8 ns=128 -> dxyz [32,512,3], dnew_xyz [32,128,3], "
          "dfeats [32,512,320] (recompute + scatter, back-projection; "
          f"ten back to back: {head['bwd_ten']:.4f}; bound: what the function "
          "needs on this run's data; plain: autograd through the plain "
          "forward, forward included; max_abs_err against float64 autograd "
          "over every row, with the kernel's float32 ReLU pattern where a "
          "pre-activation is within rounding of 0); split pair "
          f"ms={head['split_bwd']:.4f}; "
          + rest("bwd_ms", "bwd_bound", "split_bwd"))
    # the projection kernels' own rows, by shape (inside the two entries'
    # launches: one projection a sa_fused_fwd, one back-projection a
    # sa_fused_bwd)
    for k_, key in zip(out[-2:], ("proj", "bproj")):
        k_["projection" if key == "proj" else "back_projection"] = {
            lab: {"kernel_ms": rows[lab][key + "_ms"],
                  "bound_ms": rows[lab][key + "_bound"][0],
                  "bound_by": rows[lab][key + "_bound"][1],
                  "plain_ms": rows[lab][key + "_plain"],
                  "library_ms": rows[lab][key + "_lib"],
                  "library_ten_ms": rows[lab][key + "_lib_ten"]}
            for lab in sa_in}

    # --- the grouped MLP at MSG's shapes -------------------------------------
    mshapes = {**group_mlp_inputs(torch, "MSG"), **group_mlp_inputs(torch, "wide")}
    mrows = {label: group_mlp_case(torch, label, gx_, gf_, p_, randn)
             for label, (gx_, gf_, p_) in mshapes.items()}
    for label in [lab for lab in mrows if "GroupAll" in lab]:
        if mrows[label]["tied"] == 0:
            _fail(f"group_mlp[{label}]: the inputs held no tied maxima")
        if mrows[label]["across"] == 0:
            _fail(f"group_mlp_fwd[{label}]: no maximum is tied across two "
                  "blocks, the split's merge is unchecked")
    for k in kernels:
        if k["name"] in ("group_mlp_fwd", "group_mlp_bwd"):
            which = "fwd" if k["name"].endswith("fwd") else "bwd"
            k["max_abs_err"] = max([k["max_abs_err"]] + [
                r[f"{which}_err"] for r in mrows.values()])
            k["shape"] += "; MSG and wider GroupAll: " + "; ".join(
                f"{lab}: ms={r[which + '_ms']:.4f} plain_ms="
                f"{r[which + '_plain']:.4f} bound_ms={r[which + '_bound'][0]:.4f}"
                f" ten={r[which + '_ten']:.4f}"
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


def dense_hold(torch, name, got, want, rel, what, planted) -> None:
    """Holds `got` against its plain version `want` entry by entry:
    |got - want| <= rel * max(|want|, the median of |want|). Never looser
    than rel * max |want|, the bound at [32,1024]: at n = 10000 and 12288
    the expansion radius blows a handful of entries up to ~1e11 (near-
    coincident neighbours, cancellation in |p_j|^2 - 2 p_i.p_j + |p_i|^2),
    which would make that bound hold nothing; here they are held relative
    to themselves. `planted` (index, terms): `got` less one pair's term in
    each of a few rows (`dropped_terms`) must fail the hold, or the hold
    could not see a kernel that drops them."""
    a = want.abs()
    scale = a.clamp_min(a.median())

    def worst(x):
        return ((x - want).abs() / scale).max().item()

    ratio, bad = worst(got), worst(got.index_put(planted[0], -planted[1],
                                                 accumulate=True))
    ok = ratio <= rel and bad > rel
    print(f"  {name}: {what} max |err| / max(|plain|, median)={ratio:.3e} "
          f"tol={rel:.0e} (max_abs_err={(got - want).abs().max().item():.3e}); "
          f"one pair's term dropped in {len(planted[1])} rows: {bad:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if ratio > rel:
        _fail(f"{name} disagrees with its plain version ({what})")
    if bad <= rel:
        _fail(f"{name}'s hold misses dropped pair terms ({what})")


def dropped_terms(torch, kk, kind, pc, nrm, mask, g, seed, rows=64):
    """A fault to plant in a dense hold: in `rows` seeded rows i, one pair
    (i, j), j a member other than i, and the term that the pair adds to
    the output, from the plain version on the two points alone: for row 9
    (kind "frommask") its share of kappa_i; for row 8 (kind a radius) the
    neighbour-side gradient g_i d kappa_i / d p_j, which one atomic adds.
    Returns (index into the output, the terms)."""
    b_, n_, _ = pc.shape
    rng = np.random.RandomState(seed)
    bi = torch.from_numpy(rng.randint(b_, size=rows)).to(pc.device)
    i = torch.from_numpy(rng.randint(n_, size=rows)).to(pc.device)
    member = mask[bi, i] != 0
    member[torch.arange(rows, device=pc.device), i] = False
    j = member.float().argmax(-1)
    two_p = torch.stack([pc[bi, i], pc[bi, j]], 1)
    two_n = torch.stack([nrm[bi, i], nrm[bi, j]], 1)
    if kind == "frommask":
        pair = torch.tensor([[0, 1], [0, 0]], dtype=torch.int8,
                            device=pc.device).expand(rows, 2, 2)
        return (bi, i), kk.kappa_from_mask_plain(two_p, two_n, pair, K)[:, 0]
    # k = 1 with both rows full (the direct radius wants k+1 members a
    # row) and row j's cotangent 0: row i's pair alone, g_i / K its weight
    pair = torch.ones(rows, 2, 2, dtype=torch.int8, device=pc.device)
    two_g = torch.stack([g[bi, i] / K, torch.zeros_like(g[bi, i])], 1)
    return (bi, j), kk.kappa_bwd_plain(two_p, two_n, pair, two_g, 1, kind)[:, 1]


def dense_kernel_checks(torch, kernels: list) -> None:
    """Phase 2, last part: the streaming selection and the mask readers past
    the main path's shapes. Rows 3, 5 and 11 bit-equal to their plain
    versions at a ragged n = 1000 (b=2: most mask rows start off a 16-byte
    boundary), at the reference's dense n = 10000 (b=2) and at 12288 (one
    cloud), the kNN also at one query row against m = 10000 (the partial-
    variable patch query); rows 8 (both radii) and 9 at all three, held
    by `dense_hold` with a planted fault (at 10000 and 12288 on the plan
    that reads the cloud through L2), and row 8 with the direct radius
    at the dense runs' [16,10000] (its plan at b = 16: more rows a block,
    one row a stage); row 4 at n = 1000 and 12288. The dense shapes' times
    and bounds join the `shape` notes of `kernels`."""
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
        for radius in kk.RADII:
            gb = kk.kappa_bwd(pc, nrm, km, g, K, radius)
            gb_p = kk.kappa_bwd_plain(pc, nrm, km, g, K, radius)
            # [32,1024]'s 2e-4, entry by entry
            dense_hold(torch, f"kappa_bwd[{radius}]{label}", gb, gb_p, 2e-4, "grad",
                       dropped_terms(torch, kk, radius, pc, nrm, km, g, n_))
            del gb_p
        kf = kk.kappa_frommask(pc, nrm, km, K)
        kf_p = kk.kappa_from_mask_plain(pc, nrm, km, K)
        dense_hold(torch, f"kappa_frommask{label}", kf, kf_p, 1e-5, "kappa",
                   dropped_terms(torch, kk, "frommask", pc, nrm, km, g, n_ + 1))
        del kf_p
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
    # the dense runs' shape: row 8, direct radius, on the selection's mask
    # (held bit-equal above); the plain version a cloud at a time
    b_, n_ = DENSE_B, DENSE_N
    pc, nrm, rng = make_batch(torch, b_, n_, seed=30 + b_ + n_)
    label = f"[{b_},{n_}]"
    mask = kk.kappa_selmask(pc, K)
    g = torch.from_numpy(rng.randn(b_, n_).astype(np.float32)).cuda()
    gb = kk.kappa_bwd(pc, nrm, mask, g, K, "direct")
    gb_p = torch.cat([kk.kappa_bwd_plain(pc[c:c + 1], nrm[c:c + 1], mask[c:c + 1],
                                         g[c:c + 1], K, "direct") for c in range(b_)])
    dense_hold(torch, f"kappa_bwd[direct]{label}", gb, gb_p, 2e-4, "grad",
               dropped_terms(torch, kk, "direct", pc, nrm, mask, g, n_ + b_))
    notes["kappa_bwd"].append(
        f"{label} direct: ms={time_ms(lambda: kk.kappa_bwd(pc, nrm, mask, g, K, 'direct'), iters=5):.4f} "
        f"bound_ms={bound_ms(nbytes(pc, nrm, mask, g, gb), 60.0 * b_ * n_ * (K + 1))[0]:.4f}")
    del pc, nrm, mask, g, gb, gb_p
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
# a kernel whose main path is not the first path that names it: row 13's is
# training (the backward of PointNet++ SA2's feature gathers), not the
# public ops
MAIN_PATH_OF = {"scatter_add_nc": "train PointNetPP"}


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
        """The count of the kernel's main path (`MAIN_PATH_OF`, else the
        first path that names it), and the counts of every path."""
        by_path = {label: c[kernel] for label, c in self.counts.items()}
        first = MAIN_PATH_OF.get(kernel) or next(
            label for label, req in self.required.items() if kernel in req)
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
    return dict(saved=len(mats), total=total, seconds=secs, dir=str(saved))


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

    class ReluPattern(torch.overrides.TorchFunctionMode):
        """Records the input of each `torch.relu` in call order. Given the
        card's inputs, a CPU relu takes the card's pattern where its own input
        lies within rounding of 0 (1e-5 of the layer's largest: float32 dots
        of 384 terms in other orders agree to ~4e-7 of it), so that a unit on
        the other side of 0 does not move the gradient by a whole term; it
        counts where the patterns differ inside and outside that band."""

        def __init__(self, card=None):
            super().__init__()
            self.pre, self.card, self.taken, self.far = [], card, 0, 0

        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func is not torch.relu:
                return func(*args, **(kwargs or {}))
            x = args[0]
            xd = x.detach()
            self.pre.append(xd.clone())
            if self.card is None:
                return func(x)
            own, card = xd > 0, self.card[len(self.pre) - 1] > 0
            near = xd.abs() <= 1e-5 * xd.abs().max()
            self.taken += int(((own != card) & near).sum())
            self.far += int(((own != card) & ~near).sum())
            return torch.where(torch.where(near, card, own), x,
                               torch.zeros_like(x))

    def fp_run(dev, relus):
        """FP forward and the gradients of both feature inputs."""
        uf = ufeats.to(dev).requires_grad_(True)
        kf = kfeats.to(dev).requires_grad_(True)
        _, nn_idx = ops.three_nn(unknown.to(dev), known.to(dev))
        with relus:
            y = fp.to(dev)(unknown.to(dev), known.to(dev), uf, kf)
        duf, dkf = torch.autograd.grad((y * y).sum(), [uf, kf])
        return [t.detach().cpu() for t in (nn_idx, y, duf, dkf)]

    card_relus = ReluPattern()

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
                fp_run("cuda", card_relus))

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
    cpu_relus = ReluPattern([t.cpu() for t in card_relus.pre])
    fp_cpu = fp_run("cpu", cpu_relus)
    print(f"  PointnetFPModule, card vs CPU: {cpu_relus.taken} ReLU units within "
          f"rounding of 0 take the card's side, {cpu_relus.far} differ beyond it")
    if len(cpu_relus.pre) != len(card_relus.pre) or cpu_relus.far:
        _fail("PointnetFPModule, card vs CPU: the ReLU patterns differ")
    require_equal(torch, "three_nn (card vs CPU)", fp_card[0], fp_cpu[0], "idx")
    for g_, c_, what in zip(fp_card[1:], fp_cpu[1:],
                            ("output", "unknown features' gradient",
                             "known features' gradient")):
        # float32 products in other orders (cuBLAS against the CPU's), the
        # same ReLU pattern; interpolation weights from bit-equal selections
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


# the defense CLI's three types, with the kernels each launches a batch
DEFENSE_LAUNCHES = {"rand_drop": {"pool_fwd": 3},
                    "outliers_fixNum": {"knn": 1, "pool_fwd": 3},
                    "outliers_variance": {"knn": 1}}
DENSE_MATS = 8  # synthetic clouds of 2 N points beside phase 5's, so FPS runs
NEAR = 1e-5  # relative distance to a defense's threshold set aside


def defense_dir(torch, cli_dir: Path) -> Path:
    """build/chip_smoke/defense/Mat: phase 5's adversarial .mat files and
    DENSE_MATS synthetic clouds of 2 N points, which the defense resamples
    to N by FPS."""
    import shutil

    from geoa3_tpu_torch.data import io as gio
    from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES
    from geoa3_tpu_torch.workload import synthetic_batch

    root = REPO / "build" / "chip_smoke" / "defense"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(cli_dir / "Mat", root / "Mat")
    pc, _ = synthetic_batch(DENSE_MATS, 2 * N, seed=7, device="cpu")
    for i in range(DENSE_MATS):
        gio.save_adversarial_mat(str(root / "Mat" / f"dense_{i}.mat"), pc[i].numpy(),
                                 TEN_LABEL_INDEXES[i % 10],
                                 TEN_LABEL_INDEXES[(i + 1) % 10])
    return root


def defense_batches(torch, mat_dir: Path):
    """The defense and smoothness CLIs' batches: (clouds [B, n, 3] on the
    CPU, the number of real clouds)."""
    from geoa3_tpu_torch.data.modelnet import (
        DefenseMatDataset,
        pad_batch,
        size_batches,
    )

    ds = DefenseMatDataset(str(mat_dir))
    pcs = [ds[i][0] for i in range(len(ds))]
    for chunk in size_batches([pc.shape[0] for pc in pcs], B):
        yield torch.from_numpy(pad_batch([pcs[i] for i in chunk], B)), len(chunk)


def near_cut(dis, keep: int) -> bool:
    """Whether the fixed-count keep of a cloud cuts between two mean
    distances within NEAR of each other."""
    s = np.sort(dis)
    return bool(s[keep] - s[keep - 1] <= NEAR * s[keep])


def near_threshold(dis, alpha: float) -> int:
    """Points whose mean distance lies within NEAR of the variance
    defense's threshold (either side of it is right)."""
    thr = dis.mean() + alpha * dis.std(ddof=1)
    return int((np.abs(dis - thr) <= NEAR * abs(thr)).sum())


def defense_cpu_agreement(torch, mat_dir: Path, model_g, model_c, drop_num,
                          alpha, knn) -> dict:
    """Each defended batch on the card against the same batch on the CPU
    (the kernels' plain versions): FPS from the same starts, the random drop
    from the same draws, then the kept points (a cloud whose keep is cut
    within NEAR of a threshold is set aside and counted) and PointNet's
    logits, within 1e-5 of the largest (float32 sums in other orders move
    them ~6e-7, TF32 in conv5 ~3e-5)."""
    from geoa3_tpu_torch import defense as gdef
    from geoa3_tpu_torch.cli.defense import classify
    from geoa3_tpu_torch.ops import farthest_points_sample
    from geoa3_tpu_torch.ops.sampling import random_start

    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {t: 0.0 for t in DEFENSE_LAUNCHES}
    aside = {t: 0 for t in DEFENSE_LAUNCHES}
    tf32 = 0.0
    for pc_c, real in defense_batches(torch, mat_dir):
        pc_g = pc_c.cuda()
        if pc_c.shape[1] > N:
            start = random_start(B, pc_c.shape[1], gen, "cuda")
            pc_g = farthest_points_sample(pc_g, N, start=start)
            pc_c = farthest_points_sample(pc_c, N, start=start.cpu())
            if not torch.equal(pc_g.cpu(), pc_c):
                _fail("defense: FPS on the card picked other points than on the CPU")
        dis = gdef._mean_knn_dist(pc_c, knn).numpy().astype(np.float64)
        noise = gdef.random_drop_noise(pc_g, gen)
        for dtype in DEFENSE_LAUNCHES:
            if dtype == "rand_drop":
                res_g = gdef.drop_by_noise(pc_g, noise, drop_num)
                res_c = gdef.drop_by_noise(pc_c, noise.cpu(), drop_num)
            else:
                res_g = gdef.point_removal(pc_g, dtype, drop_num, alpha, knn)
                res_c = gdef.point_removal(pc_c, dtype, drop_num, alpha, knn)
            agree = []
            for b in range(real):
                same = torch.equal(res_g.pc[b].cpu(), res_c.pc[b])
                if res_c.keep_mask is not None:
                    same = same and torch.equal(res_g.keep_mask[b].cpu(),
                                                res_c.keep_mask[b])
                if same:
                    agree.append(b)
                elif dtype == "outliers_fixNum" and near_cut(dis[b], N - drop_num):
                    aside[dtype] += 1
                elif dtype == "outliers_variance" and near_threshold(dis[b], alpha):
                    aside[dtype] += 1
                else:
                    _fail(f"defense {dtype}: cloud {b} keeps other points on "
                          "the card than on the CPU, away from any threshold")
            with torch.no_grad():
                lg = classify(model_g, "PointNet", res_g).cpu()[agree]
                lc = classify(model_c, "PointNet", res_c)[agree]
                if dtype == "outliers_variance":
                    # the same forward with TF32 allowed in cuDNN: what the
                    # check stands guard against
                    torch.backends.cudnn.allow_tf32 = True
                    lt = classify(model_g, "PointNet", res_g).cpu()[agree]
                    torch.backends.cudnn.allow_tf32 = False
                    tf32 = max(tf32, (lt - lc).abs().max().item()
                               / lc.abs().max().item())
            worst[dtype] = max(worst[dtype], (lg - lc).abs().max().item()
                               / lc.abs().max().item())
    for dtype in DEFENSE_LAUNCHES:
        check(f"defense {dtype}, card vs CPU (PointNet logits, {aside[dtype]} "
              "clouds set aside at a threshold)", worst[dtype], 1e-5,
              "rel to max|logit|")
    print(f"  the masked forward with TF32 in cuDNN: max err {tf32:.3e} rel to "
          "max|logit| (float32 kernels: "
          f"{worst['outliers_variance']:.3e})")
    return dict(max_rel_err=worst, set_aside=aside, tf32_masked_rel_err=tf32)


def smoothness_cpu_agreement(torch, mat_dir: Path, k: int) -> dict:
    """Each point's value on the card against the CPU, within 1e-4 of its
    cloud's smoothness (the largest value); a point whose two smallest
    eigenvalues lie within 1e-3 of the largest has no well-defined normal
    and is set aside and counted. Relative to its own value a point cannot
    be held so: on a flat stretch a value is ~5e-6, and normals that differ
    by float32 rounding (~1e-7 rad) move it by ~1e-7 x its offsets (~0.05),
    so the largest error relative to the point's own value is printed
    beside, with the points past 1e-4 of it."""
    from geoa3_tpu_torch.measurement import point_smoothness

    worst, own, past, aside, total = 0.0, 0.0, 0, 0, 0
    for pc_c, real in defense_batches(torch, mat_dir):
        v_g, _ = point_smoothness(pc_c.cuda(), k, k)
        v_c, ev = point_smoothness(pc_c, k, k)
        v_g, v_c, ev = v_g.cpu()[:real], v_c[:real], ev[:real]
        ok = (ev[..., 1] - ev[..., 0]) >= 1e-3 * ev[..., 2]
        aside += int((~ok).sum())
        total += ok.numel()
        diff = (v_g - v_c).abs()
        worst = max(worst, (diff / v_c.amax(-1, keepdim=True))[ok].max().item())
        rel = torch.where(diff == 0, 0.0, diff / v_c.abs())[ok]
        own = max(own, rel.max().item())
        past += int((rel > 1e-4).sum())
    print(f"  smoothness, card vs CPU: largest error relative to the point's "
          f"own value {own:.3e} ({past} points past 1e-4 of it)")
    check(f"smoothness, card vs CPU per point ({aside} of {total} points set "
          "aside, no well-defined normal)", worst, 1e-4,
          "rel to the cloud's smoothness")
    return dict(max_err_rel_cloud=worst, max_err_rel_point=own,
                points_past_1e4_of_own=past, set_aside=aside, points=total)


def pointnet_forward_ms(torch, model, mat_dir: Path) -> dict:
    """PointNet's forward at [B, N]: unmasked (the fused pool, row 6) and
    under the variance defense's keep mask (conv, BatchNorm, ReLU and a
    masked max, as in the JAX model), CUDA events: one call (the host's
    launches included) and ten back to back behind a spacer (the device's
    time)."""
    from geoa3_tpu_torch import defense as gdef

    pc = next(defense_batches(torch, mat_dir))[0].cuda()
    res = gdef.outliers_variance(pc, 1.1, 2)
    out = {}
    with torch.no_grad():
        for tag, fn in (("unmasked", lambda: model(pc)),
                        ("masked", lambda: model(res.pc, point_mask=res.keep_mask))):
            out[f"{tag}_ms"], out[f"{tag}_ten_ms"] = time_ms(fn), ten_ms(fn)
    print(f"  PointNet forward [{B}, {N}]: unmasked (pool kernel) "
          f"{out['unmasked_ms']:.4f} ms, ten back to back {out['unmasked_ten_ms']:.4f}; "
          f"masked (unfused) {out['masked_ms']:.4f}, ten "
          f"{out['masked_ten_ms']:.4f}")
    return out


def defense_tools_phase(torch, paths, cli_dir: Path) -> dict:
    """Phase 10: the defense CLI (three types), the smoothness CLI and the
    attack-set distillation CLI on the card, on phase 5's Mat/ directory
    and victim plus DENSE_MATS clouds of 2 N points, each with its exact
    launch counts; the defended batches and the point values against the
    CPU; the PointNet++ SSG victim's padded-variance logits against the
    shrunken clouds'; two eval forwards of each victim bit-equal."""
    from geoa3_tpu_torch import defense as gdef
    from geoa3_tpu_torch.cli import defense as defense_cli
    from geoa3_tpu_torch.cli import gen_data_mat as gen_cli
    from geoa3_tpu_torch.cli import smoothness as smooth_cli
    from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES
    from geoa3_tpu_torch.ops.kernels import KERNELS
    from geoa3_tpu_torch.workload import random_victim, synthetic_batch

    import scipy.io as sio

    victims = REPO / "build" / "chip_smoke"
    root = defense_dir(torch, cli_dir)
    n_files = len(list((root / "Mat").iterdir()))
    batches = sum(1 for _ in defense_batches(torch, root / "Mat"))
    dense_batches = -(-DENSE_MATS // B)
    out: dict = {"clouds": n_files, "batches": batches}
    drop_num, alpha, knn = 128, 1.1, 2
    for dtype, per_batch in DEFENSE_LAUNCHES.items():
        argv = ["--datadir", str(root / "Mat"), "--npoint", str(N),
                "--defense_type", dtype, "--drop_num", str(drop_num),
                "--alpha", str(alpha), "--outlier_knn", str(knn),
                "--checkpoint", str(victims / "victim.pt")]
        want = dict.fromkeys(KERNELS, 0)
        want.update({k: v * batches for k, v in per_batch.items()},
                    fps=dense_batches)
        t0 = time.time()
        rates, counts = paths.run(
            f"defense {dtype}", tuple(k for k, v in want.items() if v),
            lambda: defense_cli.main(defense_cli.build_parser().parse_args(argv)))
        secs = time.time() - t0
        if counts != want:
            _fail(f"defense {dtype} launches {counts}, expected {want}")
        if not all(np.isfinite(v) for v in rates.values()) or (
                dtype != "outliers_variance" and rates["avg_drop_point"] != drop_num):
            _fail(f"defense {dtype}: rates {rates}")
        print(f"  defense {dtype}: {batches} batches, {secs:.2f} s, {rates}")
        out[dtype] = dict(seconds=secs, **rates)
    lines = (root / "defense_result.txt").read_text().splitlines()
    if len(lines) != 3:
        _fail(f"defense_result.txt holds {len(lines)} lines, not 3")

    model_c, _ = random_victim("PointNet", seed=0, device="cpu")
    model_g, _ = random_victim("PointNet", seed=0)
    model_c.requires_grad_(False)
    model_g.requires_grad_(False)
    out["card_vs_cpu"] = defense_cpu_agreement(torch, root / "Mat", model_g, model_c,
                                               drop_num, alpha, knn)
    out["pointnet_forward"] = pointnet_forward_ms(torch, model_g, root / "Mat")

    # PointNet++ SSG takes the variance defense's padded cloud as it is
    ssg, _ = random_victim("PointNetPP", seed=0)
    ssg.requires_grad_(False)
    pc = next(defense_batches(torch, root / "Mat"))[0].cuda()
    res = gdef.outliers_variance(pc, alpha, knn)
    worst = 0.0
    with torch.no_grad():
        padded = ssg(res.pc)
        for b in range(B):
            kept = int(res.keep_mask[b].sum())
            shrunk = ssg(res.pc[b:b + 1, :kept])[0]
            err = ((padded[b] - shrunk).abs() - 1e-4 * shrunk.abs()).max().item()
            worst = max(worst, err)
    check("SSG on the padded variance defense vs the shrunken clouds (card)",
          worst, 1e-4, "|diff| - 1e-4 |shrunk|")
    out["ssg_padded_vs_shrunk"] = worst

    k = 16
    t0 = time.time()
    want = dict.fromkeys(KERNELS, 0)
    want["knn"] = 2 * batches
    avg, counts = paths.run(
        "smoothness", ("knn",),
        lambda: smooth_cli.main(smooth_cli.build_parser().parse_args(
            ["--datadir", str(root), "--k", str(k), "--k2", str(k)])))
    secs = time.time() - t0
    if counts != want:
        _fail(f"smoothness launches {counts}, expected {want}")
    vals = sio.loadmat(root / "metric" / f"k{k}.mat")["smoothness"]
    if vals.shape != (1, n_files) or not (np.isfinite(vals).all()
                                          and (vals > 0).all()):
        _fail(f"smoothness: k{k}.mat holds {vals.shape} values for {n_files} clouds")
    print(f"  smoothness: {n_files} clouds, {secs:.2f} s, avg {avg:.4f}")
    out["smoothness"] = dict(seconds=secs, avg=avg,
                             card_vs_cpu=smoothness_cpu_agreement(torch, root / "Mat", k))

    # distillation: a victim that favours the first attacked class keeps
    # `max_out_num` of its instances
    gen_model, _ = random_victim("PointNet", seed=0, device="cpu")
    with torch.no_grad():
        gen_model.fc3.bias[TEN_LABEL_INDEXES[0]] += 10.0
    torch.save(gen_model.state_dict(), root / "victim_gen.pt")
    per_class = 8
    candidates = 10 * 2 * per_class
    want = dict.fromkeys(KERNELS, 0)
    want["pool_fwd"] = 3 * -(-candidates // 64)
    t0 = time.time()
    path, counts = paths.run(
        "gen_data_mat", ("pool_fwd",),
        lambda: gen_cli.main(gen_cli.build_parser().parse_args(
            ["--datadir", "synthetic", "--npoint", str(N), "--max_out_num",
             str(per_class), "--checkpoint", str(root / "victim_gen.pt"),
             "--outdir", str(root / "Data")])))
    secs = time.time() - t0
    if counts != want:
        _fail(f"gen_data_mat launches {counts}, expected {want}")
    d = sio.loadmat(path)
    if d["data"].shape != (per_class, 3, N) or not np.isfinite(d["data"]).all() or (
            d["label"].ravel() != TEN_LABEL_INDEXES[0]).any():
        _fail(f"gen_data_mat: {path} holds {d['data'].shape}, labels "
              f"{set(d['label'].ravel())}")
    print(f"  gen_data_mat: {candidates} candidates, {per_class} kept, {secs:.2f} s")
    out["gen_data_mat"] = dict(seconds=secs, kept=per_class, path=str(path))

    # the filter's selection cannot move: two eval forwards are bit-equal
    x, _ = synthetic_batch(64, N, seed=12)
    for arch in ("PointNet", "PointNetPP", "PointNetPP_MSG"):
        m, _ = random_victim(arch, seed=0)
        with torch.no_grad():
            a, b_ = m(x), m(x)
        if not torch.equal(a, b_):
            _fail(f"two eval forwards of the {arch} victim differ by "
                  f"{(a - b_).abs().max().item():.3e}")
    print("  two eval forwards of each victim at [64, 1024]: bit-equal")
    return out


TRAIN_ARCHS = ("PointNet", "PointNetPP", "PointNetPP_MSG")
TRAIN_EPOCHS = 2
# --datadir synthetic:12:10 at -b 32: 120 training clouds (3 batches of 32
# and one of 24) and 40 test clouds (a batch of 32 and one of 8) an epoch
TRAIN_DATA = "synthetic:12:10"
TRAIN_STEPS, EVAL_BATCHES = 4, 2


def train_launches(arch: str) -> tuple[dict, dict]:
    """({kernel: launches} of one train step, of one eval batch), read from
    the code. A train step runs the models' unfused route: PointNet no
    kernel of ours; PointNet++ FPS at SA1 and SA2, the index-only ball query
    (row 15's forward) at each scale, and the C-channel scatter as the
    backward of SA2's feature gathers (SA1's gathers read the input cloud,
    which takes no gradient). An eval batch runs the eval kernels: PointNet's
    three pools; SSG FPS 2, the query + grouping 2, the grouped MLP 3; MSG
    FPS 2, the query + grouping at SA1's three scales, the grouped MLP at
    those and GroupAll, the whole-scale kernel at SA2's three."""
    from geoa3_tpu_torch.ops.kernels import KERNELS

    step, batch = dict.fromkeys(KERNELS, 0), dict.fromkeys(KERNELS, 0)
    if arch == "PointNet":
        batch["pool_fwd"] = 3
    elif arch == "PointNetPP":
        step.update(fps=2, ballquery_group_fwd=2, scatter_add_nc=1)
        batch.update(fps=2, ballquery_group_fwd=2, group_mlp_fwd=3)
    else:
        step.update(fps=2, ballquery_group_fwd=6, scatter_add_nc=3)
        batch.update(fps=2, ballquery_group_fwd=3, group_mlp_fwd=4, sa_fused_fwd=3)
    return step, batch


def _nonzero(d: dict) -> dict:
    return {k: v for k, v in d.items() if v}


def _expect(label: str, counts: dict, want: dict) -> None:
    if counts != want:
        _fail(f"{label} launches {counts}, expected {want}")


def _same_selection(torch):
    """Within the block, the CPU's FPS and ball query select on float32
    coordinates whatever the model's dtype, so a float64 step on the CPU
    takes the card's selections (the kernels are bit-equal to their plain
    float32 versions, phase 2) and differs from it by arithmetic alone."""
    import contextlib

    from geoa3_tpu_torch.ops.kernels import ballquery_group_kernel as bk
    from geoa3_tpu_torch.ops.kernels import fps_kernel as fk

    @contextlib.contextmanager
    def block():
        fps, bq = fk.fps, bk.ball_query
        fk.fps = lambda xyz, m, **kw: fps(xyz.float(), m, **kw)
        bk.ball_query = lambda xyz, c, r, ns: bq(xyz.float(), c.float(), r, ns)
        try:
            yield
        finally:
            fk.fps, bk.ball_query = fps, bq

    return block()


def _train_step_once(torch, T, tcfg, model, pc, target, keep):
    """One train loss and backward of `model` (epoch 1's BatchNorm
    momentum) -> (loss, {name: grad}, {name: running statistic})."""
    state = T.TrainState(model, T.make_optimizer(tcfg, model))
    T.set_epoch(tcfg, state, 1)
    model.zero_grad(set_to_none=True)
    loss, _ = T.train_loss(tcfg, model, pc, target, keep=keep)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in model.named_parameters()}
    stats = {n: b.detach().double().cpu() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    return loss.detach().double().cpu(), grads, stats


def _vanishing(name: str) -> bool:
    """Gradients that are 0 in exact arithmetic, or nearly (as
    tests/test_torch_train.py names them): the biases a BatchNorm follows,
    and the BatchNorm biases before a max pool whose output meets a
    BatchNorm."""
    if name.startswith("fc_layer"):
        return False
    if name.startswith("SA_modules"):
        return name.endswith(".7.bias")
    if name in ("bn5.bias", "input_transform.bn3.bias", "feature_transform.bn3.bias"):
        return True
    return name.endswith(".bias") and "bn" not in name and "fc3" not in name


def train_step_cpu_agreement(torch, arch: str, b: int) -> dict:
    """One train step on the card against the same step on the CPU, from the
    same weights (workload.random_victim; PointNet's T-Nets off the
    identity), clouds and dropout masks. The CPU runs it in float64 with the
    card's selections (`_same_selection`): the reference; and in float32:
    the yardstick of float32 rounding on this step. At these batches a
    float32 step is ill-conditioned (the heads' BatchNorms over few rows,
    tests/test_torch_train.py), and a ReLU or a maximum within rounding of a
    tie may switch (phase 7), which moves single gradient entries by up to
    ~1e-2 of their tensor's largest on the CPU too, in whichever tensor it
    falls. So each quantity of the card's step is held against the float64
    step at the tests' tolerance or at 4x the CPU float32 step's largest
    error of the same kind, whichever is larger: the loss, the running
    statistics by their largest entry (1e-5 relative), each gradient by its
    Frobenius norm (1e-4 relative), a vanishing gradient by its largest
    entry against 1e-2 of the model's largest gradient entry (1e-4). The
    largest entry errors of the gradients are printed beside them."""
    import copy

    from geoa3_tpu_torch import train as T
    from geoa3_tpu_torch.workload import random_victim, synthetic_batch

    tcfg = T.TrainConfig(arch=arch, classes=40, npoint=N, batch_size=b)
    base, _ = random_victim(arch, seed=4, device="cpu")
    base.requires_grad_(True)
    pc, _ = synthetic_batch(b, N, seed=21, device="cpu")
    target = torch.arange(b) % 40
    g = torch.Generator().manual_seed(5)
    if arch == "PointNet":  # T-Nets off the identity, so they take gradients
        with torch.no_grad():
            for tnet in (base.input_transform, base.feature_transform):
                tnet.fc3.weight.copy_(0.01 * torch.randn(tnet.fc3.weight.shape,
                                                         generator=g))
        keep = (torch.rand(b, 512, generator=g) < 0.7, torch.rand(b, 256, generator=g) < 0.7)
    else:
        keep = torch.rand(b, 256, generator=g) < 0.5
    on = lambda k, dev: tuple(x.to(dev) for x in k) if isinstance(k, tuple) else k.to(dev)  # noqa: E731
    t0 = time.time()
    card = _train_step_once(torch, T, tcfg, copy.deepcopy(base).cuda(), pc.cuda(),
                            target.cuda(), on(keep, "cuda"))
    t1 = time.time()
    cpu32 = _train_step_once(torch, T, tcfg, copy.deepcopy(base), pc, target, keep)
    t2 = time.time()
    with _same_selection(torch):
        cpu64 = _train_step_once(torch, T, tcfg, copy.deepcopy(base).double(),
                                 pc.double(), target, keep)
    secs = {"card": t1 - t0, "cpu32": t2 - t1, "cpu64": time.time() - t2}
    gmax = max(v.abs().max().item() for v in cpu64[1].values())

    def rel_errors(side) -> dict:
        """{(kind, name): error relative to its scale} of one side's step
        against the float64 one."""
        out = {("loss", "loss"): ((side[0] - cpu64[0]).abs() / cpu64[0].abs()).item()}
        for name, ref in cpu64[2].items():
            out["stats", name] = ((side[2][name] - ref).abs().max()
                                  / ref.abs().max()).item()
        for name, ref in cpu64[1].items():
            d = side[1][name] - ref
            if _vanishing(name):
                out["vanishing", name] = d.abs().max().item() / (1e-2 * gmax)
            else:
                out["grad", name] = (d.norm() / max(ref.norm().item(), 1e-30)).item()
                out["grad_entry", name] = (d.abs().max()
                                           / max(ref.abs().max().item(), 1e-30)).item()
        return out

    got, cpu = rel_errors(card), rel_errors(cpu32)
    tols = {"loss": 1e-5, "stats": 1e-5, "grad": 1e-4, "vanishing": 1e-4}
    kinds = {k: max(v for (kk, _), v in cpu.items() if kk == k) for k in tols}
    limits = {k: max(tols[k], 4 * kinds[k]) for k in tols}
    for (kind, name), err in got.items():
        if kind in limits and not err <= limits[kind]:
            _fail(f"{arch} train step card vs CPU: {kind} {name} err {err:.3e} "
                  f"> {limits[kind]:.3e} (the tests' {tols[kind]:.0e}, or 4x the "
                  f"CPU float32 step's largest {kinds[kind]:.3e})")
    worst, where = {}, {}
    for k in ("loss", "stats", "grad", "vanishing", "grad_entry"):
        where[k], worst[k] = max(((n, v) for (kk, n), v in got.items() if kk == k),
                                 key=lambda nv: nv[1])
    print(f"  {arch} train step at b={b}, card vs CPU float64 (the card's "
          f"selections), relative errors: loss {worst['loss']:.3e}, running "
          f"statistics {worst['stats']:.3e}, gradients {worst['grad']:.3e} "
          f"(Frobenius; largest entry {worst['grad_entry']:.3e}), vanishing "
          f"gradients {worst['vanishing']:.3e}; limits {limits} (CPU float32: "
          f"{kinds}); the card's worst tensors {where}; seconds {secs}")
    return dict(b=b, card_rel_err=worst, worst_tensor=where, cpu_float32_rel_err=kinds,
                limits=limits, seconds=secs)


def _eval_logits(torch, T, tcfg, state, dataset) -> list:
    """The eval-mode logits of every test batch (the epoch's evaluation's
    forwards)."""
    out = []
    dataset.reset()
    state.model.eval()
    while dataset.has_next_batch():
        points, _ = dataset.next_batch(False)
        pc = torch.from_numpy(T._prep_batch(tcfg, points)).cuda()
        with torch.no_grad():
            out.append(state.model(pc))
    return out


def _event_ms(torch, fn, calls: int) -> list:
    """ms of each of `calls` calls of fn (CUDA events)."""
    times = []
    for _ in range(calls):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return times


def train_arch(torch, paths, arch: str) -> dict:
    """Phase 11 for one arch: the training CLI in process, its files, two
    evaluations bit-equal, the checkpoint against the trained model, one
    train step's and one eval batch's exact launches, their times and the
    peak device memory."""
    import shutil

    from geoa3_tpu_torch import train as T
    from geoa3_tpu_torch.cli import main_train
    from geoa3_tpu_torch.utils.checkpoint import (
        BEST_NAME,
        CKPT_NAME,
        load_checkpoint,
        load_victim,
    )

    model_dir = REPO / "build" / "chip_smoke" / "train" / arch
    shutil.rmtree(model_dir, ignore_errors=True)
    argv = ["--arch", arch, "--datadir", TRAIN_DATA, "-c", "40", "--npoint",
            str(N), "-b", str(B), "--epochs", str(TRAIN_EPOCHS),
            "--max_epoch_retries", "0", "--modeldir", str(model_dir)]
    args = main_train.build_parser().parse_args(argv)
    step_want, batch_want = train_launches(arch)
    runs = TRAIN_EPOCHS * TRAIN_STEPS, TRAIN_EPOCHS * EVAL_BATCHES
    want = {k: runs[0] * step_want[k] + runs[1] * batch_want[k] for k in step_want}
    t0 = time.time()
    (state, _), counts = paths.run(f"train {arch}", tuple(_nonzero(want)),
                                        lambda: main_train.run(args))
    secs = time.time() - t0
    _expect(f"train {arch} (CLI, {runs[0]} steps, {runs[1]} eval batches)",
            counts, want)
    lines = (model_dir / "result.txt").read_text().splitlines()
    if len(lines) != TRAIN_EPOCHS or not all("train-acc" in x and "test:" in x
                                             for x in lines):
        _fail(f"train {arch}: result.txt holds {lines}")
    ckpt = load_checkpoint(str(model_dir))
    best = load_checkpoint(str(model_dir), best=True)
    if ckpt is None or best is None or ckpt["epoch"] != TRAIN_EPOCHS:
        _fail(f"train {arch}: {CKPT_NAME} / {BEST_NAME} missing or at the wrong epoch")
    for name, p in state.model.named_parameters():
        if not torch.isfinite(p).all():
            _fail(f"train {arch}: {name} is not finite after training")
    print(f"  train {arch}: {TRAIN_EPOCHS} epochs in {secs:.2f} s; {lines[-1]}")

    # selection: the epoch's evaluation is deterministic on the card
    tcfg = T.TrainConfig(arch=arch, classes=40, npoint=N, batch_size=B)
    _, test_ds = main_train.datasets(args, tcfg)
    first = _eval_logits(torch, T, tcfg, state, test_ds)
    second = _eval_logits(torch, T, tcfg, state, test_ds)
    if not all(torch.equal(a, b_) for a, b_ in zip(first, second)):
        _fail(f"train {arch}: two evaluations of the trained model differ")

    # the checkpoints load into the victim the attack CLI builds
    test_ds.reset()
    pts, tgt = test_ds.next_batch(False)
    pc = torch.from_numpy(T._prep_batch(tcfg, pts)).cuda()
    checked = [CKPT_NAME] + ([BEST_NAME] if best["epoch"] == ckpt["epoch"] else [])
    for fname in checked:
        victim, _ = load_victim(arch, 40, N, str(model_dir / fname))
        with torch.no_grad():
            if not torch.equal(victim(pc), first[0]):
                _fail(f"train {arch}: {fname} loaded by load_victim gives other logits")

    # one train step and one eval batch: exact launches, then times
    target = torch.from_numpy(np.asarray(tgt, np.int64)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(7)
    step = T.make_train_step(tcfg, TRAIN_EPOCHS + 1)
    ev = T.make_eval_step(tcfg)
    _, c_step = paths.run(f"train step {arch}", tuple(_nonzero(step_want)),
                          lambda: step(state, pc, target, gen))
    _expect(f"train step {arch}", c_step, step_want)
    _, c_eval = paths.run(f"eval batch {arch}", tuple(_nonzero(batch_want)),
                          lambda: ev(state, pc, target))
    _expect(f"eval batch {arch}", c_eval, batch_want)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = _event_ms(torch, lambda: step(state, pc, target, gen), 6)[1:]
    peak = torch.cuda.max_memory_allocated() / 2**30
    eval_ms = _event_ms(torch, lambda: ev(state, pc, target), 6)[1:]
    out = dict(seconds=secs, result=lines[-1], best_epoch=int(best["epoch"]),
               bit_equal_checkpoints=checked,
               step_ms=statistics.median(step_ms), step_ms_all=step_ms,
               eval_batch_ms=statistics.median(eval_ms), peak_gib=peak,
               launches_step=_nonzero(c_step), launches_eval_batch=_nonzero(c_eval))
    print(f"  train {arch}: a step {out['step_ms']:.4f} ms (median of "
          f"{len(step_ms)} after the first, CUDA events), an eval batch "
          f"{out['eval_batch_ms']:.4f} ms, peak {peak:.2f} GiB; launches a "
          f"step {out['launches_step']}, an eval batch {out['launches_eval_batch']}")
    return out


def train_phase(torch, paths, gen_mat: str, card: str) -> dict:
    """Phase 11: victim training on the card. The training CLI in process
    for each arch at full width (40 classes, 1024 points, b = 32, synthetic
    data, 2 epochs, no epoch retry), a resume of PointNet to epoch 3,
    readiness on PointNet's model_best.pth.tar with phase 10's distilled
    set, and one train step of each arch card vs CPU."""
    from geoa3_tpu_torch.cli import main_train, readiness
    from geoa3_tpu_torch.utils.checkpoint import BEST_NAME, load_checkpoint

    out = {"card": card}
    for arch in TRAIN_ARCHS:
        out[arch] = train_arch(torch, paths, arch)

    model_dir = REPO / "build" / "chip_smoke" / "train" / "PointNet"
    argv = ["--arch", "PointNet", "--datadir", TRAIN_DATA, "-c", "40", "--npoint",
            str(N), "-b", str(B), "--epochs", str(TRAIN_EPOCHS + 1),
            "--max_epoch_retries", "0", "--modeldir", str(model_dir),
            "--resume", str(model_dir)]
    _, counts = paths.run("train PointNet --resume", ("pool_fwd",),
                          lambda: main_train.main(main_train.build_parser().parse_args(argv)))
    lines = (model_dir / "result.txt").read_text().splitlines()
    if len(lines) != TRAIN_EPOCHS + 1 or load_checkpoint(str(model_dir))["epoch"] != TRAIN_EPOCHS + 1:
        _fail(f"the resumed run did not add epoch {TRAIN_EPOCHS + 1}: {lines}")
    if counts["pool_fwd"] != 3 * EVAL_BATCHES:
        _fail(f"the resumed run evaluated {counts['pool_fwd'] // 3} batches, "
              f"not {EVAL_BATCHES}")
    print(f"  train PointNet --resume: epoch {TRAIN_EPOCHS + 1}; {lines[-1]}")

    report = REPO / "build" / "chip_smoke" / "train" / "readiness.json"
    rargs = readiness.build_parser().parse_args(
        ["--checkpoint", str(model_dir / BEST_NAME), "--data_dir_file", gen_mat,
         "--out", str(report)])
    rc, _ = paths.run("readiness", ("nn1_payload", "curv_term", "pool_fwd", "pool_bwd"),
                      lambda: readiness.main(rargs))
    steps = json.loads(report.read_text())["steps"]
    status = {k: v["status"] for k, v in steps.items()}
    if rc != 0 or status["convert"] != "PASS" or status["attack_smoke"] != "PASS":
        _fail(f"readiness exited {rc}: {status}")
    print(f"  readiness: exit {rc}, {status}")
    out["readiness"] = status

    for arch, b in (("PointNet", B), ("PointNetPP", 4), ("PointNetPP_MSG", 4)):
        out[arch]["card_vs_cpu"] = train_step_cpu_agreement(torch, arch, b)
    return out


# ---------------------------------------------------------------- phase 12

MGPU_DIR = REPO / "build" / "chip_smoke" / "mgpu"
MGPU_TIMEOUT = 300  # seconds a spawned rank may take, its collectives too
MGPU_STEPS = 20  # attack steps (1 binary step, K = 10)
MGPU_CLI_B = 40  # phase 5's 40 synthetic clouds, one padded batch: 20 a rank
# the two-rank train steps: name -> (arch, (n_data, n_model))
MGPU_TRAIN = {"PointNet dp2": ("PointNet", (2, 1)),
              "PointNet tp2": ("PointNet", (1, 2)),
              "PointNetPP dp2": ("PointNetPP", (2, 1))}


def pointnet_attack_launches(steps: int, refresh: int, batches: int = 1,
                             reevaluate: bool = False) -> dict:
    """Every kernel's launches of the default attack on PointNet (one binary
    step of `steps` steps a batch), read from the code: per step one victim
    forward (three pools) and backward (three pool backwards), the 1-NN
    payload, the o2a Chamfer term's 3-channel scatter and the curvature
    term; a selection mask every `refresh` steps; the kappa prologue once a
    batch; the CLI's re-evaluation of each batch's result (three pools)."""
    from geoa3_tpu_torch.ops.kernels import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want.update(nn1_payload=batches * steps, scatter_add_3t=batches * steps,
                kappa_selmask=batches * (steps // refresh),
                curv_term=batches * steps, kappa_fwd=batches,
                pool_fwd=batches * 3 * (steps + int(reevaluate)),
                pool_bwd=batches * 3 * steps)
    return want


BF16_PATH = ("nn1_payload", "scatter_add_3t", "kappa_selmask", "curv_term",
             "kappa_fwd", "pool_fwd", "pool_fwd_bf16", "pool_bwd_bf16")


def bf16_attack_launches(steps: int, refresh: int, batches: int = 1,
                         reevaluate: bool = False, healthchecks: int = 0) -> dict:
    """`pointnet_attack_launches` with the bf16 victim's gradient pass: its
    three pools run the single-pass bf16 kernels forward and backward each
    step (and once each a health check), and the float32 victim judges each
    step by a forward of its own (three float32 pools, as many as the
    float32 attack's gradient pass launches), and no float32 backward."""
    want = pointnet_attack_launches(steps, refresh, batches, reevaluate)
    want.update(pool_bwd=0,
                pool_fwd_bf16=batches * 3 * steps + 3 * healthchecks,
                pool_bwd_bf16=batches * 3 * steps + 3 * healthchecks)
    return want


def bf16_cpu_agreement(torch) -> dict:
    """The bf16 victim's logits and input gradient (of sum(logits^2)) on the
    card against the same twin on the CPU (the kernels' plain versions),
    at tests/test_torch_bf16.py's tolerances: 1e-3 of max |logit| and 3e-2
    of max |g| (the tensor cores' float32 sums against the CPU's, of the
    same exact bf16 products, and bf16 roundings in the small bf16 layers
    where they fall differently)."""
    from geoa3_tpu_torch.models import make_eval_fn
    from geoa3_tpu_torch.workload import random_victim

    b, n = 4, N
    model, _ = random_victim("PointNet", 40, n, seed=2, device="cpu")
    pc, _, _ = make_batch(torch, b, n, seed=2)
    got = {}
    for dev in ("cuda", "cpu"):
        fn = make_eval_fn(model.to(dev), dtype=torch.bfloat16)
        x = pc.to(dev).requires_grad_(True)
        logits = fn(x)
        (g,) = torch.autograd.grad((logits ** 2).sum(), x)
        got[dev] = (logits.detach().cpu(), g.cpu())
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    lerr = ((lg - lc).abs().max() / lc.abs().max()).item()
    gerr = ((gg - gc).abs().max() / gc.abs().max()).item()
    print(f"  bf16 victim card vs CPU ([{b},{n}]): logits err / max |logit| "
          f"{lerr:.3e} (tol 1e-3), input gradient err / max |g| {gerr:.3e} (tol 3e-2)")
    if not (lerr <= 1e-3 and gerr <= 3e-2):
        _fail("the bf16 victim on the card disagrees with the CPU")
    return dict(logits_err=lerr, grad_err=gerr)


def bf16_step_entries(torch, step) -> list:
    """The bf16 backward's entries (`tile_entries`) at the three pools of
    the first step of a bf16 attack: `step` runs with the pool's autograd
    backward wrapped to record them from its saved tensors (the kernel and
    its launch count untouched)."""
    from geoa3_tpu_torch.ops.kernels import pool_matmul_kernel as pk

    fn = pk._PoolAffineMaxBf16
    seen, backward = [], fn.backward

    def record(ctx, g):
        if len(seen) < 3:
            x, w3, _, bias, pooled, cnt, rows = ctx.saved_tensors
            seen.append(dict(taps=w3.shape[0], dtype=str(x.dtype).split(".")[-1],
                             **tile_entries(torch, pk, x, w3, bias, g.contiguous(), pooled,
                                            cnt, rows)))
        return backward(ctx, g)

    fn.backward = staticmethod(record)
    try:
        step()
    finally:
        fn.backward = staticmethod(backward)
    if len(seen) != 3:
        _fail(f"a bf16 attack step ran {len(seen)} pool backwards, not 3")
    return seen


def bf16_victim_phase(torch, paths) -> dict:
    """Phase 13: the bf16 PointNet victim (`--victim_dtype bfloat16`) at
    full width: the health check at the run's shape, the default attack 1 x
    50 (K=10) with the bf16 twin's gradient and the float32 victim as judge,
    its launch counts read from the code, its ms/step beside the float32
    attack's in this call (twice each, in turns), the twin card vs CPU, and
    the attack CLI in process with --victim_dtype bfloat16 on phase 5's 40
    clouds and victim into build/chip_smoke/bf16/."""
    import scipy.io as sio

    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main
    from geoa3_tpu_torch.models import bf16_grad_healthcheck, make_eval_fn
    from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    model, logits_fn = random_victim("PointNet", seed=0)
    grad_fn = make_eval_fn(model, dtype=torch.bfloat16)
    reset_launch_counts()
    healthy = bf16_grad_healthcheck(grad_fn, B, N, "cuda")
    hc = launch_counts()
    if not healthy or hc["pool_fwd_bf16"] != 3 or hc["pool_bwd_bf16"] != 3:
        _fail(f"the bf16 health check at [{B},{N},3]: healthy={healthy}, "
              f"launches {hc}")
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    with torch.no_grad():
        gt = logits_fn(pc).argmax(-1)

    def run(cfg, seed, bf16):
        fn = make_attack_fn(grad_fn if bf16 else logits_fn, cfg,
                            eval_logits_fn=logits_fn if bf16 else None)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return timed_attack(torch, fn, (pc, nrm, gt, gt, gen),
                            cfg.binary_max_steps * cfg.iter_max_steps)

    run(main_path_config(1, 10), 99, True)  # warm-up
    steps = 50
    cfg = main_path_config(1, steps)
    (res, ms_bf16), counts = paths.run("bf16 K=10", BF16_PATH,
                                       lambda: run(cfg, 0, True))
    check_result(torch, res, steps, "bf16 K=10")
    want = bf16_attack_launches(steps, cfg.curv_knn_refresh_every)
    if counts != want:
        _fail(f"the bf16 attack launched {counts}, expected {want}")
    times = {"bf16": [ms_bf16], "float32": []}
    for bf16 in (False, False, True):  # bf16, f32, f32, bf16
        times["bf16" if bf16 else "float32"].append(run(cfg, 0, bf16)[1])
    print(f"  bf16 K=10 attack: 1x{steps} steps, success {int(res.success.sum())}/{B}, "
          f"ms/step bf16 {times['bf16']} float32 {times['float32']} (in turns: "
          "bf16, f32, f32, bf16; CUDA events); launches as read from the code")
    agreement = bf16_cpu_agreement(torch)
    entries = bf16_step_entries(torch, lambda: run(main_path_config(1, 10), 0, True))
    print("  pool_bwd_bf16 entries in a bf16 attack step: " + "; ".join(
        f"taps={e['taps']}, {e['dtype']} x: {entries_text(e)}" for e in entries))

    root = REPO / "build" / "chip_smoke"
    per_class, cli_steps = 4, 20
    total = 10 * per_class
    argv = ["--attack", "GeoA3", "--attack_label", "Untarget",
            "--data_dir_file", f"synthetic:{per_class}:{N}", "-b", str(B),
            "--binary_max_steps", "1", "--iter_max_steps", str(cli_steps),
            "--checkpoint", str(root / "victim.pt"), "--victim_dtype", "bfloat16",
            "--exps_root", str(root / "bf16" / "Exps")]
    t0 = time.time()
    saved, cli_counts = paths.run("CLI bf16", BF16_PATH,
                                  lambda: cli_main(build_parser().parse_args(argv)))
    torch.cuda.synchronize()
    secs = time.time() - t0
    batches = -(-total // B)
    want = bf16_attack_launches(cli_steps, 10, batches, reevaluate=True,
                                healthchecks=1)
    if cli_counts != want:
        _fail(f"the bf16 CLI launched {cli_counts}, expected {want}")
    saved = Path(saved)
    mats = sorted(p.name for p in (saved / "Mat").iterdir())
    objs = sorted(p.name for p in (saved / "PC").iterdir())
    if not mats or [m[:-4] for m in mats] != [o[:-4] for o in objs]:
        _fail(f"bf16 CLI: Mat/ and PC/ do not hold the same instances")
    cloud = sio.loadmat(saved / "Mat" / mats[0])["adversary_point_clouds"]
    if cloud.shape != (3, N) or not np.isfinite(cloud).all():
        _fail(f"bf16 CLI: saved cloud has shape {cloud.shape} or is not finite")
    rate = float((saved / "attack_result.txt").read_text().strip()
                 .splitlines()[-1].split(":")[1])
    if abs(rate - 100.0 * len(mats) / total) > 0.01:
        _fail(f"bf16 CLI: attack_result.txt says {rate}% but {len(mats)} of "
              f"{total} instances were saved")
    print(f"  CLI --victim_dtype bfloat16: {total} clouds in {batches} batches, "
          f"1x{cli_steps} steps, {len(mats)} saved ({rate:.2f}%), {secs:.1f} s, "
          "launches as read from the code (the health check's included)")
    return dict(ms_per_step=times, success=int(res.success.sum()),
                cpu_agreement=agreement, cli_saved=len(mats), cli_seconds=secs,
                step_entries=entries)


# ---------------------------------------------------------------- phase 14

# the bf16 PointNet++ attacks' launches, read from the code: one float32
# forward of the victim (the judge of each step, and the CLI's
# re-evaluation of each batch), and one pass of the bf16 twin, forward and
# backward (FPS at SA1 and SA2; the single-pass grouped MLP where the JAX
# gate fuses: SSG's three levels, MSG's SA1 scales and GroupAll; the
# backward of the two FPS gathers and of each scale's coordinate gather by
# the 3-channel scatter, of each feature gather by the C-channel one)
PP_F32_FORWARD = {
    "PointNetPP": dict(fps=2, ballquery_group_fwd=2, group_mlp_fwd=3),
    "PointNetPP_MSG": dict(fps=2, ballquery_group_fwd=3, group_mlp_fwd=4,
                           sa_fused_fwd=3),
}
PP_BF16_PASS = {
    "PointNetPP": dict(fps=2, group_mlp_fwd_bf16=3, group_mlp_bwd_bf16=3,
                       scatter_add_3t=4, scatter_add_nc=1),
    "PointNetPP_MSG": dict(fps=2, group_mlp_fwd_bf16=4, group_mlp_bwd_bf16=4,
                           scatter_add_3t=8, scatter_add_nc=3),
}
PP_BF16_PATH = ("nn1_payload", "scatter_add_3t", "kappa_selmask", "curv_term",
                "kappa_fwd", "fps", "ballquery_group_fwd", "group_mlp_fwd",
                "group_mlp_fwd_bf16", "group_mlp_bwd_bf16", "scatter_add_nc")


def bf16_pp_launches(arch: str, steps: int, refresh: int, batches: int = 1,
                     reevaluate: bool = False, healthchecks: int = 0) -> dict:
    """Every kernel's launches of the default attack on a bf16 PointNet++
    twin (one binary step of `steps` steps a batch): per step the loss's
    kernels (1-NN payload, the o2a Chamfer term's scatter, the curvature
    term; a selection mask every `refresh` steps; the kappa prologue once a
    batch), one twin pass and one float32 forward (`PP_F32_FORWARD`,
    `PP_BF16_PASS`); one float32 forward more a batch where the CLI
    re-evaluates it, one twin pass a health check."""
    from geoa3_tpu_torch.ops.kernels import KERNELS

    want = dict.fromkeys(KERNELS, 0)
    want.update(nn1_payload=batches * steps, scatter_add_3t=batches * steps,
                kappa_selmask=batches * (steps // refresh),
                curv_term=batches * steps, kappa_fwd=batches)
    for k, v in PP_F32_FORWARD[arch].items():
        want[k] += batches * (steps + int(reevaluate)) * v
    for k, v in PP_BF16_PASS[arch].items():
        want[k] += (batches * steps + healthchecks) * v
    return want


def bf16_pp_cpu_agreement(torch, arch: str) -> dict:
    """A bf16 PointNet++ twin's logits and input gradient (of
    sum(logits^2)) on the card against the same twin on the CPU (the
    kernels' plain versions) at [2, 1024]. The tensor cores sum the grouped
    MLP's exact bf16 products in another order than the CPU, and that order
    alone moves the bf16 victims a long way (JAX against JAX,
    tests/test_torch_pointnetpp_bf16.py::test_summation_order_yardstick:
    MSG's logits by 3.2e-3 of max |logit|, its gradient by 0.15 of max |g|,
    relative L2 0.09): logits within 1e-2 of max |logit|, the gradient's
    relative L2 distance within 0.3 (its max |err| / max |g| and cosine
    printed beside it)."""
    from geoa3_tpu_torch.models import make_eval_fn
    from geoa3_tpu_torch.workload import random_victim

    b = 2
    model, _ = random_victim(arch, seed=2, device="cpu")
    pc, _, _ = make_batch(torch, b, N, seed=2)
    got = {}
    for dev in ("cuda", "cpu"):
        fn = make_eval_fn(model.to(dev), dtype=torch.bfloat16)
        x = pc.to(dev).requires_grad_(True)
        logits = fn(x)
        (g,) = torch.autograd.grad((logits ** 2).sum(), x)
        got[dev] = (logits.detach().cpu().double(), g.cpu().double())
    (lg, gg), (lc, gc) = got["cuda"], got["cpu"]
    lerr = ((lg - lc).abs().max() / lc.abs().max()).item()
    gerr = ((gg - gc).abs().max() / gc.abs().max()).item()
    rel = ((gg - gc).norm() / gc.norm()).item()
    cos = (gg * gc).sum().item() / (gg.norm() * gc.norm()).item()
    print(f"  bf16 {arch} twin card vs CPU ([{b},{N}]): logits err / max |logit| "
          f"{lerr:.3e} (tol 1e-2); input gradient relative L2 {rel:.3e} (tol "
          f"0.3), err / max |g| {gerr:.3e}, cosine {cos:.6f}, "
          f"{(gg == gc).double().mean().item():.4f} bit-equal")
    if not (lerr <= 1e-2 and rel <= 0.3):
        _fail(f"the bf16 {arch} twin on the card disagrees with the CPU")
    return dict(logits_err=lerr, grad_err=gerr, grad_rel_l2=rel, grad_cos=cos)


def bf16_pointnetpp_phase(torch, paths) -> dict:
    """Phase 14: the bf16 PointNet++ victims (`--victim_dtype bfloat16
    --arch PointNetPP | PointNetPP_MSG`) at full width: for each, the
    health check at [32, 1024, 3], the default attack 1 x 30 (K=10) with
    the bf16 twin's gradient and the float32 victim as judge, its launch
    counts read from the code, its ms/step beside the float32 attack's in
    this call (twice each, in turns), the twin card vs CPU, and the attack
    CLI in process with --victim_dtype bfloat16 on phase 5's 40 clouds and
    phase 8's victims into build/chip_smoke/bf16_pp/."""
    import scipy.io as sio

    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main
    from geoa3_tpu_torch.models import bf16_grad_healthcheck, make_eval_fn
    from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    root = REPO / "build" / "chip_smoke"
    out = {}
    for arch, tag, ckpt in (("PointNetPP", "SSG", "victim_ssg.pt"),
                            ("PointNetPP_MSG", "MSG", "victim_msg.pt")):
        required = PP_BF16_PATH + (("sa_fused_fwd",) if tag == "MSG" else ())
        model, logits_fn = random_victim(arch, seed=0)
        grad_fn = make_eval_fn(model, dtype=torch.bfloat16)
        reset_launch_counts()
        healthy = bf16_grad_healthcheck(grad_fn, B, N, "cuda")
        hc = launch_counts()
        want = bf16_pp_launches(arch, 0, 1, batches=0, healthchecks=1)
        if not healthy or hc != want:
            _fail(f"the bf16 {tag} health check at [{B},{N},3]: healthy={healthy}, "
                  f"launches {hc}, expected {want}")
        pc, nrm, _ = make_batch(torch, B, N, seed=1)
        with torch.no_grad():
            gt = logits_fn(pc).argmax(-1)

        def run(cfg, seed, bf16):
            fn = make_attack_fn(grad_fn if bf16 else logits_fn, cfg,
                                eval_logits_fn=logits_fn if bf16 else None)
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return timed_attack(torch, fn, (pc, nrm, gt, gt, gen),
                                cfg.binary_max_steps * cfg.iter_max_steps)

        run(main_path_config(1, 10, arch=arch), 99, True)  # warm-up
        steps = 30
        cfg = main_path_config(1, steps, arch=arch)
        label = f"bf16 {tag} K=10"
        (res, ms_bf16), counts = paths.run(label, required,
                                           lambda: run(cfg, 0, True))
        check_result(torch, res, steps, label)
        want = bf16_pp_launches(arch, steps, cfg.curv_knn_refresh_every)
        if counts != want:
            _fail(f"the {label} attack launched {counts}, expected {want}")
        times = {"bf16": [ms_bf16], "float32": []}
        for bf16 in (False, False, True):  # bf16, f32, f32, bf16
            times["bf16" if bf16 else "float32"].append(run(cfg, 0, bf16)[1])
        print(f"  {label} attack: 1x{steps} steps, success "
              f"{int(res.success.sum())}/{B}, ms/step bf16 {times['bf16']} "
              f"float32 {times['float32']} (in turns: bf16, f32, f32, bf16; "
              "CUDA events); launches as read from the code")
        agreement = bf16_pp_cpu_agreement(torch, arch)

        per_class, cli_steps = 4, 10
        total = 10 * per_class
        argv = ["--attack", "GeoA3", "--attack_label", "Untarget", "--arch", arch,
                "--data_dir_file", f"synthetic:{per_class}:{N}", "-b", str(B),
                "--binary_max_steps", "1", "--iter_max_steps", str(cli_steps),
                "--checkpoint", str(root / ckpt), "--victim_dtype", "bfloat16",
                "--exps_root", str(root / "bf16_pp" / "Exps")]
        t0 = time.time()
        saved, cli_counts = paths.run(f"CLI bf16 {tag}", required,
                                      lambda: cli_main(build_parser().parse_args(argv)))
        torch.cuda.synchronize()
        secs = time.time() - t0
        batches = -(-total // B)
        want = bf16_pp_launches(arch, cli_steps, 10, batches, reevaluate=True,
                                healthchecks=1)
        if cli_counts != want:
            _fail(f"the bf16 {tag} CLI launched {cli_counts}, expected {want}")
        saved = Path(saved)
        mats = sorted(p.name for p in (saved / "Mat").iterdir())
        objs = sorted(p.name for p in (saved / "PC").iterdir())
        if not mats or [m[:-4] for m in mats] != [o[:-4] for o in objs]:
            _fail(f"bf16 {tag} CLI: Mat/ and PC/ do not hold the same instances")
        cloud = sio.loadmat(saved / "Mat" / mats[0])["adversary_point_clouds"]
        if cloud.shape != (3, N) or not np.isfinite(cloud).all():
            _fail(f"bf16 {tag} CLI: saved cloud has shape {cloud.shape} or is not finite")
        rate = float((saved / "attack_result.txt").read_text().strip()
                     .splitlines()[-1].split(":")[1])
        if abs(rate - 100.0 * len(mats) / total) > 0.01:
            _fail(f"bf16 {tag} CLI: attack_result.txt says {rate}% but {len(mats)} "
                  f"of {total} instances were saved")
        print(f"  CLI --arch {arch} --victim_dtype bfloat16: {total} clouds in "
              f"{batches} batches, 1x{cli_steps} steps, {len(mats)} saved "
              f"({rate:.2f}%), {secs:.1f} s, launches as read from the code (the "
              "health check's included)")
        out[tag] = dict(ms_per_step=times, success=int(res.success.sum()),
                        cpu_agreement=agreement, cli_saved=len(mats),
                        cli_seconds=secs)
    return out


def train_inputs(torch, arch: str, b: int):
    """(state_dict, clouds, targets, dropout keep masks) on the host: the
    weights of workload.random_victim (PointNet's T-Nets off the identity,
    so that they take gradients), as phase 11's card-vs-CPU step."""
    from geoa3_tpu_torch.workload import random_victim, synthetic_batch

    base, _ = random_victim(arch, seed=4, device="cpu")
    pc, _ = synthetic_batch(b, N, seed=21, device="cpu")
    g = torch.Generator().manual_seed(5)
    if arch == "PointNet":
        with torch.no_grad():
            for tnet in (base.input_transform, base.feature_transform):
                tnet.fc3.weight.copy_(0.01 * torch.randn(tnet.fc3.weight.shape,
                                                         generator=g))
        keep = (torch.rand(b, 512, generator=g) < 0.7,
                torch.rand(b, 256, generator=g) < 0.7)
    else:
        keep = torch.rand(b, 256, generator=g) < 0.5
    return base.state_dict(), pc, torch.arange(b) % 40, keep


def step_record(torch, model, loss) -> dict:
    """The loss, parameters, gradients and running statistics after a train
    step, in float64 on the host."""
    host = lambda t: t.detach().double().cpu()  # noqa: E731
    return dict(loss=float(loss),
                params={n: host(p) for n, p in model.named_parameters()},
                grads={n: host(p.grad) for n, p in model.named_parameters()},
                stats={n: host(t) for n, t in model.named_buffers()
                       if n.endswith(("running_mean", "running_var"))})


def single_train_step(torch, arch: str, inputs, reorder: bool = False
                      ) -> tuple[dict, dict]:
    """One train step of one process on the card -> (record, launches);
    with `reorder`, on the batch's rows in a seeded random order (the same
    step in other float32 reduction orders)."""
    from geoa3_tpu_torch import train as T
    from geoa3_tpu_torch.models import build_model
    from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    sd, pc, target, keep = inputs
    if reorder:
        perm = torch.randperm(len(pc), generator=torch.Generator().manual_seed(0))
        pc, target = pc[perm], target[perm]
        keep = tuple(k[perm] for k in keep) if isinstance(keep, tuple) else keep[perm]
    tcfg = T.TrainConfig(arch=arch, classes=40, npoint=N, batch_size=len(pc))
    model = build_model(arch, 40, N)
    model.load_state_dict(sd)
    state = T.TrainState(model.train(), T.make_optimizer(tcfg, model))
    keep = tuple(k.cuda() for k in keep) if isinstance(keep, tuple) else keep.cuda()
    reset_launch_counts()
    state, metrics = T.make_train_step(tcfg, 1)(state, pc.cuda(), target.cuda(),
                                                keep=keep)
    torch.cuda.synchronize()
    return step_record(torch, state.model, metrics["loss"]), launch_counts()


def sharded_train_step(torch, arch: str, inputs, mesh_shape) -> tuple[dict, dict]:
    """One train step of this rank of `parallel.make_sharded_train_step` on
    the global batch -> (record of its slices, launches)."""
    from geoa3_tpu_torch import parallel
    from geoa3_tpu_torch import train as T
    from geoa3_tpu_torch.models import build_model
    from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    sd, pc, target, keep = inputs
    tcfg = T.TrainConfig(arch=arch, classes=40, npoint=N, batch_size=len(pc))
    model = build_model(arch, 40, N)
    model.load_state_dict(sd)
    state = T.TrainState(model.train(), T.make_optimizer(tcfg, model))
    mesh = parallel.make_mesh(*mesh_shape)
    step, place = parallel.make_sharded_train_step(
        tcfg, mesh, tensor_parallel=mesh_shape[1] > 1)
    local = place(state)
    reset_launch_counts()
    local, metrics = step(local, pc, target, keep=keep)
    torch.cuda.synchronize()
    rec = step_record(torch, local.model, metrics["loss"])
    rec["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
    rec["moments"] = {n: tuple(local.optimizer.state[p]["exp_avg"].shape)
                      for n, p in local.model.named_parameters()}
    return rec, launch_counts()


TRAIN_TOLS = {"loss": 1e-5, "stats": 1e-5, "grad": 1e-4, "vanishing": 1e-4,
              "params": 1e-4}


def train_step_errors(torch, label: str, ref: dict, ranks: dict, lr: float) -> dict:
    """{kind: (largest error, tensor)} of a sharded step's ranks ({(data,
    model): record}) against one process's step, split tensors put back
    together from the model ranks: the loss (relative) on every rank; the
    running statistics (relative to the largest entry); each gradient by
    its Frobenius norm (relative), a vanishing one (as tests/
    test_torch_train.py names them) by its largest entry against 1e-2 of
    the model's largest gradient entry; the parameters after Adam's first
    step by the share of all their entries that moved other than in one
    process's step by more than 1e-2 of the step's size (lr): the first
    step is lr * sign(g), so an entry differs by 2 lr where its gradient's
    sign differs, or by float32's rounding of the parameter. Replicated
    tensors must be equal on every rank."""
    n_model = 1 + max(m for _, m in ranks)
    first = ranks[(0, 0)]

    def full(kind, name):
        parts = [ranks[(0, m)][kind][name] for m in range(n_model)]
        if parts[0].shape == ref[kind][name].shape:
            return parts[0]
        return torch.cat(parts)

    worst = dict.fromkeys(TRAIN_TOLS, (0.0, None))

    def note(kind, name, err):
        if err >= worst[kind][0]:
            worst[kind] = (err, name)

    for r in ranks.values():
        note("loss", "loss", abs(r["loss"] - ref["loss"]) / abs(ref["loss"]))
    for name, s_ref in ref["stats"].items():
        note("stats", name, ((first["stats"][name] - s_ref).abs().max()
                             / s_ref.abs().max()).item())
        if not all(torch.equal(r["stats"][name], first["stats"][name])
                   for r in ranks.values()):
            _fail(f"{label}: the ranks' {name} differ")
    gmax = max(g.abs().max().item() for g in ref["grads"].values())
    moved = entries = 0
    for name, g_ref in ref["grads"].items():
        g, p, p_ref = full("grads", name), full("params", name), ref["params"][name]
        if first["params"][name].shape == p_ref.shape and not all(
                torch.equal(r["params"][name], first["params"][name])
                for r in ranks.values()):
            _fail(f"{label}: the ranks' replicas of {name} differ")
        if _vanishing(name):
            note("vanishing", name, (g - g_ref).abs().max().item() / (1e-2 * gmax))
        else:
            note("grad", name, ((g - g_ref).norm() / g_ref.norm()).item())
        moved += int(((p - p_ref).abs() > 1e-2 * lr).sum())
        entries += p.numel()
    note("params", "share moved otherwise", moved / entries)
    return worst


def hold_train_step(torch, label: str, ref: dict, ranks: dict, yard: dict,
                    lr: float) -> dict:
    """A sharded step against one process's step on the card
    (`train_step_errors`), each kind of error held at its tolerance
    (TRAIN_TOLS) or at 4x the error of the same one-process step on the
    batch's rows reordered (`yard`: the same function, other float32
    reduction orders), whichever is larger: at b = 32 a float32 PointNet
    step is ill-conditioned (the heads' BatchNorms, a maximum or a ReLU
    within rounding of a switch; phase 11 finds the card's float32
    gradients 3e-3 from float64 and the CPU's 1e-2), so any change of
    reduction order moves single gradients by more than 1e-4."""
    got = train_step_errors(torch, label, ref, ranks, lr)
    noise = train_step_errors(torch, label + " (rows reordered)", ref,
                              {(0, 0): yard}, lr)
    limits = {k: max(TRAIN_TOLS[k], 4 * noise[k][0]) for k in TRAIN_TOLS}
    for kind, (err, name) in got.items():
        if not err <= limits[kind]:
            _fail(f"{label}: {kind} {name} err {err:.3e} > {limits[kind]:.3e} (the "
                  f"tolerance {TRAIN_TOLS[kind]:.0e}, or 4x the reordered step's "
                  f"{noise[kind][0]:.3e} at {noise[kind][1]})")
    return dict(rel_err={k: v[0] for k, v in got.items()},
                worst_tensor={k: v[1] for k, v in got.items()},
                reordered_rel_err={k: v[0] for k, v in noise.items()}, limits=limits)


def mgpu_rank(torch, rank: int) -> None:
    """One of phase 12(b)'s two ranks, both on the one card, over gloo: the
    attack CLI with --mesh_data_parallel, then MGPU_TRAIN's train steps;
    writes MGPU_DIR/out_<rank>.pt."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK="0")
    from geoa3_tpu_torch import parallel
    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main
    from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    parallel.init_distributed("gloo", "cuda", init_method=f"file://{MGPU_DIR}/store",
                              timeout=MGPU_TIMEOUT)
    inp = torch.load(MGPU_DIR / "inputs.pt", weights_only=False)
    root = MGPU_DIR / ("ranks" if rank == 0 else "rank1_must_stay_empty")
    reset_launch_counts()
    t0 = time.time()
    saved = cli_main(build_parser().parse_args(
        inp["cli_argv"] + ["--exps_root", str(root), "--mesh_data_parallel"]))
    torch.cuda.synchronize()
    out = {"cli": dict(saved=saved, launches=launch_counts(), seconds=time.time() - t0)}
    for name, (arch, mesh_shape) in MGPU_TRAIN.items():
        out[name] = sharded_train_step(torch, arch, inp["train"][arch], mesh_shape)
    torch.save(out, MGPU_DIR / f"out_{rank}.pt")
    torch.distributed.destroy_process_group()


def mgpu_inprocess(torch, paths, ms_step: float) -> dict:
    """Phase 12(a): a one-rank NCCL group in this process. The sharded
    attack on PointNet at full width against make_attack_fn at the same
    seed; one sharded train step of PointNet at b = 32 against the plain
    step; a NaN planted in a kernel's input caught by the guard of the
    launch path; and phase 3's step as a share of the card's float32 peak."""
    from geoa3_tpu_torch import make_attack_fn, parallel
    from geoa3_tpu_torch.ops.kernels import nn1_kernel
    from geoa3_tpu_torch.utils import flops
    from geoa3_tpu_torch.utils.profiling import debug_nans
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    t0 = time.time()
    parallel.init_distributed(device="cuda")  # no torchrun: a world of one
    if torch.distributed.get_backend() != "nccl" or torch.distributed.get_world_size() != 1:
        _fail("phase 12(a) expected a one-rank NCCL group")
    mesh = parallel.make_mesh()
    _, logits_fn = random_victim("PointNet", seed=0)
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    with torch.no_grad():
        # even rows the victim's label (not reached in 20 steps), odd rows
        # the synthetic shape's (reached at once)
        gt = torch.where(torch.arange(B, device="cuda") % 2 == 0,
                         logits_fn(pc).argmax(-1), synthetic_labels(torch))
    cfg = main_path_config(1, MGPU_STEPS)
    gen = lambda: torch.Generator(device="cuda").manual_seed(11)  # noqa: E731
    one = make_attack_fn(logits_fn, cfg)(pc, nrm, gt, gt, gen())
    want = pointnet_attack_launches(MGPU_STEPS, cfg.curv_knn_refresh_every)
    fn = parallel.make_sharded_attack_fn(logits_fn, cfg, mesh)
    res, counts = paths.run("sharded attack, one NCCL rank", tuple(_nonzero(want)),
                            lambda: fn(pc, nrm, gt, gt, gen()))
    _expect("sharded attack, one NCCL rank", counts, want)
    check_result(torch, res, MGPU_STEPS, "sharded attack")
    errs = attack_agreement(torch, "sharded attack, one NCCL rank", res, one)

    inputs = train_inputs(torch, "PointNet", B)
    ref, c_ref = single_train_step(torch, "PointNet", inputs)
    yard, _ = single_train_step(torch, "PointNet", inputs, reorder=True)
    rec, c_rec = sharded_train_step(torch, "PointNet", inputs, (1, 1))
    _expect("sharded train step, one NCCL rank", c_rec, c_ref)
    train_err = hold_train_step(torch, "sharded train step, one NCCL rank", ref,
                                {rec["coords"]: rec}, yard, 1e-3)

    adv, ori = pc[:2, :64].contiguous(), pc[:2, 64:128].contiguous()
    payload = torch.zeros(2, 8, 64, device="cuda")
    # once unguarded, so that the guarded call's outputs reuse these blocks,
    # which hold no NaN; then a NaN planted before the guard
    nn1_kernel.nn1_dual_payload(adv, ori, payload)
    payload[:, 3] = float("nan")
    caught = None
    with debug_nans(True):
        try:
            nn1_kernel.nn1_dual_payload(adv, ori, payload)
        except FloatingPointError as e:
            caught = str(e)
    if caught is None:
        _fail("debug_nans let a kernel's NaN output through the launch path")
    torch.distributed.destroy_process_group()
    secs = time.time() - t0
    mfu = flops.mfu(ms_step, B, N, K)
    print(f"  sharded attack, one NCCL rank, 1x{MGPU_STEPS} steps against "
          f"make_attack_fn: {errs}")
    print(f"  sharded train step, one NCCL rank, PointNet b={B} against the "
          f"plain step: {train_err}")
    print(f"  debug_nans on the card: {caught}")
    print(f"  phase 3's step ({ms_step:.4f} ms, b={B}, n={N}) as a share of the "
          f"float32 peak: {mfu}")
    print(f"  phase 12(a) seconds: {secs:.2f}")
    return dict(attack=errs, train=train_err, nan_guard=caught, mfu=mfu, seconds=secs)


def attack_agreement(torch, label: str, got, want) -> dict:
    """A sharded attack's result against one process's on the card: success
    and the best steps equal; the clouds within 1e-4 (tests/test_parallel.
    py's tolerance) and the loss trajectory within 1e-3 mean relative
    (phase 3's card-vs-CPU tolerance): float atomics in the kernels vary in
    the last bits from run to run, and Adam carries them."""
    for name in ("success", "best_attack_step", "best_attack_bs_idx"):
        if not torch.equal(getattr(got, name), getattr(want, name)):
            _fail(f"{label}: {name} differs from one process's")
    err = (got.best_attack - want.best_attack).abs().max().item()
    rel = ((got.all_loss - want.all_loss).abs().mean()
           / want.all_loss.abs().mean()).item()
    if not (err <= 1e-4 and rel <= 1e-3):
        _fail(f"{label}: best_attack err {err:.3e} (tol 1e-4), all_loss mean rel "
              f"{rel:.3e} (tol 1e-3)")
    return dict(best_attack_max_abs_err=err, all_loss_mean_rel_err=rel,
                success=int(got.success.sum()))


def mgpu_two_ranks(torch, paths) -> dict:
    """Phase 12(b): two ranks sharing the one card over gloo (NCCL refuses
    two ranks on one device), spawned with a FileStore under MGPU_DIR and a
    time limit: the attack CLI with --mesh_data_parallel on phase 5's 40
    clouds against one process's CLI, and one train step each of PointNet
    at data 2 and at data 1 x model 2 and of PointNet++ SSG at data 2
    against one process's step, with each rank's exact launches."""
    import os
    import shutil

    import scipy.io as sio

    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main

    t0 = time.time()
    shutil.rmtree(MGPU_DIR, ignore_errors=True)
    MGPU_DIR.mkdir(parents=True)
    argv = ["--attack", "GeoA3", "--attack_label", "Untarget",
            "--data_dir_file", f"synthetic:4:{N}", "-b", str(MGPU_CLI_B),
            "--binary_max_steps", "1", "--iter_max_steps", str(MGPU_STEPS),
            "--checkpoint", str(REPO / "build" / "chip_smoke" / "victim.pt")]
    train = {arch: train_inputs(torch, arch, B) for arch in ("PointNet", "PointNetPP")}
    torch.save({"cli_argv": argv, "train": train}, MGPU_DIR / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(CODE))
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--rank",
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]

    # one process's runs, on the card beside the ranks
    want_cli = pointnet_attack_launches(MGPU_STEPS, 10, reevaluate=True)
    single, c_single = paths.run(
        "CLI, one process, -b 40", tuple(_nonzero(want_cli)),
        lambda: cli_main(build_parser().parse_args(
            argv + ["--exps_root", str(MGPU_DIR / "single")])))
    _expect("CLI, one process, -b 40", c_single, want_cli)
    refs = {arch: single_train_step(torch, arch, train[arch]) for arch in train}
    yards = {arch: single_train_step(torch, arch, train[arch], reorder=True)[0]
             for arch in train}
    for arch, (_, c) in refs.items():
        _expect(f"train step {arch}, one process", c, train_launches(arch)[0])

    logs = []
    deadline = time.time() + MGPU_TIMEOUT
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    except subprocess.TimeoutExpired:
        _fail(f"a phase 12 rank outlasted {MGPU_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            _fail(f"phase 12 rank {r} exited {p.returncode}:\n{log.decode()[-4000:]}")
    outs = [torch.load(MGPU_DIR / f"out_{r}.pt", weights_only=False) for r in range(2)]

    # the CLI: rank 0 writes one process's Mat/ names, rank 1 nothing
    if (MGPU_DIR / "rank1_must_stay_empty").exists():
        _fail("rank 1 of the sharded CLI wrote into its experiment root")
    for r, out in enumerate(outs):
        _expect(f"sharded CLI rank {r}", out["cli"]["launches"], want_cli)
    sharded = Path(outs[0]["cli"]["saved"])
    mats = sorted(p.name for p in (Path(single) / "Mat").iterdir())
    if not mats or sorted(p.name for p in (sharded / "Mat").iterdir()) != mats:
        _fail("the sharded CLI's Mat/ names differ from one process's")
    cli_err = max(float(np.abs(
        sio.loadmat(sharded / "Mat" / f)["adversary_point_clouds"]
        - sio.loadmat(Path(single) / "Mat" / f)["adversary_point_clouds"]).max())
        for f in mats)
    if not cli_err <= 1e-4:
        _fail(f"the sharded CLI's clouds differ from one process's by {cli_err:.3e}")
    for f in ("attack_result.txt", "batches_done.txt"):
        if (sharded / f).read_text() != (Path(single) / f).read_text():
            _fail(f"the sharded CLI's {f} differs from one process's")
    print(f"  CLI --mesh_data_parallel, 2 ranks x 20 rows: {len(mats)} Mat/ files "
          f"as one process's, clouds max abs err {cli_err:.3e} (tol 1e-4), rank 1 "
          f"wrote nothing; {outs[0]['cli']['seconds']:.2f} s on rank 0")

    train_errs = {}
    for name, (arch, mesh_shape) in MGPU_TRAIN.items():
        ranks = {}
        for r, out in enumerate(outs):
            rec, counts = out[name]
            _expect(f"{name} rank {r}", counts, train_launches(arch)[0])
            ranks[rec["coords"]] = rec
        train_errs[name] = hold_train_step(torch, name, refs[arch][0], ranks,
                                           yards[arch], 1e-3)
        if mesh_shape[1] > 1:
            for rec in ranks.values():
                if (rec["params"]["conv5.weight"].shape != (512, 128, 3)
                        or rec["moments"]["conv5.weight"] != (512, 128, 3)):
                    _fail(f"{name}: conv5 is not 512 rows a rank with its moments")
        print(f"  {name}: loss {ranks[(0, 0)]['loss']:.6f}; against one process "
              f"{train_errs[name]}")
    secs = time.time() - t0
    print(f"  phase 12(b) seconds: {secs:.2f}")
    return dict(cli=dict(mats=len(mats), max_abs_err=cli_err), train=train_errs,
                seconds=secs)


def step_times_phase(torch) -> dict:
    """`--times step`: the checkout's attack step on the three victims, as
    phases 3, 6 and 8 drive it (b=32, n=1024, K=10; PointNet 1x50 steps,
    SSG and MSG 1x30), ms a step by CUDA events over the whole attack,
    three runs each after a warm-up, with no check run. The step is
    host-bound, so this times the host code of the whole path."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.ops.kernels import _build
    from geoa3_tpu_torch.workload import main_path_config, random_victim

    print(f"attack step times of {CODE}")
    _build.lib()
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    out = {}
    for arch, steps in (("PointNet", 50), ("PointNetPP", 30), ("PointNetPP_MSG", 30)):
        _, logits_fn = random_victim(arch, seed=0)
        with torch.no_grad():
            gt = logits_fn(pc).argmax(-1)

        def run(cfg, seed):
            gen = torch.Generator(device="cuda").manual_seed(seed)
            return timed_attack(torch, make_attack_fn(logits_fn, cfg),
                                (pc, nrm, gt, gt, gen), cfg.iter_max_steps)[1]

        run(main_path_config(1, 10, arch=arch), 99)  # warm-up
        cfg = main_path_config(1, steps, arch=arch)
        out[arch] = [run(cfg, 0) for _ in range(3)]
        print(f"  {arch}: ms/step {out[arch]}", flush=True)
    return out


# `--times ROW`: the rows with a timing mode, each phase building the
# kernels itself and timing them at the row's path shapes; `step`, the
# attack step of the three victims
TIMES = {"6": pool_times_phase, "8": kappa_times_phase, "12": fps_times_phase,
         "13": scatter_times_phase,
         "15": ballquery_times_phase, "16": group_mlp_times_phase,
         "17": sa_fused_times_phase, "step": step_times_phase}


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (a short check of a new kernel)")
    ap.add_argument("--times", metavar="ROW", choices=sorted(TIMES),
                    help="only build the kernels and time row ROW's kernels "
                         f"({', '.join(sorted(TIMES))}) at its path shapes "
                         "(step: the three victims' attack step), no check")
    ap.add_argument("--tree", metavar="DIR",
                    help="with --times: the checkout whose kernels run (e.g. "
                         "a `git archive` of another commit)")
    ap.add_argument("--rank", type=int, choices=(0, 1),
                    help="run as that rank of phase 12's two (started by phase 12)")
    args = ap.parse_args()
    if args.tree and not args.times:
        _fail("--tree goes with --times")

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.rank is not None:
        mgpu_rank(torch, args.rank)
        return 0
    global PEAK_F32_FLOPS
    PEAK_F32_FLOPS = card_peak_flops()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    if args.times:
        print(json.dumps({"card": smi, "tree": str(CODE), "row": args.times,
                          "shapes": TIMES[args.times](torch)}))
        return 0

    from geoa3_tpu_torch.ops.kernels import _build

    t0 = time.time()
    so = _build.lib()
    print(f"phase 1: built {so} in {time.time() - t0:.1f} s")

    def phase(title):
        print(f"{title} (at {time.time() - t0:.1f} s)")

    phase("phase 2: kernels against their plain versions")
    kernels = kernel_checks(torch) + ssg_kernel_checks(torch)
    kernels += msg_kernel_checks(torch, kernels)
    kernels += group_mlp_bf16_checks(torch)
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

    phase("phase 10: defense, smoothness and the attack-set tools on the card")
    tools = defense_tools_phase(torch, paths, Path(cli["dir"]))

    phase("phase 11: victim training on the card")
    trained = train_phase(torch, paths, tools["gen_data_mat"]["path"], smi)

    phase("phase 12: multi-GPU: a one-rank NCCL group in process, then two "
          "ranks sharing the card over gloo")
    mgpu = mgpu_inprocess(torch, paths, run["ms_step"])
    mgpu.update(mgpu_two_ranks(torch, paths))

    phase("phase 13: the bf16 PointNet victim at full width")
    bf16 = bf16_victim_phase(torch, paths)

    phase("phase 14: the bf16 PointNet++ victims at full width")
    bf16_pp = bf16_pointnetpp_phase(torch, paths)

    phase("phase 15: the result")
    paths.check_union()
    for k in kernels:
        k["launches"], k["launches_by_path"] = paths.launches(k["name"])

    print(json.dumps({
        "attack": {"ms_per_step_k10": run["ms_step"],
                   "ms_per_step_exact": run["ms_step_exact"],
                   "launches_exact": run["counts_exact"],
                   "success": run["success"], "batch": B, "card": smi},
        "side_modes": side, "cli": cli, "ssg": ssg, "msg": msg,
        "subsample_uniform": sub, "dense": dense, "defense_tools": tools,
        "train": trained, "multi_gpu": mgpu, "bf16": bf16, "bf16_pointnetpp": bf16_pp,
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
