#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (geoa3_tpu_torch) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and this repository around the script. Phases:

  1. print the card's name and power limit; build the CUDA kernels (timed);
  2. hold every kernel of the main path against its plain PyTorch version at
     the main path's shapes (b=32, n=m=1024, k=16; PointNet's pools at
     [32, 1024, 128] -> 1024), with the tolerance stated, and time both (CUDA
     events, warm, median of 20), plus one PyTorch library call where one
     computes the same function;
  3. run the default untargeted GeoA3 attack on PointNet (40 classes, 1024
     points, random weights with non-trivial BatchNorm statistics, 32
     synthetic clouds; CE + Chamfer + 0.1 Hausdorff + curvature k=16, Adam
     lr 0.01) for 2 binary steps x 50 Adam steps with the mask rebuilt every
     10 steps, count every kernel's launches, check the result, and time it;
     then 20 steps of exact mode (mask rebuilt every step), counted the same
     way, with one selection and one curvature launch per step; and hold a short
     attack on the card against the same attack on the CPU (plain versions);
  4. print one JSON line listing the kernels, then the result line.

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


def attack_phase(torch) -> dict:
    """Phase 3: the default attack end to end on the card."""
    from geoa3_tpu_torch import make_attack_fn
    from geoa3_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from geoa3_tpu_torch.workload import main_path_config, random_pointnet

    model, logits_fn = random_pointnet(seed=0)
    pc, nrm, _ = make_batch(torch, B, N, seed=1)
    with torch.no_grad():
        gt = logits_fn(pc).argmax(-1)

    def run(cfg, seed):
        fn = make_attack_fn(logits_fn, cfg)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        res = fn(pc, nrm, gt, gt, gen)
        e.record()
        e.synchronize()
        steps = cfg.binary_max_steps * cfg.iter_max_steps
        return res, s.elapsed_time(e) / steps

    run(main_path_config(1, 10), 99)  # warm-up

    def counted_run(cfg, seed, label):
        reset_launch_counts()
        res, ms = run(cfg, seed)
        counts = launch_counts()
        print(f"  {label} launches: {counts}")
        missing = [k for k, v in counts.items() if v == 0]
        if missing:
            _fail(f"kernels not launched in the {label} run: {missing}")
        return res, ms, counts

    cfg = main_path_config(2, 50)
    res, ms_step, counts = counted_run(cfg, 0, "K=10")
    for name, t in res._asdict().items():
        if t.is_floating_point() and name != "best_loss" and not torch.isfinite(t).all():
            _fail(f"attack result {name} is not finite")
    if res.best_attack.shape != (B, N, 3) or res.all_loss.shape != (50, B):
        _fail("attack result has the wrong shape")
    n_succ = int(res.success.sum())
    print(f"  K=10 attack: {cfg.binary_max_steps}x{cfg.iter_max_steps} steps, "
          f"{ms_step:.4f} ms/step (CUDA events), success {n_succ}/{B}")

    cfg1 = main_path_config(1, 20, refresh=1)
    res1, ms_step1, counts1 = counted_run(cfg1, 1, "K=1")
    # exact mode: a fresh mask on every step, and the term read from it
    if not counts1["kappa_selmask"] == counts1["curv_term"] == 20:
        _fail("exact mode did not rebuild the mask and read it on each of its "
              f"20 steps: {counts1}")
    if not torch.isfinite(res1.all_loss).all():
        _fail("exact-mode losses are not finite")
    print(f"  K=1 (exact) attack: 1x20 steps, {ms_step1:.4f} ms/step "
          f"(CUDA events), success {int(res1.success.sum())}/{B}")
    return dict(counts=counts, counts_exact=counts1, ms_step=ms_step,
                ms_step_exact=ms_step1, success=n_succ)


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
    import torch

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

    print("phase 3: default attack on the card")
    run = attack_phase(torch)
    for k in kernels:
        k["launches"] = run["counts"][k["name"]]
    cpu_agreement(torch)

    print(json.dumps({
        "attack": {"ms_per_step_k10": run["ms_step"],
                   "ms_per_step_exact": run["ms_step_exact"],
                   "launches_exact": run["counts_exact"],
                   "success": run["success"], "batch": B, "card": smi},
    }))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
