"""Where an attack step, or a victim's train step, spends its time on the card.

    python -m geoa3_tpu_torch.profile_step [--steps 20] [--refresh 10]
        [--arch PointNet|PointNetPP|PointNetPP_MSG] [--train]
        [--victim_dtype float32|bfloat16]

Runs the default attack (geoa3_tpu_torch/workload.py, b=32, n=1024) on the
victim `--arch` for one binary step of `--steps` Adam steps (with
`--victim_dtype bfloat16` the gradient pass through the bf16 twin and the
float32 victim judging each step, as the attack CLI runs it),
or with
`--train` `--steps` train steps of the victim (train.py, b=32, synthetic
clouds, the trainer's initial weights and dropout), under torch.profiler
after a warm-up, and prints the step time (CUDA events), the device's busy
and idle shares,
the time by group (the port's kernels, matrix products, the rest), the top
kernels by device time and the top host-side ops by self CPU time. The last
line is a JSON summary. Needs a CUDA card; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from geoa3_tpu_torch import make_attack_fn
from geoa3_tpu_torch import train as T
from geoa3_tpu_torch.models import make_eval_fn
from geoa3_tpu_torch.workload import (
    BATCH,
    main_path_config,
    random_victim,
    synthetic_batch,
)

# kernel-name pattern -> group
_GROUPS = [
    (re.compile(r"pool_fwd_bf16_kernel"), "pool_fwd_bf16 (port)"),
    (re.compile(r"gmlp_bf16_fwd_(tiles|finish|resident|wgmma)"), "group_mlp_fwd_bf16 (port)"),
    (re.compile(r"gmlp_bf16_bwd_(tiles|resident|wgmma)"), "group_mlp_bwd_bf16 (port)"),
    (re.compile(r"pool_bwd_gather.*GatherBf16"), "pool_bwd_bf16 (port)"),
    (re.compile(r"pool_fwd_kernel"), "pool_fwd (port)"),
    (re.compile(r"pool_bwd_gather.*GatherF32"), "pool_bwd (port)"),
    (re.compile(r"nn1_(tile|finish)_kernel"), "nn1_payload (port)"),
    (re.compile(r"curv_term_kernel"), "curv_term (port)"),
    (re.compile(r"kappa_select_kernel"), "kappa select (port)"),
    (re.compile(r"scatter3_(global_)?kernel"), "scatter_add_3t (port)"),
    (re.compile(r"fps_rounds"), "fps (port)"),
    (re.compile(r"ballquery_fwd"), "ballquery_group fwd (port)"),
    (re.compile(r"ballquery_bwd"), "ballquery_group bwd (port)"),
    (re.compile(r"scatter_nc_rows"), "scatter_add_nc (port)"),
    (re.compile(r"group_mlp_fwd_(tiles|finish)"), "group_mlp_fwd (port)"),
    (re.compile(r"group_mlp_bwd_tiles"), "group_mlp_bwd (port)"),
    (re.compile(r"kappa_bwd_stream_kernel"), "kappa_bwd (port)"),
    (re.compile(r"kappa_frommask_stream_kernel"), "kappa_frommask (port)"),
    (re.compile(r"sa_(query_kernel|fwd_tiles|fwd_finish)"),
     "sa_fused_fwd query + MLP + pool (port)"),
    (re.compile(r"sa_bwd_tiles"), "sa_fused_bwd recompute+scatter (port)"),
    (re.compile(r"backproject_kernel"), "sa_fused_bwd back-projection (port)"),
    (re.compile(r"project_kernel"), "sa_fused_fwd projection (port)"),
    (re.compile(r"gemm|sgemm|xmma|cutlass|cublas", re.I), "matrix products"),
    (re.compile(r"reduce|Reduce"), "reductions"),
    (re.compile(r"elementwise|vectorized|unrolled", re.I), "elementwise"),
    (re.compile(r"[Mm]emset|[Mm]emcpy|fill"), "fill/copy"),
]


def _group(name: str) -> str:
    for pat, g in _GROUPS:
        if pat.search(name):
            return g
    return "other"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _attack_window(args):
    """The attack's `--steps` steps, after a warm-up block."""
    model, logits_fn = random_victim(args.arch, seed=0)
    pc, nrm = synthetic_batch(seed=1)
    with torch.no_grad():
        gt = logits_fn(pc).argmax(-1)
    grad_fn, judge = logits_fn, None
    if args.victim_dtype == "bfloat16":
        grad_fn, judge = make_eval_fn(model, dtype=torch.bfloat16), logits_fn
    warm = make_attack_fn(grad_fn, main_path_config(
        1, args.refresh, args.refresh, arch=args.arch), eval_logits_fn=judge)
    warm(pc, nrm, gt, gt, torch.Generator(device="cuda").manual_seed(9))
    fn = make_attack_fn(grad_fn, main_path_config(
        1, args.steps, args.refresh, arch=args.arch), eval_logits_fn=judge)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return lambda: fn(pc, nrm, gt, gt, gen)


def _train_window(args):
    """`--steps` train steps of the victim on one synthetic batch, after
    three warm-up steps."""
    cfg = T.TrainConfig(arch=args.arch, batch_size=BATCH)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = T.init_state(cfg, gen)
    step = T.make_train_step(cfg)
    pc, _ = synthetic_batch(seed=1)
    target = torch.arange(BATCH, device="cuda") % cfg.classes

    def run(n):
        for _ in range(n):
            step(state, pc, target, gen)

    run(3)
    return lambda: run(args.steps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--refresh", type=int, default=10)
    ap.add_argument("--arch", default="PointNet",
                    choices=("PointNet", "PointNetPP", "PointNetPP_MSG"))
    ap.add_argument("--train", action="store_true",
                    help="profile the victim's train steps instead")
    ap.add_argument("--victim_dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="the attack's gradient pass in bf16")
    args = ap.parse_args()
    if args.victim_dtype == "bfloat16" and args.train:
        raise SystemExit("profile_step: --victim_dtype bfloat16 profiles the "
                         "attack only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")

    window = _train_window(args) if args.train else _attack_window(args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        window()
        end.record()
        end.synchronize()
    wall_ms = start.elapsed_time(end)
    per_step = wall_ms / args.steps

    kernels = defaultdict(lambda: [0.0, 0])
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.key][0] += us
            kernels[evt.key][1] += evt.count
    busy_ms = sum(v[0] for v in kernels.values()) / 1e3
    groups = defaultdict(float)
    for name, (us, _) in kernels.items():
        groups[_group(name)] += us / 1e3 / args.steps

    what = "train steps" if args.train else (
        f"attack steps, K={args.refresh}, {args.victim_dtype} gradient pass")
    print(f"ms/step {per_step:.4f} (CUDA events, {args.steps} {what}, "
          f"b={BATCH}, {args.arch}); device busy "
          f"{busy_ms / args.steps:.4f} ms/step = {busy_ms / wall_ms:.3f} of "
          f"the wall time (idle {1 - busy_ms / wall_ms:.3f})")
    print("by group (ms/step):")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.4f}  {g}")
    print("top kernels (ms/step, launches/step):")
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    for name, (us, cnt) in top:
        print(f"  {us / 1e3 / args.steps:9.4f}  {cnt / args.steps:6.2f}  {name[:110]}")
    host = sorted(
        (e for e in prof.key_averages() if e.self_cpu_time_total > 0),
        key=lambda e: -e.self_cpu_time_total,
    )
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3 / args.steps
    launch_calls = {e.key: e.count / args.steps for e in host
                    if e.key.startswith("cudaLaunch")}
    device_kernels = sum(v[1] for v in kernels.values()) / args.steps
    print(f"launch calls a step {launch_calls}; device kernels and copies "
          f"{device_kernels:.2f}/step")
    print(f"host: {host_ms:.4f} ms/step of self CPU time in profiled ops "
          f"(profiler overhead included); top ops (ms/step, calls/step):")
    for e in host[:15]:
        print(f"  {e.self_cpu_time_total / 1e3 / args.steps:9.4f}  "
              f"{e.count / args.steps:6.2f}  {e.key[:90]}")
    print(json.dumps({
        "ms_per_step": per_step, "device_busy_ms_per_step": busy_ms / args.steps,
        "idle_share": 1 - busy_ms / wall_ms, "host_self_cpu_ms_per_step": host_ms,
        "launch_calls_per_step": launch_calls,
        "device_kernels_per_step": device_kernels,
        "groups_ms_per_step": dict(groups), "steps": args.steps,
        "refresh": args.refresh, "batch": BATCH, "arch": args.arch,
        "train": args.train, "victim_dtype": args.victim_dtype,
        "card": torch.cuda.get_device_name(0),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
