"""One run of one cell of the benchmark of geoa3_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (import, the kernel library loaded from
build/kernels/ or built there on a checkout's first run, the victim's
weights made on the card from the seed, the traffic's pool of batches, a
warm-up of the cell's own shapes) is timed from the process's start; then
whole batches run back to back for at least --seconds seconds; the rate is
taken over all the steps and all the time of those batches. With --trace 1
one whole batch inside the window runs under torch.profiler and the cell's
per-layer metrics are read from that trace. After the window the program's
state is freed and a plain reference checks the sampled batch: each number
compared is printed beside its limit, as the last lines of standard error
and under "checks" in the result. The last line of standard output is the
result: {"correct", "attempted", "failed", "metrics", "device"[,
"breakdown"], "checks"}.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

# no module of these top-level names may be loaded by the run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "geoa3_tpu")
PROGRAM = "geoa3_tpu_torch"


def process_age() -> float:
    """Seconds since this process started (from /proc), or since the module
    was loaded where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_note() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi gave nothing"


def fail(msg: str, code: int):
    print(f"benchmark.run: {msg}", file=sys.stderr)
    raise SystemExit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (spec.ROOT / PROGRAM / "__init__.py").exists():
        fail(f"the program under test ({PROGRAM}/) is not in {spec.ROOT}", 2)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    os.environ["USE_FLAX"] = "0"
    cache = spec.ROOT / "build" / "bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))

    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 3)
    print(f"card: {card_note()}", file=sys.stderr)
    result = measure(cell, bench, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        fail(f"modules of forbidden top-level names were loaded: {', '.join(bad)}", 4)
    print(json.dumps(result))
    return 0


def measure(cell: dict, bench: dict, seed: int, seconds: float, traced: bool,
            device: str) -> dict:
    """Set-up, the window, the traced reading and the check of one run ->
    the result (on "cpu" a test's run: no trace, no card)."""
    import torch

    from benchmark import check, flops, plugins, trace

    name = cell["name"]
    cuda = device != "cpu"
    driver_mod = importlib.import_module(f"benchmark.traffic.{cell['traffic']['driver']}")
    drv = driver_mod.Driver(cell, seed, device)
    drv.sync()
    setup_s = process_age()

    settings = cell["settings"]
    sample = seed % settings["sample_batches"]
    # the traced batch is never the sampled one, whose recording it would count
    trace_at = sample + 1 if traced else -1
    prof = None
    steps = batches = traced_steps = 0
    start = time.perf_counter()
    while True:
        if batches == trace_at:
            prof = trace.profiler()
            with prof:
                with trace.span():
                    drv.run_batch(batches, record=batches == sample)
            traced_steps = drv.steps_per_batch
        else:
            drv.run_batch(batches, record=batches == sample)
        steps += drv.steps_per_batch
        batches += 1
        now = time.perf_counter()
        if now - start >= seconds and batches > max(sample, trace_at):
            break
    window_s = now - start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    card = torch.cuda.get_device_name(0) if cuda else "cpu"

    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                   "count": cell["workload"].get("chips", 1),
                   "memory_peak_bytes": int(peak)}
    extra = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if traced:
        summary = trace.summarize(prof, traced_steps)
        prof = None
        ctx = dict(summary=summary, layout=drv.layout(), step_flops=drv.step_flops(),
                   peaks=flops.peaks(card), groups=plugins.groups())
        ctx["by_group"] = plugins.classify(summary, ctx["groups"])
        for m in spec.metrics_for(name, bench, "per_layer"):
            mod = plugins.reader(m["name"])
            value = mod.read(ctx) if mod is not None else None
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        extra["breakdown"] = trace.breakdown(summary)
    else:
        rates = drv.rate(steps, window_s)
        rates["setup_s"] = setup_s
        for m in spec.metrics_for(name, bench, "end_to_end"):
            metrics[m["name"]] = {"value": rates[m["name"]], "unit": units[m["name"]]}

    drv.free()
    t_check = time.perf_counter()
    gaps = drv.check(settings)
    nums = check.numbers(gaps, settings)
    print(f"window: {batches} batches, {steps} steps, {window_s:.3f} s; set-up "
          f"{setup_s:.3f} s; check {time.perf_counter() - t_check:.3f} s; peak "
          f"{peak} bytes", file=sys.stderr)
    for n, v, lim in nums:
        print(f"check {n}: {v!r} (limit {lim!r}) {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    return {"correct": check.passed(nums), "attempted": batches * drv.clouds_per_batch(),
            "failed": check.failed_items(gaps, settings), "metrics": metrics,
            "device": device_info, **extra,
            "checks": {n: {"value": v if math.isfinite(v) else str(v), "limit": lim}
                       for n, v, lim in nums}}


if __name__ == "__main__":
    raise SystemExit(main())
