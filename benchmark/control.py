"""The readings a cell's limits are set from, on the card at the cell's own
size, in one process:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out FILE]

For each of --seeds, the program runs the sampled batch as a benchmark run
does (set-up from the seed, the batch through the timed entry, the reference
following it): the sound runs, whose largest reading of each number is its
lower reading. For each of --control-seeds, the control takes the program's
place: the plain reference's own attack on the same batch in the nearest
precision below the configuration's (float32 with TF32 on, for float32 with
TF32 off), judged by the same float64 reference; its smallest reading of a
number is that number's upper reading. For each of --fault-seeds (a train
cell), a planted fault takes the program's place: the reference's steps
with the loss over half of the batch. Prints one JSON line a run, with
statistics of every gap, and a summary; writes them to --out as well.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from benchmark import check, spec


def _driver(cell, seed):
    mod = importlib.import_module(f"benchmark.traffic.{cell['traffic']['driver']}")
    return mod.Driver(cell, seed, "cuda")


def _program(cell, seed, settings):
    drv = _driver(cell, seed)
    drv.run_batch(seed % settings["sample_batches"], record=True)
    drv.free()
    return _read(drv, settings)


def _stand_in(cell, seed, settings, kind):
    """The control ("control") or the planted fault ("fault") in the
    program's place."""
    drv = _driver(cell, seed)
    getattr(drv, kind)(seed % settings["sample_batches"])
    drv.free()
    return _read(drv, settings)


def _read(drv, settings):
    """(numbers, statistics of each gap: its largest, quantiles, median and
    first entries; for a gap of [steps, clouds], the largest over clouds of
    each cloud's median over the steps, and the largest over steps of each
    step's median over the clouds)."""
    gaps = drv.check(settings)
    detail = {}
    for name, g in gaps.items():
        g = g.detach().double()
        f = g.flatten()
        d = {"max": float(f.max()), "q0.99": float(torch.quantile(f, 0.99)),
             "q0.9": float(torch.quantile(f, 0.9)), "median": float(f.median()),
             "first": float(f[0])}
        if g.dim() == 2:
            d["cloud_median_max"] = float(g.median(0).values.max())
            d["step_median_max"] = float(g.median(1).values.max())
        detail[name] = d
    return check.numbers(gaps, settings), detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    settings = cell["settings"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    lines = []

    def emit(kind, seed, read):
        nums, detail = read
        line = {"kind": kind, "seed": seed, "numbers": {n: v for n, v, _ in nums},
                "gaps": detail}
        print(json.dumps(line), flush=True)
        lines.append(line)

    fseeds = [int(s) for s in args.fault_seeds.split(",") if s]
    for s in seeds:
        emit("program", s, _program(cell, s, settings))
    for s in cseeds:
        emit("control", s, _stand_in(cell, s, settings, "control"))
    for s in fseeds:
        emit("fault", s, _stand_in(cell, s, settings, "fault"))
    names = list(settings["limits"])
    summary = {"workload": args.workload, "limits": settings["limits"]}
    for kind, how in (("program", max), ("control", min), ("fault", min)):
        got = [ln["numbers"] for ln in lines if ln["kind"] == kind]
        if got:
            summary[f"{kind}_{how.__name__}"] = {n: how(g[n] for g in got) for n in names}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            for ln in lines + [summary]:
                f.write(json.dumps(ln) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
