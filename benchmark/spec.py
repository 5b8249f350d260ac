"""What a cell is made of, found by name: `BENCHMARK.json` at the root of
the checkout names the cell's configuration and traffic; the configuration
is `configs/<name>.json` (its `file`), the traffic `traffic/<name>.json`,
whose `driver` names the module in `traffic/` that runs it, and the cell's
own settings (the sample its check reads, the limits of the numbers it
compares) are `workloads/<cell>.json`."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict = None) -> dict:
    """{"name", "workload", "config", "traffic", "settings"} of a cell."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return {
        "name": name,
        "workload": w,
        "config": load_json(ROOT / configs[w["config"]]["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "settings": load_json(HERE / "workloads" / f"{name}.json"),
    }


def metrics_for(name: str, bench: dict, kind: str) -> list:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list the cell, or list no cells and move (or are) a metric the
    cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in names else [])]
