"""The per-layer readers (metrics/<metric>.py) and the kernel groups
(roofline/<group>.py), found by name. A later change adds a metric or a
group by adding a file."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(path: Path):
    mod_name = "benchmark._plugin_" + re.sub(r"\W", "_", str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module whose `read(ctx)` gives `metric`, or None where the
    metric has no reader."""
    path = HERE / "metrics" / f"{metric}.py"
    return load(path) if path.exists() else None


def groups() -> list:
    """The kernel groups, each a module with PATTERN (a compiled regex on
    device operation names), LAYER, PORT (a kernel of the program's own)
    and `bound_s(layout, flops_per_s, bytes_per_s)`: the least seconds a
    step's launches of the group could take at the cell's shapes, or None
    where the group has no bound. A device operation belongs to the first
    group, in (ORDER, file name) order, whose pattern it matches."""
    mods = [load(p) for p in sorted((HERE / "roofline").glob("*.py"))]
    for m in mods:
        m.PATTERN = re.compile(m.PATTERN)
    return sorted(mods, key=lambda m: (m.ORDER, m.NAME))


def classify(summary: dict, group_list: list) -> dict:
    """{group name: (device seconds, launches)} of the traced window, with
    "other" for operations that match no group."""
    out = {}
    for name, (secs, count) in summary["kernels"].items():
        g = next((m.NAME for m in group_list if m.PATTERN.search(name)), "other")
        s, c = out.get(g, (0.0, 0))
        out[g] = (s + secs, c + count)
    return out
