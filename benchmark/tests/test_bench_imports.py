"""No module of the harness imports JAX, its libraries or the JAX package
(top-level names compared whole: the program's name begins with the JAX
package's), and the plain reference imports nothing of the program; a run's
process holds none of them at its end."""

import ast
import shutil
import subprocess
import sys

from benchmark import run, spec


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    for path in spec.HERE.rglob("*.py"):
        bad = set(_imports(path)) & set(run.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").rglob("*.py"):
        assert run.PROGRAM not in set(_imports(path)), path


def test_whole_names_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "geoa3_tpu_torch.probe", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    for name in ("geoa3_tpu", "jax", "geoa3_tpu.x"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "geoa3_tpu.x", sys)
    assert run.forbidden_modules() == ["geoa3_tpu"]


def test_a_run_loads_none(tmp_path):
    code = (
        "import json, sys\n"
        "from benchmark import run, spec\n"
        "bench = spec.benchmark()\n"
        "c = spec.cell('pointnet.attack.all', bench)\n"
        "c['config'].update(iter_max_steps=10, npoint=128)\n"
        "c['traffic'].update(instances=1, pool_batches=1)\n"
        "run.measure(c, bench, 7, 0.0, False, 'cpu')\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text((spec.ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "pointnet.attack.all", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
