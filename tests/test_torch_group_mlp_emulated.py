"""The grouped-MLP forward's CUDA source (geoa3_tpu_torch/csrc/group_mlp.cu),
compiled with g++ against tests/cuda_emu/cuda_runtime.h and run on the CPU,
held bit-equal to a serial fmaf-chain oracle (tests/cuda_emu/
group_mlp_fwd.cpp): the tile plans of every victim shape at a few groups,
padded slots, groups split across blocks, ties across those blocks,
misaligned features, persistent blocks walking several tiles, and widths
that are 4 mod 8 past a round of 8-column threads. Each case's tile plan, as
the C entry picks it, must be the one the wrapper's `fwd_plan` predicts.

The emulation runs the kernel's own index arithmetic, barriers, shuffles
and float operations, one thread a CUDA thread; it says nothing of speed
or of the card's memory model, which `chip_smoke.py` covers on the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

import pytest

from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "geoa3_tpu_torch" / "csrc"
EMU = Path(__file__).resolve().parent / "cuda_emu"

# groups, ns, cf, (c1, c2, c3), SMs, shift, rows tied to row 0
CASES = {
    "SSG SA1 (128-row tiles, two groups a tile)": (6, 64, 0, (64, 64, 128), 1, 0, (1, 9, 40)),
    "SSG SA2 (64-row tiles)": (3, 64, 128, (128, 128, 256), 2, 0, (1, 2)),
    "SSG SA3 (32-row tiles, 4 parts a group)": (2, 128, 256, (256, 512, 1024), 1, 0, (1, 9, 63, 64, 127)),
    "MSG SA1 ns=16 (a ragged last tile)": (13, 16, 0, (32, 32, 64), 1, 0, (3,)),
    "MSG SA1 ns=128 (a 96-column layer)": (3, 128, 0, (64, 96, 128), 3, 0, (127,)),
    "MSG GroupAll cf=640": (1, 128, 640, (256, 512, 1024), 1, 0, (1, 63, 64, 127)),
    "ns=24 padded slots, cf=5": (7, 24, 5, (32, 32, 64), 2, 0, (5, 23)),
    "ns=200 split at 128 rows": (3, 200, 4, (32, 32, 64), 4, 0, (0, 127, 128, 199)),
    "ns=1": (20, 1, 0, (16, 16, 16), 1, 0, ()),
    "misaligned features": (5, 32, 8, (32, 32, 64), 1, 1, (31,)),
    # 8-column threads would write past the layer's end in these
    "layer 3 of 260 columns at 128-row tiles": (3, 32, 0, (64, 64, 260), 1, 0, (5,)),
    "layer 1 of 132 columns at 128-row tiles, split": (2, 200, 4, (132, 44, 68), 2, 0, (0, 127, 128, 199)),
}


def _rewrite(src: str) -> str:
    """The kernel source as the emulation compiles it: each launch becomes
    an emu_launch call (cuda_runtime.h supplies shared memory and cp.async)."""
    out, pos = [], 0
    for m in re.finditer(r"([A-Za-z_]\w*(?:<[^<>]*>)?)<<<(.*?)>>>\(", src, flags=re.S):
        if m.start() < pos:
            continue
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        out.append(src[pos:m.start()])
        out.append(f"emu_launch(std::make_tuple({m.group(2)}), [&]() {{ "
                   f"{m.group(1)}({src[m.end():i - 1]}); }})")
        pos = i
    out.append(src[pos:])
    return "".join(out)


@pytest.fixture(scope="module")
def emulated_fwd(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("group_mlp_emu")
    (build / "group_mlp_emu.cpp").write_text(_rewrite((CSRC / "group_mlp.cu").read_text()))
    exe = build / "group_mlp_fwd"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "group_mlp_fwd.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "group_mlp.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_mlp_fwd_source_is_bit_equal_to_the_fmaf_oracle(emulated_fwd, case):
    groups, ns, cf, widths, sms, shift, tied = CASES[case]
    args = [groups, ns, cf, *widths, 11, sms, shift, *tied]
    res = subprocess.run([str(emulated_fwd), *map(str, args)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "differ=0 " in res.stdout, res.stdout
    plan = re.search(r"rows=(\d+) slot=\d+ parts=(\d+) tiles=\d+ smem=(\d+) ", res.stdout)
    rows, parts, smem = map(int, plan.groups())
    assert (rows, parts) == gk.fwd_plan(ns, cf, widths), res.stdout
    assert smem == gk.fwd_smem_bytes(cf, widths, rows), res.stdout
