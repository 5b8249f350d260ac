"""The grouped-MLP CUDA source (geoa3_tpu_torch/csrc/group_mlp.cu), compiled
with g++ against tests/cuda_emu/cuda_runtime.h and run on the CPU. The
forward is held bit-equal to a serial fmaf-chain oracle (tests/cuda_emu/
group_mlp_fwd.cpp); the backward, run after the forward on the same inputs,
to the backward taken in float64 through that oracle's float32 ReLU
patterns and tie sets, at 2e-5 of each output's largest entry
(tests/cuda_emu/group_mlp_bwd.cpp). The cases: the tile plans of every
victim shape at a few groups, padded slots, groups split across blocks,
ties across those blocks, misaligned features, persistent blocks walking
several tiles, widths that are 4 mod 8 past a round of 8-column threads,
GroupAll's widths past 32-row tiles, layer 1's input staged in slices
(by float4s and by floats), and widths of 1024 (8-row ring stages). Each
case's tile plan, as the C entry picks it (tile rows, parts, ring depth,
input channels a slice, shared memory), must be the one the wrapper's
`tile_plan` predicts. Both programs fail on a write past the end of an output.

The emulation runs the kernels' own index arithmetic, barriers, shuffles
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
    # cf = 1: the backward's last layer, 4 columns wide, runs off the ring
    # and writes dgf's one column (with layer 4 on the ring, ns < 64, and
    # off it)
    "cf=1, ns=48": (5, 48, 1, (32, 32, 64), 2, 0, (7, 47)),
    "cf=1, ns=64": (3, 64, 1, (64, 64, 128), 1, 0, (1, 63)),
    # GroupAll past 32-row tiles: 16-row tiles, 8 parts a group, ties
    # across the parts
    "GroupAll cf=896 (16-row tiles)": (2, 128, 896, (256, 512, 1024), 3, 0, (1, 16, 47, 64, 127)),
    "GroupAll cf=1536 (16-row tiles)": (1, 128, 1536, (256, 512, 1024), 2, 0, (15, 16, 80, 127)),
    # layer 1's input in slices (32-row tiles, 784 channels a slice forward,
    # 720 backward): by float4s, and by floats where cf is not a multiple of 4
    "GroupAll cf=2048 (input in slices)": (1, 128, 2048, (256, 512, 1024), 2, 0, (1, 31, 32, 127)),
    "GroupAll cf=1901 (input in slices, scalar staging)": (1, 128, 1901, (256, 512, 1024), 3, 0, (5, 64)),
    # widths of 1024: the backward on 16-row tiles with 8-row ring stages and
    # dz3 as hit bits at ns < 64; at cf = 2000 the input in slices too, over
    # layer 1's two rounds of columns
    "widths 1024, cf=1024": (1, 16, 1024, (1024, 1024, 1024), 1, 0, (3, 15)),
    "widths 1024, cf=2000 (input in slices)": (2, 32, 2000, (1024, 1024, 1024), 2, 0, (17,)),
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
def emulated(tmp_path_factory):
    """The two drivers, built from the rewritten source side by side."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("group_mlp_emu")
    (build / "group_mlp_emu.cpp").write_text(_rewrite((CSRC / "group_mlp.cu").read_text()))
    procs = {}
    for name in ("group_mlp_fwd", "group_mlp_bwd"):
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
             "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
             str(EMU / f"{name}.cpp"), "-o", str(build / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out[-4000:]
    return {name: build / name for name in procs}


def _run(exe, case):
    groups, ns, cf, widths, sms, shift, tied = CASES[case]
    args = [groups, ns, cf, *widths, 11, sms, shift, *tied]
    res = subprocess.run([str(exe), *map(str, args)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    plan = re.search(r"rows=(\d+) slot=\d+ parts=(\d+) tiles=\d+ smem=(\d+) depth=(\d+) "
                     r"kin=(\d+) ", res.stdout)
    rows, parts, smem, depth, kin = map(int, plan.groups())
    return res.stdout, (rows, parts, depth, kin, smem)


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "group_mlp.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_mlp_fwd_source_is_bit_equal_to_the_fmaf_oracle(emulated, case):
    _, ns, cf, widths, *_ = CASES[case]
    out, plan = _run(emulated["group_mlp_fwd"], case)
    assert "differ=0 " in out, out
    assert plan == gk.tile_plan(ns, cf, widths, False), out


@pytest.mark.parametrize("case", sorted(CASES))
def test_group_mlp_bwd_source_matches_the_float64_oracle(emulated, case):
    _, ns, cf, widths, *_ = CASES[case]
    out, plan = _run(emulated["group_mlp_bwd"], case)
    assert " bad=0 " in out, out
    carried = int(re.search(r"carried=(\d+)", out).group(1))
    assert carried > 0, out  # some cotangent reached the rows
    assert plan == gk.tile_plan(ns, cf, widths, True), out
