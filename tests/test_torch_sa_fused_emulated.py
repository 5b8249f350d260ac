"""The whole-scale set-abstraction CUDA source (geoa3_tpu_torch/csrc/
sa_fused.cu), compiled with g++ against tests/cuda_emu/cuda_runtime.h and
run on the CPU: its forward, then its backward, on the same inputs
(tests/cuda_emu/sa_fused_bwd.cpp). The forward's ball query pass is held
bit-equal to a serial one, its projections P and Yc and its tiles' pooled
maxima and tie counts to a serial fmaf-chain oracle (the tie sets the
backward's recompute must find again), balls split over tiles merged by the
finishing kernel; the backward's dP, dYc and the three input cotangents to
the backward taken in float64 through that oracle's float32 ReLU patterns
and tie sets, at 2e-5 of each output's largest entry, and the three
cotangents bit-equal to one fmaf chain an output over the kernel's own dP
and dYc. The cases: MSG SA2's three scales at a few balls (dz3 on the ring
at ns = 32, hit bits at 64 and 128), cf = 0, 1, 3 and 5 (feature rows not
16-byte aligned), padded slots, empty and over-full balls, balls split over
tiles, widths of 1024 at cf = 1024 (16-row tiles, 8-row ring stages), the
forward's own layouts at MSG SA2's widths (64-row tiles): balls of 128 and
of 96 rows in two parts (the second part of a 96-row ball half padding), two
balls of 24 in a tile's 32-row slots; and the projections' tiles: 32, 16, 8
and 1 quads, a row count that is no multiple of the tile's, cf = 3000 (past
the 2902 the projections' old whole-input tile took). Each case's tile
plans, as the C entries pick them, must be the ones the wrapper's
`fwd_plan` and `bwd_plan` predict, and the projections' the ones their rule
gives (`_proj_tile`). The program fails on a write past the end of an
output.

The emulation runs the kernels' own index arithmetic, barriers, shuffles,
ballots, atomics and float operations, one thread a CUDA thread; it says
nothing of speed or of the card's memory model, which `chip_smoke.py`
covers on the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import pytest

from geoa3_tpu_torch.ops.kernels import sa_fused_kernel as sf
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

# b, n, m, ns, cf, (c1, c2, c3), radius, SMs, far (every other centre
# moved away: empty balls)
CASES = {
    "MSG SA2 r=0.4 ns=32 (dz3 on the ring)": (2, 256, 6, 32, 320, (64, 64, 128), 0.4, 2, 0),
    "MSG SA2 r=0.6 ns=64 (hit bits, two balls a tile)": (2, 256, 5, 64, 320, (128, 128, 256), 0.6, 1, 0),
    "MSG SA2 r=0.8 ns=128": (2, 256, 3, 128, 320, (128, 128, 256), 0.8, 2, 0),
    "cf=0 r=0.3 ns=16 (256-row tiles)": (2, 256, 20, 16, 0, (32, 32, 64), 0.3, 1, 0),
    "cf=3 (normals) ns=16": (2, 256, 9, 16, 3, (32, 32, 64), 0.3, 2, 0),
    "ns=24 padded slots, cf=5": (2, 256, 7, 24, 5, (32, 32, 64), 0.4, 1, 0),
    "empty balls": (2, 256, 8, 32, 320, (32, 32, 64), 0.4, 1, 1),
    "over-full balls r=2": (2, 256, 6, 32, 320, (32, 32, 64), 2.0, 1, 0),
    "balls split over 4 tiles (32-row tiles)": (2, 256, 2, 128, 64, (256, 512, 1024), 0.8, 3, 0),
    "widths 1024, cf=1024 (8-row ring stages, balls split in 2)": (1, 128, 2, 32, 1024, (1024, 1024, 1024), 0.6, 2, 0),
    # the forward's tiles at MSG SA2's widths are 64 rows
    "ns=128 in two forward parts (64-row tiles)": (2, 256, 5, 128, 64, (128, 128, 256), 0.8, 3, 0),
    "ns=96 in two forward parts, the second padded": (2, 256, 4, 96, 64, (128, 128, 256), 0.7, 2, 0),
    "ns=24, two balls a 64-row forward tile": (2, 256, 5, 24, 64, (128, 128, 256), 0.5, 2, 0),
    # the projections' tiles: 32-quad P, 8-quad dfeats, 500 rows
    "b n = 2 x 250, cf=32": (2, 250, 5, 24, 32, (128, 64, 128), 0.4, 2, 0),
    "cf=1, c1=32 (unaligned feature rows)": (2, 256, 6, 16, 1, (32, 32, 64), 0.3, 1, 0),
    "c1=4 (1-quad projection tiles), cf=5, b n = 2 x 250": (2, 250, 4, 16, 5, (4, 8, 8), 0.4, 1, 0),
    "cf=3000 (past the old projection limit)": (1, 64, 4, 16, 3000, (32, 32, 64), 0.5, 2, 0),
}


def _proj_tile(nq):
    """csrc/sa_fused.cu tile_quads and the rows of the tile it picks: the
    largest of 32, 16 and 8 quads that divides a layer's nq quads or leaves
    its last column tile more than half busy, else 1; 128 rows at 32 and 16
    quads (PWide, PMid), else 256 (PNarrow, POne)."""
    for t in (32, 16, 8):
        if nq % t == 0 or nq % t > t // 2:
            return t, 128 if t >= 16 else 256
    return 1, 256


def _tiles(rows, tile_rows):
    return -(-rows // tile_rows)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("sa_fused_emu")
    (build / "sa_fused_emu.cpp").write_text(_rewrite((CSRC / "sa_fused.cu").read_text()))
    exe = build / "sa_fused_bwd"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "sa_fused_bwd.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "sa_fused.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sa_fused_bwd_source_matches_the_float64_oracle(emulated, case):
    b, n, m, ns, cf, widths, radius, sms, far = CASES[case]
    args = [b, n, m, ns, cf, *widths, radius, 23, sms, far]
    res = subprocess.run([str(emulated), *map(str, args)],
                         capture_output=True, text=True, timeout=300)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    assert " bad=0 " in out, out
    plan = re.search(r"rows=(\d+) slot=\d+ parts=(\d+) tiles=\d+ smem=(\d+) depth=(\d+) "
                     r"sparse=(\d) ", out)
    rows, parts, smem, depth, sparse = map(int, plan.groups())
    assert (rows, parts, depth, bool(sparse), smem) == sf.bwd_plan(ns, widths), out
    fplan = re.search(r"fwd_rows=(\d+) fwd_slot=(\d+) fwd_parts=(\d+) fwd_tiles=\d+ "
                      r"fwd_smem=(\d+)", out)
    frows, fslot, fparts, fsmem = map(int, fplan.groups())
    assert (frows, fparts, fsmem) == sf.fwd_plan(ns, widths), out
    if "forward parts" in case:
        assert (frows, fparts) == (64, 2), out
    if "64-row forward tile" in case:
        assert (frows, fslot, fparts) == (64, 32, 1), out
    assert int(re.search(r"carried=(\d+)", out).group(1)) > 0, out
    # the projections: P and Yc in one launch, dfeats then dxyz and dcentres
    proj = re.search(r"proj_quads=(\d+) proj_rows=(\d+) proj_tiles=(\d+) .*"
                     r"bproj_quads=(\d+) bproj_rows=(\d+) bproj_tiles=(\d+) ", out)
    pq, pr, pt, bq, br, bt = map(int, proj.groups())
    nq, nf = widths[0] // 4, -(-cf // 4)
    assert (pq, pr) == _proj_tile(nq), out
    assert pt == (_tiles(b * n, pr) + _tiles(b * m, pr)) * _tiles(nq, pq), out
    assert (bq, br) == (_proj_tile(nf) if cf else (1, 256)), out
    assert bt == (_tiles(b * n, br) * _tiles(nf, bq) + _tiles(b * n, 256)
                  + _tiles(b * m, 256)), out
    if case.startswith("MSG SA2"):  # c1 = 64 or 128; cf's 80 quads in 5 tiles
        assert (pq, bq, _tiles(nf, bq)) == (nq if nq <= 32 else 32, 16, 5), out
    if "split" in case:
        assert parts > 1, out
    if "over-full" in case or "padded" in case or "ns=16" in case:
        assert int(re.search(r"tied=(\d+)", out).group(1)) > 0, out
