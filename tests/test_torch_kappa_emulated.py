"""The mask readers of geoa3_tpu_torch/csrc/kappa.cu, compiled with g++
against tests/cuda_emu/cuda_runtime.h and run on the CPU
(tests/cuda_emu/kappa.cpp).

Rows 9 and 8 (`geoa3_kappa_frommask`, `geoa3_kappa_bwd` with both radii)
share one mask stream: a ring of shared-memory stages that a producer
thread fills by 1D bulk copies on mbarriers, which the emulation runs as
synchronous copies that check their bounds and barriers that count
arrivals and bytes. Row 4 (`geoa3_curv_term`) keeps its own reading and
is held beside them. Each is held against its plain version: row 9
within 1e-5 of the largest |kappa|, row 8 within 2e-4 of the largest
gradient entry (float32 sums in another order, by atomics; the expansion
radius's 2 p_j and -2 p_i terms cancel), row 4 within 1e-5 (curv) and
1e-4 (its gradient) of the largest entry: the tolerances `chip_smoke.py`
holds the kernels to on the card. The cases: rows that start on and off
16-byte boundaries (n = 64, 50, 1000), k = 16, 40 (two member slots a
lane) and 64 (65 members), coincident points, a pair under the 1e-12
clamp, clouds split into several row ranges with the ring refilled (a
small SM count), a mask that starts off a 16-byte line, the plan that
reads the cloud through L2, and stages of fewer rows than there are
warps (the plan's at n = 1100; one and two rows a stage on a plan set
by the test program), where a warp that skipped stages could misread a
barrier's phase: the emulated barriers keep the card's parity semantics,
so such a kernel hangs or reads the wrong stage here. The outputs start
as NaN, so the entries' zeroing (or their whole store) is checked, and
the program fails on a write past an output or a bulk copy outside the
mask's lines or the launch's shared memory. The stream's plan at the
paths' shapes is asserted as row 9's C entry takes it on a 132-SM card.

The emulation runs the kernels' own index arithmetic, barriers, ballots,
shuffles and atomics, one thread a CUDA thread; it says nothing of speed
or of the card's memory model, which `chip_smoke.py` covers on the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import kappa_kernel as kk
from geoa3_tpu_torch.workload import synthetic_batch
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

# label -> (b, n, k, SMs, shift of the mask in bytes, the L2 plan, rows a
# stage (0: the plan's), special)
CASES = {
    "n=64 k=16 (rows on 16-byte lines)": (2, 64, 16, 1, 0, 0, 0, None),
    "n=50 k=16 (heads and tails), two row ranges a cloud": (2, 50, 16, 4, 0, 0, 0, None),
    "n=1000 k=16, four row ranges, the ring refilled": (2, 1000, 16, 1, 0, 0, 0, None),
    "n=1100: 8 rows a stage, fewer than the warps": (1, 1100, 16, 1, 0, 0, 0, None),
    "n=96 k=40 (two member slots)": (2, 96, 40, 1, 0, 0, 0, None),
    "n=100 k=64 (65 members)": (1, 100, 64, 1, 0, 0, 0, None),
    "coincident points": (2, 128, 16, 2, 0, 0, 0, "coincident"),
    "a pair under the 1e-12 clamp": (2, 64, 16, 1, 0, 0, 0, "clamp"),
    "mask 5 bytes past a 16-byte line, n=50": (2, 50, 16, 4, 5, 0, 0, None),
    "cloud read through L2, n=1000": (2, 1000, 16, 1, 3, 1, 0, None),
    "cloud read through L2, n=50 k=40": (2, 50, 40, 4, 0, 1, 0, None),
    # a row a stage, as past n = 8192: each warp waits for every stage
    "one row a stage, n=300": (2, 300, 16, 1, 0, 0, 1, None),
    "two rows a stage through L2, mask 7 bytes past a line, n=300": (2, 300, 16, 1, 7, 1, 2, None),
}

# (b, n) -> the plan the C entries take on 132 SMs where two blocks fit an
# SM's registers (row 9; row 8 takes one): staged, rows a block, rows a
# stage, ring depth, blocks a cloud
PLANS = {
    (32, 1024): (1, 128, 16, 4, 8),
    (16, 1024): (1, 64, 16, 4, 16),
    (2, 1000): (1, 32, 16, 2, 32),
    (2, 6864): (1, 104, 2, 8, 66),
    (2, 6865): (0, 105, 2, 8, 66),
    (2, 10000): (0, 152, 1, 16, 66),
    (1, 19018): (0, 145, 1, 8, 132),
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("kappa_emu")
    (build / "kappa_emu.cpp").write_text(_rewrite((CSRC / "kappa.cu").read_text()))
    exe = build / "kappa"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "kappa.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe, build


def _inputs(case):
    """(moved cloud, normals, the unmoved cloud's mask, w) as the public ops
    and the partial-variable step see them: a mask one step stale."""
    b, n, k, _, _, _, _, special = CASES[case]
    rng = np.random.RandomState(len(case))
    pc, nrm = synthetic_batch(b, n, len(case), device="cpu")
    if special == "clamp":  # |p_1 - p_0| = 1e-13, under the clamp
        pc[0, 0] = 0.0
        pc[0, 1] = torch.tensor([1e-13, 0.0, 0.0])
    adv = pc + 1e-3 * torch.from_numpy(rng.randn(b, n, 3).astype(np.float32))
    if special == "coincident":  # exact duplicates, before and after the move
        for c in (pc, adv):
            c[0, 64] = c[0, 10]
            c[0, 65] = c[0, 10]
            c[1, 100] = c[1, 7]
            c[1, 3:9] = c[1, 3]
    if special == "clamp":
        adv[0, :2] = pc[0, :2]
    mask = kk.kappa_selmask_plain(pc, k)
    if special == "coincident":
        assert mask[0, 10, 64] == 1 and mask[1, 3, 8] == 1
    if special == "clamp":
        assert mask[0, 0, 1] == 1 and mask[0, 1, 0] == 1
    w = torch.from_numpy(rng.randn(b, n).astype(np.float32))
    return adv.contiguous(), nrm, mask, w


def _run(emulated, entry, case, args, out_shape):
    exe, build = emulated
    b, n, k, sms, shift, unstaged, rows, _ = CASES[case]
    tag = re.sub(r"\W+", "_", f"{entry}_{case}")
    src, dst = build / f"in_{tag}.bin", build / f"out_{tag}.bin"
    src.write_bytes(b"".join(a.numpy().tobytes() for a in args))
    res = subprocess.run([str(exe), entry, str(src), str(dst), str(b), str(n),
                          str(k), str(sms), str(shift), str(unstaged), str(rows)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.frombuffer(dst.read_bytes(), np.float32)
    assert got.size == int(np.prod(out_shape))
    return torch.from_numpy(got.reshape(out_shape).copy()), res.stdout


def _close(got, want, rel):
    """Within `rel` of want's largest entry; NaN (an element left unwritten)
    fails."""
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


def _plan(out):
    m = re.search(r"staged=(\d) S=(\d+) R=(\d+) depth=(\d+) stage=\d+ "
                  r"per_cloud=(\d+) smem=(\d+)", out)
    return tuple(map(int, m.groups()))


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "kappa.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


def test_rows_9_and_8_share_the_stream_and_the_old_readers_are_gone():
    src = (CSRC / "kappa.cu").read_text()
    assert not re.search(r"\bkappa_frommask_kernel\b", src)
    assert not re.search(r"\bkappa_bwd_kernel\b", src)
    for kernel in ("kappa_frommask_stream_kernel", "kappa_bwd_stream_kernel"):
        body = src.split(f"    {kernel}(")[1].split("\n}\n")[0]
        assert "stream_rows<kStaged>(" in body
    # the bulk copy and the mbarriers come from the shared TMA header
    assert '#include "tma.cuh"' in src
    assert ("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            in (CSRC / "tma.cuh").read_text())
    curv = src.split("    curv_term_kernel(")[1].split("\n}\n")[0]
    assert "for_mask_rows(" in curv and "stream_rows" not in curv


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_stream_plan_at_the_path_shapes(emulated, shape):
    exe, _ = emulated
    b, n = shape
    res = subprocess.run([str(exe), "plan", "-", "-", str(b), str(n), "16",
                          "132", "0", "0"], capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    staged, S, R, depth, per_cloud, smem = _plan(res.stdout)
    assert (staged, S, R, depth, per_cloud) == PLANS[shape]
    assert smem <= 232448
    assert per_cloud * S >= n > (per_cloud - 1) * S


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_9_source_matches_the_plain_version(emulated, case):
    adv, nrm, mask, _ = _inputs(case)
    b, n, k, _, _, unstaged, rows, _ = CASES[case]
    got, out = _run(emulated, "frommask", case, (adv, nrm, mask), (b, n))
    staged, _, R, _, _, _ = _plan(out)
    assert staged == 1 - unstaged and (R == rows or not rows)
    _close(got, kk.kappa_from_mask_plain(adv, nrm, mask, k), 1e-5)


@pytest.mark.parametrize("radius", kk.RADII)
@pytest.mark.parametrize("case", sorted(CASES))
def test_row_8_source_matches_the_plain_version(emulated, case, radius):
    adv, nrm, mask, w = _inputs(case)
    b, n, k, _, _, _, _, special = CASES[case]
    got, _ = _run(emulated, radius, case, (adv, nrm, mask, w), (b, n, 3))
    _close(got, kk.kappa_bwd_plain(adv, nrm, mask, w, k, radius), 2e-4)
    if special == "coincident":
        assert torch.isfinite(got).all()


@pytest.mark.parametrize("case", sorted(c for c in CASES if not any(CASES[c][5:7])))
def test_row_4_source_matches_the_plain_version(emulated, case):
    adv, nrm, mask, w = _inputs(case)
    b, n, k, _, _, _, _, _ = CASES[case]
    ref = w.abs()
    got, _ = _run(emulated, "curv", case, (adv, nrm, mask, ref), (b + b * n * 3,))
    curv, grad = kk.curv_term_plain(adv, nrm, ref, mask, k)
    _close(got[:b], curv, 1e-5)
    _close(got[b:].reshape(b, n, 3), grad, 1e-4)
