"""The ball query + grouping CUDA source (geoa3_tpu_torch/csrc/
ballquery_group.cu), compiled with g++ against tests/cuda_emu/cuda_runtime.h
and run on the CPU (tests/cuda_emu/ballquery_group.cpp). The forward's idx,
gx and gf are held bit-equal to `ballquery_group_plain`, and the index-only
entry's idx to `ball_query_plain` (which tests/test_torch_grouping.py holds
against the Pallas kernel); the backward, run on the forward's idx, is held
against `ballquery_group_bwd_plain` at 2e-5 of each output's largest entry
(float32 sums in another order: a ball's first hit and its repeats summed
first, the rest by atomics). The cases: the SSG SA1 and SA2 shapes and MSG
SA1's three scales on the synthetic shapes with FPS centres (cut to a few
clouds and centres), ragged n (1, 33, 1000), ns > n, empty balls, over-full
balls, a ball holding only its centre, cf = 0, 3, 5 and 128, m not a
multiple of a block's 8 centres, ns = 1 (32 centres a warp in the
backward), ns at its limit, one n past the shared-memory plan, and the
uniform loss's five index-only shapes. Each case's plan, as the C entry
prints it, is asserted; the program fails on a write past an output, and
the backward's outputs start as NaN, so the entry's zeroing is checked.

The emulation runs the kernels' own index arithmetic, barrier, ballots,
shuffles, atomics and float operations, one thread a CUDA thread; it says
nothing of speed or of the card's memory model, which `chip_smoke.py`
covers on the card.
"""

from __future__ import annotations

import math
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import ballquery_group_kernel as bk
from geoa3_tpu_torch.ops.kernels import fps_kernel as fk
from geoa3_tpu_torch.workload import synthetic_batch
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

SMEM_HALF = 113 * 1024  # common.cuh's kSmemHalf: two blocks an SM

# b, n, m, ns, cf, radius, layout: "fps" (centres by FPS of the synthetic
# clouds), "sa2" (xyz itself FPS of a 1024-point cloud), "far" (every other
# centre far off: empty balls), "lone" (centre 0 on an isolated point of
# the cloud), "random" (uniform points, centres among them)
CASES = {
    "SSG SA1 cf=0 r=0.2": (2, 1024, 40, 64, 0, 0.2, "fps"),
    "SSG SA2 cf=128 r=0.4": (2, 512, 24, 64, 128, 0.4, "sa2"),
    "MSG SA1 ns=16 r=0.1": (2, 1024, 37, 16, 0, 0.1, "fps"),
    "MSG SA1 ns=32 r=0.2": (2, 1024, 21, 32, 0, 0.2, "fps"),
    "MSG SA1 ns=128 r=0.4": (1, 1024, 19, 128, 0, 0.4, "fps"),
    "cf=3 (normals)": (2, 1024, 16, 64, 3, 0.2, "fps"),
    "ragged n=1": (2, 1, 5, 4, 3, 0.3, "random"),
    "ragged n=33, cf=5": (3, 33, 9, 8, 5, 0.5, "random"),
    "ragged n=1000": (2, 1000, 21, 64, 128, 0.2, "fps"),
    "ns 64 > n 48": (2, 48, 16, 64, 4, 0.4, "random"),
    "empty balls": (2, 512, 24, 64, 128, 0.4, "far"),
    "over-full balls r=2": (2, 512, 16, 64, 0, 2.0, "sa2"),
    "a ball holding only its centre": (2, 1024, 10, 64, 3, 0.2, "lone"),
    "m=13, not a multiple of the block's 8": (3, 256, 13, 24, 8, 0.5, "random"),
    "ns=1": (2, 100, 45, 1, 0, 0.5, "random"),
    "ns=1536 (the limit)": (1, 2048, 3, 1536, 0, 2.0, "fps"),
    "n=8000, past the shared-memory plan": (1, 8000, 10, 64, 8, 0.2, "fps"),
}

# the uniform loss at n = 1024: 51 seeds by FPS, ns = int(n * 4p) and
# r = sqrt(4p) for its five percentages (geoa3_tpu_torch/losses.py)
UNIFORM = {f"uniform loss ns={int(1024 * 4 * p)}": (2, 1024, 51, int(1024 * 4 * p), 0,
                                                     math.sqrt(4 * p), "fps")
           for p in (0.004, 0.006, 0.008, 0.010, 0.012)}


def _inputs(seed, b, n, m, ns, cf, layout):
    rng = np.random.RandomState(seed)
    if layout == "random":
        xyz = torch.from_numpy(rng.uniform(-0.5, 0.5, (b, n, 3)).astype(np.float32))
        centres = xyz[:, rng.randint(0, n, m)].contiguous()
    else:
        src = 1024 if layout == "sa2" else n
        xyz, _ = synthetic_batch(b, src, seed, device="cpu")
        if layout == "sa2":
            xyz = torch.gather(xyz, 1, fk.fps_plain(xyz, n).long()[..., None]
                               .expand(-1, -1, 3)).contiguous()
        if layout == "lone":
            xyz[:, 5] = torch.tensor([3.0, 3.0, 3.0])  # no other point near
        pick = fk.fps_plain(xyz, m).long()
        centres = torch.gather(xyz, 1, pick[..., None].expand(-1, -1, 3)).contiguous()
        if layout == "far":
            centres[:, ::2] += 100.0
        if layout == "lone":
            centres[:, 0] = xyz[:, 5]
    feats = torch.from_numpy(rng.randn(b, n, cf).astype(np.float32))
    dgx = torch.from_numpy(rng.randn(b, m, ns, 3).astype(np.float32))
    dgf = torch.from_numpy(rng.randn(b, m, ns, cf).astype(np.float32))
    return xyz, centres, feats, dgx, dgf


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("ballquery_emu")
    (build / "ballquery_group_emu.cpp").write_text(
        _rewrite((CSRC / "ballquery_group.cu").read_text()))
    exe = build / "ballquery_group"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "ballquery_group.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe, build


def _run(emulated, label, case, index_only):
    exe, build = emulated
    b, n, m, ns, cf, radius, layout = case
    xyz, centres, feats, dgx, dgf = _inputs(len(label), b, n, m, ns, cf, layout)
    src, dst = build / f"in_{len(label)}.bin", build / f"out_{len(label)}.bin"
    parts = [np.float32(bk._r2(radius)).tobytes(), xyz.numpy().tobytes(),
             centres.numpy().tobytes()]
    if not index_only:
        parts += [feats.numpy().tobytes(), dgx.numpy().tobytes(),
                  dgf.numpy().tobytes()]
    src.write_bytes(b"".join(parts))
    res = subprocess.run([str(exe), str(src), str(dst), str(b), str(n), str(m),
                          str(ns), str(cf), str(int(index_only))],
                         capture_output=True, text=True, timeout=300)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    shared, smem = map(int, re.search(r"shared=(\d) smem=(\d+)", out).groups())
    rows = 8 * ns * 4  # the block's 8 index rows
    want_shared = rows + 16 * n <= SMEM_HALF
    assert (bool(shared), smem) == (want_shared, rows + 16 * n * want_shared), out
    raw = np.frombuffer(dst.read_bytes(), np.uint8)
    sizes = ([("idx", np.int32, (b, m, ns))] if index_only else
             [("idx", np.int32, (b, m, ns)), ("gx", np.float32, (b, m, ns, 3)),
              ("gf", np.float32, (b, m, ns, cf)), ("idx2", np.int32, (b, m, ns)),
              ("dxyz", np.float32, (b, n, 3)), ("dcentre", np.float32, (b, m, 3)),
              ("dfeats", np.float32, (b, n, cf))])
    got, pos = {}, 0
    for name, dt, shape in sizes:
        count = int(np.prod(shape)) * 4
        got[name] = torch.from_numpy(raw[pos:pos + count].view(dt).reshape(shape).copy())
        pos += count
    assert pos == raw.size
    return got, (xyz, centres, feats, dgx, dgf), (shared, smem)


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "ballquery_group.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


def test_the_source_includes_neither_shared_walk_nor_scatter():
    """Row 17 keeps ballquery.cuh's walk; row 15 runs its own walk, and the
    row scatter of scatter_rows.cuh, which row 13 shares (scatter.cuh, the
    old C-channel kernel, is gone)."""
    src = (CSRC / "ballquery_group.cu").read_text()
    assert '#include "ballquery.cuh"' not in src
    assert '#include "scatter.cuh"' not in src


@pytest.mark.parametrize("case", sorted(CASES))
def test_ballquery_source_matches_the_plain_version(emulated, case):
    b, n, m, ns, cf, radius, layout = CASES[case]
    got, (xyz, centres, feats, dgx, dgf), (shared, _) = _run(
        emulated, case, CASES[case], False)
    assert shared == (n <= 2048)  # every engine path's cloud is staged
    f_ = feats if cf else None
    idx, gx, gf = bk.ballquery_group_plain(xyz, centres, f_, radius, ns)
    assert torch.equal(got["idx"], idx)
    assert torch.equal(got["idx2"], idx)
    assert torch.equal(got["gx"], gx)
    if cf:
        assert torch.equal(got["gf"], gf)
    if layout == "far":
        assert not got["idx"][:, ::2].any()  # an empty ball holds index 0
    if layout == "lone":
        assert (got["idx"][:, 0] == 5).all()  # only its centre: one hit, repeated
    if ns > n:
        assert (got["idx"][..., n:] == got["idx"][..., :1]).all()
    want = bk.ballquery_group_bwd_plain(idx, dgx, dgf if cf else None, n)
    for name, w_ in zip(("dxyz", "dcentre", "dfeats"), want):
        if w_ is None:
            continue
        err = (got[name] - w_).abs().max().item()
        assert err <= 2e-5 * w_.abs().max().item(), (name, err)


@pytest.mark.parametrize("case", sorted(UNIFORM))
def test_ball_query_source_at_the_uniform_loss_shapes(emulated, case):
    b, n, m, ns, cf, radius, layout = UNIFORM[case]
    got, (xyz, centres, *_), (shared, _) = _run(emulated, case, UNIFORM[case], True)
    assert shared
    assert torch.equal(got["idx"], bk.ball_query_plain(xyz, centres, radius, ns))
