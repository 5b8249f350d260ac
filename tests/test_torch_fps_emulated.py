"""The farthest-point sampling CUDA source (geoa3_tpu_torch/csrc/fps.cu),
compiled with g++ against tests/cuda_emu/cuda_runtime.h and run on the CPU
(tests/cuda_emu/fps.cpp). Its picks are held bit-equal to `fps_plain`, which
tests/test_torch_sampling.py holds against the Pallas kernel, on the same
clouds: b <= 3 at n = 512, 1024 and 2048; ragged n (1, 33, 1000); skipped
points and a fully skipped cloud; a start with no skip; m = 1 and m > n; and
one cloud at the largest n of each plan (threads, points a thread) that
`fps_plan` picks for n in 1..14336, the plans with coordinates in shared
memory among them. Every round runs the same code, so m stays <= 64. Each
case's plan, as the C entry picks it, must be the one `fps_plan` predicts;
the program fails on a write past the end of idx.

The emulation runs the kernel's own index arithmetic, barrier, redux
reductions and float operations, one thread a CUDA thread; it says nothing
of speed or of the card's memory model, which `chip_smoke.py` covers on the
card. A plain test also walks `fps_plan` over every n the kernel takes.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import fps_kernel as fk
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

# b, n, m, skip, start, near (0: none; 1: points near the origin; 2: those
# and a last cloud inside the skip radius entirely)
CASES = {
    "n=512, b=3": (3, 512, 64, True, False, 0),
    "n=1024, b=3": (3, 1024, 64, True, False, 0),
    "n=2048, b=2": (2, 2048, 48, True, False, 0),
    "ragged n=1": (2, 1, 4, True, False, 0),
    "ragged n=33": (3, 33, 20, True, False, 1),
    "ragged n=1000": (2, 1000, 64, True, False, 0),
    "skipped points and a fully skipped cloud": (3, 1024, 48, True, False, 2),
    "skipped points, no skip": (2, 1024, 48, False, False, 2),
    "a start, no skip": (3, 2048, 40, False, True, 0),
    "m=1": (3, 1000, 1, True, True, 1),
    "m > n": (2, 40, 64, True, False, 1),
}


def _plans():
    """The largest n of each plan fps_plan picks for n in 1..MAX_N."""
    last = {}
    for n in range(1, fk.MAX_N + 1):
        last[fk.fps_plan(n)[:2]] = n
    return last


PLAN_CASES = {f"plan threads={t} points={p}: n={n}": (1, n, 12, True, True, 1)
              for (t, p), n in sorted(_plans().items())}


def _cloud(seed, b, n, near):
    rng = np.random.RandomState(seed)
    c = rng.randn(b, n, 3).astype(np.float32)
    if near:
        c[:, : max(1, n // 20)] *= np.float32(0.01)  # |p|^2 <= 1e-3 mostly
        c[:, 0] *= np.float32(1e-3)
    if near == 2:
        c[-1] *= np.float32(1e-3)
    start = rng.randint(0, n, b).astype(np.int32)
    start[0] = -3  # clamped to 0
    if b > 1:
        start[1] = n + 5  # clamped to n - 1
    return c, start


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("fps_emu")
    (build / "fps_emu.cpp").write_text(_rewrite((CSRC / "fps.cu").read_text()))
    exe = build / "fps"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "fps.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe, build


def _run(emulated, case, seed):
    exe, build = emulated
    b, n, m, skip, with_start, near = case
    c, start = _cloud(seed, b, n, near)
    src, dst = build / f"in_{seed}.bin", build / f"out_{seed}.bin"
    src.write_bytes(c.tobytes() + (start.tobytes() if with_start else b""))
    res = subprocess.run([str(exe), str(src), str(dst), str(b), str(n), str(m),
                          str(int(skip)), str(int(with_start))],
                         capture_output=True, text=True, timeout=120)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    got = np.frombuffer(dst.read_bytes(), np.int32).reshape(b, m)
    want = fk.fps_plain(torch.from_numpy(c), m,
                        torch.from_numpy(start) if with_start else None, skip)
    plan = re.search(r"threads=(\d+) points=(\d+) shared=(\d) smem=(\d+)", out)
    t, p, shared, smem = map(int, plan.groups())
    assert (t, p, bool(shared), smem) == fk.fps_plan(n), out
    return got, want.numpy(), c, start


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "fps.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_fps_source_is_bit_equal_to_the_plain_version(emulated, case):
    b, n, m, skip, with_start, near = CASES[case]
    got, want, c, start = _run(emulated, CASES[case], seed=len(case))
    np.testing.assert_array_equal(got, want)
    if with_start:
        np.testing.assert_array_equal(got[:, 0], np.clip(start, 0, n - 1))
    if near == 2 and skip:
        assert not got[-1].any()  # every point skipped: every pick is 0
    if skip and near and m <= n:
        x, y, z = c[0, :, 0], c[0, :, 1], c[0, :, 2]
        ok = (x * x + y * y) + z * z > np.float32(fk.SKIP_MAG2)
        assert ok[got[0, 1:]].all()  # no skipped point picked


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_fps_source_at_each_plan(emulated, case):
    got, want, *_ = _run(emulated, PLAN_CASES[case], seed=7)
    np.testing.assert_array_equal(got, want)


def test_fps_plan_takes_every_n_within_its_budget():
    """Every n the kernel takes gets a block of 32..1024 threads (a power of
    two) with the fewest points a thread that cover n: PLAN_THREADS threads
    where they hold n at REG_POINTS points a thread, narrower only with a
    point a thread, wider only where the next narrower width would need more
    than REG_POINTS; registers hold at most REG_POINTS points a thread (4
    words each: 40 of the 64 registers a thread at 1024 threads),
    coordinates are read from shared memory only at 1024 threads, and the
    slots and the cloud's float4 copy fit a block's 232,448 bytes of shared
    memory."""
    plans = set()
    for n in range(1, fk.MAX_N + 1):
        t, p, shared, smem = fk.fps_plan(n)
        assert t in (32, 64, 128, 256, 512, 1024)
        assert t * p >= n > t * (p - 1)
        assert 1 <= p <= fk.MAX_N // fk.MAX_THREADS
        assert shared == (p > fk.REG_POINTS)
        assert shared <= (t == fk.MAX_THREADS)
        assert smem == fk.SLOT_BYTES + 16 * t * p <= 232448
        if t < fk.PLAN_THREADS:
            assert p == 1 and (t == 32 or t // 2 < n)
        if t > fk.PLAN_THREADS:
            assert t // 2 * fk.REG_POINTS < n
        if fk.PLAN_THREADS <= n <= fk.PLAN_THREADS * fk.REG_POINTS:
            assert t == fk.PLAN_THREADS
        plans.add((t, p))
    assert len(plans) == len(PLAN_CASES)
