"""The single-pass bf16 pool kernels (geoa3_tpu_torch/csrc/pool_matmul_bf16.cu,
rows 6 and 7 in the bf16 victim's mode), compiled with g++ against
tests/cuda_emu/cuda_runtime.h and run on the CPU (tests/cuda_emu/pool_bf16.cpp).

The header's tensor-core stand-ins keep the PTX ISA's fragment and canonical
layouts and sum each output's 16 products k ascending, one fmaf a term: the
forward's wgmma (A from registers, B from shared memory by descriptor,
asynchronous: an op reads its operands when its group retires) and the
backward's mma.sync. So the emulated forward is one float32 chain over (tap,
k) from 0, then + bias, which a numpy oracle repeats exactly. The forward's
whole output (maximum, tie count, first four tied rows) is held bit-equal to
the oracle's; the backward within 1e-5 of the largest |dx| of a float64
backward through the oracle's ties, with the cotangent g / cnt rounded to
bf16 (the atomics sum in another order). The cases: conv5's taps 3 on
float32 x, taps 1 on bf16 and float32 x, one and two blocks a cloud, a cout
of 384 (a 256-channel block and a 128-channel one), ragged and one-warp
clouds and n ragged at the 64-point tile, the path's cin of 128 at both taps
and block widths (the weights kept in registers) beside narrower ones
(reloaded each step), and runs of duplicated rows (more than four ties: the
backward's recompute path) within a warp, across the warps of a tile and
across 64-point tiles at both taps. The outputs start as NaN or -1 and the
program fails on a write past one; the forward's plan at the path's and the
widest admitted shapes equals `pool_matmul_kernel.bf16_plan`, and no shape
the mma.sync design admitted is refused. The wgmma stand-in alone is held
against numpy on the operands as the kernel lays them out
(tests/cuda_emu/wgmma.cpp), at N = 64 and at the 128 and 256 that the
grouped MLP's streamed kernels also issue.

The emulation checks the kernels' indices, layouts, barriers, ballots and
atomics, not the tensor cores' rounding (no CPU oracle reproduces it) nor
speed: `chip_smoke.py` holds the kernels against their plain versions on the
card.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import pool_matmul_kernel as pk
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

# label -> (B, n, cin, cout, taps, x is bf16, duplicated runs: (cloud,
# first row, length))
CASES = {
    "conv5 taps 3, float32 x, n=200 (two tiles, ragged)": (2, 200, 32, 128, 3, 0, ()),
    "taps 1, bf16 x, two blocks a cloud": (2, 150, 48, 256, 1, 1, ()),
    "taps 1, float32 x": (1, 64, 32, 128, 1, 0, ()),
    "the path's cin=128, taps 3": (1, 130, 128, 128, 3, 0, ()),
    "n=7 (one partial warp), taps 3": (2, 7, 16, 128, 3, 0, ()),
    "duplicated rows in a warp and across warps, taps 3": (2, 90, 32, 128, 3, 0, ((0, 10, 7), (1, 29, 6))),
    "duplicated rows across tiles, bf16 x, taps 1": (1, 260, 32, 128, 1, 1, ((0, 124, 9),)),
    "taps 1, cout=384 (a 256-channel block and a 128-channel block)": (2, 90, 32, 384, 1, 1, ()),
    "n=100 ragged at the 64-row tile, taps 1, float32 x": (2, 100, 48, 256, 1, 0, ()),
    "duplicated rows across a 64-row stage, taps 1": (1, 150, 32, 256, 1, 1, ((0, 60, 10),)),
    "duplicated rows across a 64-row stage, taps 3": (2, 140, 32, 128, 3, 0, ((1, 60, 10),)),
    "float32 x, taps 1, cin=128, cout=256": (1, 80, 128, 256, 1, 0, ()),
    "bf16 x, taps 1, cin=128, cout=128 (two warpgroups)": (1, 70, 128, 128, 1, 1, ()),
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("pool_bf16_emu")
    (build / "pool_matmul_bf16_emu.cpp").write_text(
        _rewrite((CSRC / "pool_matmul_bf16.cu").read_text()))
    procs = {
        name: subprocess.Popen(
            [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
             "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
             str(EMU / f"{name}.cpp"), "-o", str(build / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("pool_bf16", "wgmma")}
    for proc in procs.values():
        out, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, out[-4000:]
    return build / "pool_bf16", build, {}


def _inputs(case):
    """x, w3 (bf16), bias (bf16 values in float32), g; the duplicated runs
    repeat 3x their first row, so they hold the maximum of many columns."""
    B, n, cin, cout, taps, x_bf16, dups = CASES[case]
    rng = np.random.RandomState(len(case))
    x = torch.from_numpy(np.maximum(rng.randn(B, n, cin), 0).astype(np.float32))
    for b, r0, length in dups:
        x[b, r0:r0 + length] = 3.0 * x[b, r0]
    if x_bf16:
        x = x.to(torch.bfloat16)
    w3 = torch.from_numpy((rng.randn(taps, cin, cout) / np.sqrt(taps * cin))
                          .astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(0.1 * rng.randn(cout).astype(np.float32)).to(
        torch.bfloat16).float()
    g = torch.from_numpy(rng.randn(B, cout).astype(np.float32))
    g[:, ::7] = 0.0  # columns without a cotangent
    return x, w3, bias, g


def _oracle_z(x, w3, bias):
    """The emulated forward's activations: one float32 chain over k' = t cin
    + k from 0 (x shifted per tap), each term an exact product of bf16
    values, then + bias."""
    B, n, cin = x.shape
    taps, _, cout = w3.shape
    xs = x.to(torch.bfloat16).float().numpy()  # the kernel rounds float32 x
    if taps == 3:
        zero = np.zeros((B, 1, cin), np.float32)
        xs = np.concatenate([np.concatenate([zero, xs[:, :-1]], 1), xs,
                             np.concatenate([xs[:, 1:], zero], 1)], axis=2)
    a = xs.reshape(B * n, taps * cin)
    w = w3.float().numpy().reshape(taps * cin, cout)
    acc = np.zeros((B * n, cout), np.float32)
    for k in range(taps * cin):
        acc = acc + a[:, k:k + 1] * w[k]
    return torch.from_numpy((acc + bias.numpy()).reshape(B, n, cout))


def _run(emulated, case):
    exe, build, cache = emulated
    if case in cache:
        return cache[case]
    B, n, cin, cout, taps, x_bf16, _ = CASES[case]
    x, w3, bias, g = _inputs(case)
    tag = re.sub(r"\W+", "_", case)
    src, dst = build / f"in_{tag}.bin", build / f"out_{tag}.bin"
    xb = x.view(torch.int16) if x_bf16 else x
    src.write_bytes(b"".join(t.numpy().tobytes() for t in
                             (xb, w3.view(torch.int16), bias, g)))
    res = subprocess.run([str(exe), str(src), str(dst), str(B), str(n), str(cin),
                          str(cout), str(taps), str(x_bf16)],
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    raw = dst.read_bytes()
    no, nx = B * cout, B * n * cin
    f = np.frombuffer(raw, np.float32)
    i = np.frombuffer(raw, np.int32)
    assert f.size == no * 6 + nx
    out = (torch.from_numpy(f[:no].reshape(B, cout).copy()),
           torch.from_numpy(i[no:2 * no].reshape(B, cout).copy()),
           torch.from_numpy(i[2 * no:6 * no].reshape(B, cout, pk.MAX_TIES).copy()),
           torch.from_numpy(f[6 * no:].reshape(B, n, cin).copy()))
    cache[case] = out
    return out


def _wgmma_case(build, k, n):
    """The stand-in's D [64, n] for W [k, 128] and x [n, k] of a seed, and
    numpy's: each output one float32 sum of exact bf16 products from 0, k
    ascending."""
    rng = np.random.RandomState(k + n)
    w = torch.from_numpy(rng.randn(k, 128).astype(np.float32)).to(torch.bfloat16)
    x = torch.from_numpy(rng.randn(n, k).astype(np.float32)).to(torch.bfloat16)
    src, dst = build / f"wgmma_{k}_{n}.bin", build / f"wgmma_{k}_{n}.out"
    src.write_bytes(w.view(torch.int16).numpy().tobytes() + x.view(torch.int16).numpy().tobytes())
    res = subprocess.run([str(build / "wgmma"), str(src), str(dst), str(k), str(n)],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    got = np.frombuffer(dst.read_bytes(), np.float32).reshape(64, n)
    wf, xf = w.float().numpy()[:, 64:], x.float().numpy()
    want = np.zeros((64, n), np.float32)
    for kk in range(k):
        want = want + wf[kk][:, None] * xf[:, kk][None, :]
    return got, want


@pytest.mark.parametrize("k", [16, 48, 128])
def test_wgmma_stand_in_matches_numpy(emulated, k):
    """The header's wgmma (A from registers, B by a K-major descriptor) on
    the operands as the kernel lays them out (W^T's fragments from its
    staged weights, x^T as its operand buffer), against numpy: each output
    one float32 sum of exact bf16 products from 0, k ascending."""
    got, want = _wgmma_case(emulated[1], k, 64)
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("n", [128, 256])
def test_wgmma_stand_in_wider_n(emulated, n):
    """wgmma_bf16<N> at the other widths the grouped MLP's streamed kernels
    issue (csrc/group_mlp_bf16.cu), on the same operands N points wide."""
    got, want = _wgmma_case(emulated[1], 48, n)
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_source_matches_the_oracle(emulated, case):
    x, w3, bias, _ = _inputs(case)
    pooled, cnt, rows, _ = _run(emulated, case)
    want = pk.max_ties(_oracle_z(x, w3, bias))
    for got, ref, what in zip((pooled, cnt, rows), want, ("pooled", "cnt", "rows")):
        assert torch.equal(got, ref), f"{what}: {(got != ref).sum().item()} entries differ"
    if CASES[case][6]:
        assert (cnt > pk.MAX_TIES).any()  # the recompute path is taken


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_source_matches_the_oracle(emulated, case):
    x, w3, bias, g = _inputs(case)
    _, _, _, dx = _run(emulated, case)
    taps = w3.shape[0]
    z = _oracle_z(x, w3, bias).double()
    eq = z == z.amax(1, keepdim=True)
    coef = (g[:, None] / eq.sum(1, keepdim=True)).to(torch.bfloat16).double()
    m = torch.where(eq, coef, 0.0)
    w = w3.double()
    if taps == 1:
        want = m @ w[0].T
    else:
        want = m @ w[1].T
        want[:, :-1] += m[:, 1:] @ w[0].T
        want[:, 1:] += m[:, :-1] @ w[2].T
    err = (dx.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


# (cin, cout, taps, x's bytes, consumer warpgroups): the first four at one
# 128-channel block, then the victim's three pools, a cout of 384 and the
# widest cin the mma.sync plan admitted at each taps and x type (where 256
# channels do not fit, 128-channel blocks)
PLAN_SHAPES = [(128, 128, 3, 4, 2), (128, 128, 1, 4, 2), (128, 128, 1, 2, 2),
               (48, 128, 1, 2, 2), (128, 1024, 3, 4, 2), (128, 1024, 1, 4, 4),
               (128, 1024, 1, 2, 4), (128, 384, 1, 2, 4), (160, 1024, 3, 2, 2),
               (208, 1024, 1, 4, 2), (272, 1024, 1, 2, 2), (208, 1024, 1, 2, 4)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_shared_memory_plan_matches_the_wrapper(emulated, shape):
    exe, _, _ = emulated
    cin, cout, taps, xbytes, nwg = shape
    res = subprocess.run([str(exe), "plan", "-", "1", "1", str(cin), str(cout),
                          str(taps), str(int(xbytes == 2))],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    m = re.search(r"nwg=(\d+) smem=(\d+)", res.stdout)
    plan = tuple(map(int, m.groups()))
    assert plan == pk.bf16_plan(cin, cout, taps, xbytes)
    assert plan[0] == nwg and plan[1] <= pk.SMEM_MAX


def test_the_plan_admits_every_shape_the_mma_sync_plan_did():
    """The kernel before wgmma took any block whose shared memory (weights
    with 8 columns of padding, a 130-row bf16 slab, a 130-row staging buffer
    of x's type, the partials and states) fit 232,448 bytes; the new plan
    refuses none of those shapes."""
    for taps in (1, 3):
        for xbytes in (2, 4):
            for cin in range(16, 417, 16):
                old = (taps * cin * 136 * 2 + 130 * (cin + 8) * 2 + 130 * cin * xbytes
                       + 4 * 128 * 12 + 128 * (2 + pk.MAX_TIES) * 4)
                for cout in (128, 256, 384, 1024):
                    if old <= pk.SMEM_MAX:
                        assert pk.bf16_plan(cin, cout, taps, xbytes) is not None, (
                            cin, cout, taps, xbytes)
