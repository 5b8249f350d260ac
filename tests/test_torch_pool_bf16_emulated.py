"""The single-pass bf16 pool kernels (geoa3_tpu_torch/csrc/pool_matmul_bf16.cu,
rows 6 and 7 in the bf16 victim's mode), compiled with g++ against
tests/cuda_emu/cuda_runtime.h and run on the CPU (tests/cuda_emu/pool_bf16.cpp).

The header's ldmatrix and mma.sync m16n8k16 stand-ins keep the PTX ISA's
fragment layouts and sum each output's 16 products k ascending, one fmaf a
term: so the emulated forward is one float32 chain over (tap, k) from 0,
then + bias, which a numpy oracle repeats exactly. The forward's whole
output (maximum, tie count, first four tied rows) is held bit-equal to the
oracle's; the backward within 1e-5 of the largest |dx| of a float64
backward through the oracle's ties, with the cotangent g / cnt rounded to
bf16 (the atomics sum in another order). The cases: conv5's taps 3 on
float32 x, taps 1 on bf16 and float32 x, two blocks a cloud, ragged and
one-warp clouds, the path's cin of 128, and runs of duplicated rows (more
than four ties: the backward's recompute path) within a warp, across the
warps of a tile and across tiles. The outputs start as NaN or -1 and the
program fails on a write past one; the forward's shared memory at each
case equals `pool_matmul_kernel.bf16_smem_bytes`.

The emulation checks the kernels' indices, fragment layouts, barriers,
ballots and atomics, not the tensor cores' rounding (no CPU oracle
reproduces it) nor speed: `chip_smoke.py` holds the kernels against their
plain versions on the card.
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
    exe = build / "pool_bf16"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "pool_bf16.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe, build, {}


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


@pytest.mark.parametrize("shape", [(128, 3, 4), (128, 1, 4), (128, 1, 2), (48, 1, 2)])
def test_shared_memory_plan_matches_the_wrapper(emulated, shape):
    exe, _, _ = emulated
    cin, taps, xbytes = shape
    res = subprocess.run([str(exe), "plan", "-", "1", "1", str(cin), "128",
                          str(taps), str(int(xbytes == 2))],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    smem = int(re.search(r"smem=(\d+)", res.stdout).group(1))
    assert smem == pk.bf16_smem_bytes(cin, taps, xbytes) <= pk.SMEM_MAX
