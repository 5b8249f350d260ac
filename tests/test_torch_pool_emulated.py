"""The float32 pool kernels (geoa3_tpu_torch/csrc/pool_matmul.cu, rows 6 and
7: `pool_fwd_kernel` and the gather of csrc/pool_gather.cuh), compiled with
g++ against tests/cuda_emu/cuda_runtime.h and run on the CPU
(tests/cuda_emu/pool_f32.cpp).

The forward's whole output (maximum, tie count, first four tied rows) is
held against `pool_ties_plain` in float64: the maximum within 1e-5 of the
largest |z|, the counts and rows equal on the columns whose maximum stands
clear of every other value by 1e-4 of the largest |z| (there a float32 and a
float64 sum must find the same rows), which include the exact ties that
duplicated rows make. The pooled cotangent g is zero on the other columns,
as phase 2 of `chip_smoke.py` keeps it (two products may rightly pick
different rows there).

The backward (a gather over dx's rows, no memset) is held bit-equal to a
torch float32 oracle that sums in its stated order: each tile's entries
(row, column, tap) of tied rows with a cotangent, the ties taken from the
forward's recorded rows (past four ties, from the duplicated run that makes
them, whose size must equal the forward's count), sorted by row (then
column, tap), split into as many equal chunks as the block has warps (the
program prints the tile's rows, its warps and the entries it keeps); a
row's run in a chunk summed from 0, its runs added in chunk order from 0,
each product g / cnt * w3 rounded to float32 on its own. And dx is held
within 1e-5 of the largest |dx| of the float64 autograd of
`pool_affine_max_plain`. The outputs start as NaN or -1 and the program
fails on a write past one and on a bulk copy outside g, cnt and rows.

The cases: taps 1 and 3; the path's cin of 128 beside narrower ones and the
widest the forward takes (368: three 128-channel slices of the gather); a
cout of 128, 256, 384, 512 and 1280 (two passes of the backward's column
scan); n = 1, 7, ragged at the 128-row tile (200) and three tiles (260);
runs of duplicated rows (more than four ties: the recompute `tied_rows32`)
within the forward's 16-row groups, across them, across 128-row tiles and at
both ends of the cloud at taps 3 (the recompute's window past the cloud);
critical points at rows 0 and n - 1; one critical point winning most
columns (a row's entries split across the backward's warps); half the
columns with g = 0; clouds of identical rows (a tile with more entries than
it keeps: the walk of the columns again). The float32 entry refuses no
shape the kernel before the gather took, and the forward's shared memory
plan agrees with the wrapper's `MAX_CIN`.

The emulation checks the kernels' indices, barriers, ballots (the forward's
per half-warp), matches and float operations, not speed nor the memory
model: `chip_smoke.py` holds the kernels against their plain versions on
the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import zlib

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import pool_matmul_kernel as pk
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

# label -> (B, n, cin, cout, taps, duplicated runs: (cloud, first row,
# length), and what else the inputs hold: "critical" (row 40 of cloud 0
# scaled 8x), "ends" (rows 0 and n - 1 scaled 4x), "half_g" (half the
# columns without a cotangent), "same" (every row of cloud 0 alike))
CASES = {
    "taps 3, n=200 (ragged at the 128-row tile)": (2, 200, 32, 128, 3, ()),
    "taps 1, n=200, cout=256": (2, 200, 32, 256, 1, ()),
    "the path's cin=128, taps 3": (1, 130, 128, 128, 3, ()),
    "the path's cin=128, taps 1, cout=256": (1, 80, 128, 256, 1, ()),
    "cin=368 (the widest the forward takes), taps 3": (1, 20, 368, 128, 3, ()),
    "n=1, taps 3": (2, 1, 16, 128, 3, ()),
    "n=1, taps 1": (1, 1, 16, 128, 1, ()),
    "n=7 (one partial warp), taps 3": (2, 7, 16, 128, 3, ()),
    "n=260 (three tiles), taps 1": (1, 260, 16, 128, 1, ()),
    "cout=384, taps 1": (2, 90, 32, 384, 1, ()),
    "cout=1280 (two passes of the column scan), taps 3": (1, 200, 16, 1280, 3, ()),
    "duplicated rows in a 16-row group and across groups, taps 3":
        (2, 90, 32, 128, 3, ((0, 10, 7), (1, 29, 6))),
    "duplicated rows across 16-row groups, the path's cin, taps 1":
        (1, 70, 128, 128, 1, ((0, 3, 20),)),
    "duplicated rows across 128-row tiles, taps 1": (1, 260, 32, 128, 1, ((0, 124, 9),)),
    "duplicated rows across a 128-row tile, taps 3": (1, 200, 32, 128, 3, ((0, 122, 12),)),
    "duplicated rows at both ends of the cloud, taps 3":
        (1, 140, 16, 128, 3, ((0, 0, 10), (0, 130, 10))),
    "critical points at rows 0 and n-1, taps 3": (2, 99, 32, 256, 3, (), "ends"),
    "a critical point winning most columns, taps 3": (1, 100, 32, 512, 3, (), "critical"),
    "half the columns without a cotangent, taps 3": (2, 120, 32, 256, 3, (), "half_g"),
    "every row alike (more entries than a tile keeps), taps 3": (1, 150, 16, 128, 3, (), "same"),
    "every row alike (more entries than a tile keeps), taps 1": (1, 150, 16, 128, 1, (), "same"),
}


def _case(case):
    """(B, n, cin, cout, taps, duplicated runs, extra)."""
    spec = CASES[case]
    return spec + ("",) * (7 - len(spec))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("pool_f32_emu")
    (build / "pool_matmul_emu.cpp").write_text(
        _rewrite((CSRC / "pool_matmul.cu").read_text()))
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "pool_f32.cpp"), "-o", str(build / "pool_f32")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-4000:]
    return build / "pool_f32", build, {}


def _inputs(case):
    """x, w3, bias, g and the held columns [B, cout] (maximum clear of every
    other value in float64; g is zero off them); the duplicated runs repeat
    3x their first row, so they hold the maximum of many columns."""
    B, n, cin, cout, taps, dups, extra = _case(case)
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    x = torch.from_numpy(np.maximum(rng.randn(B, n, cin), 0).astype(np.float32))
    for b, r0, length in dups:
        x[b, r0:r0 + length] = 3.0 * x[b, r0]
    if extra == "critical":
        x[0, 40] *= 8.0
    elif extra == "ends":
        x[:, 0] *= 4.0
        x[:, n - 1] *= 4.0
    elif extra == "same":
        x[0] = x[0, :1]
    w3 = torch.from_numpy((rng.randn(taps, cin, cout) / np.sqrt(taps * cin)).astype(np.float32))
    bias = torch.from_numpy(0.1 * rng.randn(cout).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, cout).astype(np.float32))
    g[:, ::7] = 0.0  # columns without a cotangent
    if extra == "half_g":
        g = torch.relu(g)  # as after the victim's ReLU
    z64 = pk.affine_plain(x.double(), w3.double(), bias.double())
    mx = z64.amax(1)
    runner_up = torch.where(z64 == mx[:, None], -torch.inf, z64).amax(1)
    held = (mx - runner_up) > 1e-4 * z64.abs().max()
    return x, w3, bias, g * held, held


def _run(emulated, case):
    exe, build, cache = emulated
    if case in cache:
        return cache[case]
    B, n, cin, cout, taps = _case(case)[:5]
    x, w3, bias, g, _ = _inputs(case)
    tag = re.sub(r"\W+", "_", case)
    src, dst = build / f"in_{tag}.bin", build / f"out_{tag}.bin"
    src.write_bytes(b"".join(t.numpy().tobytes() for t in (x, w3, bias, g)))
    res = subprocess.run([str(exe), str(src), str(dst), str(B), str(n), str(cin),
                          str(cout), str(taps)],
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    raw = dst.read_bytes()
    no, nx = B * cout, B * n * cin
    f = np.frombuffer(raw[:24 * no], np.float32)
    i = np.frombuffer(raw[:24 * no], np.int32)
    dxb = np.frombuffer(raw[24 * no:], np.float32)
    assert dxb.size == nx
    out = (torch.from_numpy(f[:no].reshape(B, cout).copy()),
           torch.from_numpy(i[no:2 * no].reshape(B, cout).copy()),
           torch.from_numpy(i[2 * no:6 * no].reshape(B, cout, pk.MAX_TIES).copy()),
           torch.from_numpy(dxb.reshape(B, n, cin).copy()))
    cache[case] = out
    return out


def _plan(emulated, *args):
    res = subprocess.run([str(emulated[0]), *map(str, args)],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def _bwd_tile(emulated):
    """(rows a tile, warps, entries a tile keeps, shared memory) of the
    backward, as the emulated source prints them."""
    out = _plan(emulated, "plan", "-", 1, 1, 16, 128, 1)
    m = re.search(r"bwd rows=(\d+) warps=(\d+) cap=(\d+) smem=(\d+)", out)
    return tuple(map(int, m.groups()))


def _tie_sets(x, w3, bias, g, cnt, rows, dups, extra):
    """[b][c] -> the rows tied at column c's maximum where g[b, c] != 0
    (else none): the forward's recorded rows where it counted at most four,
    else the float64 ties, which must number the forward's count and lie in
    a duplicated run."""
    B, n, _ = x.shape
    z64 = pk.affine_plain(x.double(), w3.double(), bias.double())
    eq64 = z64 == z64.amax(1, keepdim=True)
    in_run = torch.zeros(B, n, dtype=torch.bool)
    for b, r0, length in dups:
        in_run[b, r0:r0 + length] = True
    if extra == "same":
        in_run[0] = True
    ties = []
    for b in range(B):
        per_c = []
        for c in range(cnt.shape[1]):
            ct = int(cnt[b, c])
            if g[b, c] == 0:
                per_c.append([])
            elif ct <= pk.MAX_TIES:
                per_c.append(rows[b, c, :ct].tolist())
            else:
                tied = torch.nonzero(eq64[b, :, c]).flatten().tolist()
                assert len(tied) == ct, (b, c, len(tied), ct)
                assert rows[b, c].tolist() == tied[:pk.MAX_TIES], (b, c)
                assert bool(in_run[b, tied].all()), (b, c, tied)
                per_c.append(tied)
        ties.append(per_c)
    return ties


def _oracle_dx(x, w3, g, cnt, ties, tile, warps):
    """dx in float32, summed in the kernel's stated order through the tie
    sets, and per tile (entries, chunk, most entries on a row)."""
    B, n, cin = x.shape
    taps = w3.shape[0]
    coef = g / cnt.float()  # float32, as the kernel divides
    wt = w3.permute(0, 2, 1)  # w3t
    shift = [t - 1 for t in range(taps)] if taps == 3 else [0]
    dx = torch.zeros(B, n, cin)
    stats = []
    for b in range(B):
        cols = [(c, ps) for c, ps in enumerate(ties[b]) if ps]
        for r0 in range(0, n, tile):
            rv = min(tile, n - r0)
            ent = [(p + shift[t] - r0, c, t) for c, ps in cols
                   for t in range(taps) for p in ps if 0 <= p + shift[t] - r0 < rv]
            ent.sort(key=lambda e: e[0])  # stable: (column, tap) within a row
            chunk = -(-len(ent) // warps)
            per_row = {}
            for pos, (i, c, t) in enumerate(ent):
                per_row.setdefault(i, []).append((pos, c, t))
            for i, run in per_row.items():
                total, part = torch.zeros(cin), torch.zeros(cin)
                for pos, c, t in run:
                    if pos != run[0][0] and pos % chunk == 0:
                        total, part = total + part, torch.zeros(cin)
                    part = part + coef[b, c] * wt[t, c]
                dx[b, r0 + i] = total + part
            stats.append((len(ent), chunk, max((len(r) for r in per_row.values()), default=0)))
    return dx, stats


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_source_matches_float64(emulated, case):
    x, w3, bias, _, held = _inputs(case)
    pooled, cnt, rows, _ = _run(emulated, case)
    z64 = pk.affine_plain(x.double(), w3.double(), bias.double())
    err = (pooled.double() - z64.amax(1)).abs().max().item()
    assert err <= 1e-5 * z64.abs().max().item(), err
    _, cnt_p, rows_p = pk.pool_ties_plain(x.double(), w3.double(), bias.double())
    assert held.float().mean() > 0.9, held.float().mean()
    assert torch.equal(cnt[held], cnt_p[held]), int((cnt[held] != cnt_p[held]).sum())
    assert torch.equal(rows[held], rows_p[held]), int((rows[held] != rows_p[held]).sum())
    dups, extra = _case(case)[5:]
    if dups or extra == "same":
        assert (cnt[held] > pk.MAX_TIES).any()  # the backward's recompute path


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_source_matches_the_oracle(emulated, case):
    x, w3, bias, g, _ = _inputs(case)
    _, cnt, rows, dx = _run(emulated, case)
    dups, extra = _case(case)[5:]
    tile, warps, cap, _ = _bwd_tile(emulated)
    ties = _tie_sets(x, w3, bias, g, cnt, rows, dups, extra)
    sums, stats = _oracle_dx(x, w3, g, cnt, ties, tile, warps)
    differ = dx.view(torch.int32) != sums.view(torch.int32)
    assert not differ.any(), f"{int(differ.sum())} of {dx.numel()} dx elements differ"
    if extra == "critical":  # a row's entries split across the warps
        assert any(most > chunk for _, chunk, most in stats), stats
    if extra == "same":  # a tile past the entries it keeps
        assert any(e > cap for e, _, _ in stats), stats
    else:
        assert all(e <= cap for e, _, _ in stats), stats
    xg = x.double().requires_grad_(True)
    z = pk.pool_affine_max_plain(xg, w3.double(), bias.double())
    (want,) = torch.autograd.grad((z * g.double()).sum(), xg)
    err = (dx.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_the_entry_refuses_no_shape_the_kernel_before_it_took(emulated):
    """The kernel before the gather (a warp a column, atomics into a zeroed
    dx) launched whatever the wrapper passed: cin % 16 == 0 up to MAX_CIN,
    cout % 128 == 0, any B and n, taps 1 or 3. The gather's entry accepts
    every such shape (here up to cout = 4096), its tile is one fixed plan
    whose shared memory fits a block, and the emulated entry ran the
    extremes the victims' pools leave out (the cases above)."""
    out = _plan(emulated, "accepts", "-", pk.MAX_CIN, 4096)
    assert "refused=0" in out, out[-2000:]
    assert 0 < _bwd_tile(emulated)[3] <= pk.SMEM_MAX
    for case in ("cin=368 (the widest the forward takes), taps 3", "n=1, taps 1",
                 "cout=1280 (two passes of the column scan), taps 3"):
        _run(emulated, case)  # the entry accepted it and wrote every element


def test_the_forward_plan_matches_the_wrappers_widest_cin(emulated):
    """pool_fwd_smem (the x slab, the weight ring, the column states) fits a
    block at the wrapper's MAX_CIN and not 16 channels past it."""
    def smem(cin):
        out = _plan(emulated, "plan", "-", 1, 1, cin, 128, 3)
        return int(re.search(r"fwd smem=(\d+)", out).group(1))

    assert smem(pk.MAX_CIN) <= pk.SMEM_MAX < smem(pk.MAX_CIN + 16)
