"""The single-pass bf16 grouped-MLP kernels (geoa3_tpu_torch/csrc/
group_mlp_bf16.cu, row 16 in the bf16 victims' mode), compiled with g++
against tests/cuda_emu/cuda_runtime.h and run on the CPU
(tests/cuda_emu/group_mlp_bf16.cpp).

The header's ldmatrix, mma.sync m16n8k16 and wgmma m64nNk16 stand-ins keep
the PTX ISA's fragment and canonical layouts and sum each output's 16
products k ascending, one fmaf a term: so each emulated layer is one float32
chain over its (padded) input channels from 0, then + bias, which an oracle
here repeats exactly, through the bf16 roundings of a1, a2 and the
cotangents. The forward's maxima and tie counts and the backward's dgx and
dgf are held bit-equal to that oracle, and the maxima also within one bf16
step of the plain version (`group_mlp_fwd_bf16_plain`, whose float32 sums
run in another order). Each direction runs the kernel its plan picks: the
one with resident weights wherever they fit beside a tile (on persistent
blocks for the case's SM count), else the streamed one (wgmma, the weights
bulk-copied slab by slab from `fold_mlp_bf16`'s packed streams; the
GroupAll widths up to cf = 976), else the staged one (where a1, a2 and layer
1's whole input of 64 rows do not fit beside two 32 KB stages, and in the
backward where the padded c2 passes 512 or c3 1024: `STAGED` and `KERNEL`
name those shapes); every bulk copy must read inside one input tensor. The cases: the victims' shapes at a few
groups (SSG SA1, SA2 and GroupAll, MSG SA1's three scales and GroupAll at
cf = 640, the GroupAll ones on 132 SMs, so that the forward splits layer 3
over two blocks a tile as on the H100), groups split over tiles (GroupAll;
ns = 100, whose second 64-row tile is ragged; ns = 200; and SA2's widths at
the shared-memory limit with ns = 300 in five parts on one block) with rows
tied across the parts, groups of 48 rows whose ties cross the streamed
forward's 16-row warp segments, more tiles than persistent blocks with a
ragged last tile, groups off the m16 tiles (ns = 24 and 33: the resident
forward's pool by rows), tiles whose rows or group values do not start and
end on 16-byte lines, widths past the resident plan (streamed, up to the
widest the streamed plan takes) and past the streamed plan (staged: widths
of 1024, and GroupAll at cf = 1024 in four 32-row parts, one ragged, whose
maxima tie across the parts and are merged by the finishing kernel), widths
that are not multiples of 16, and duplicated rows that tie inside one m16
tile and across the units of a group. Outputs start as NaN or -1 and the
program fails on a write past one; each plan (tile rows, parts, weight
stages, shared memory, tiles, blocks) must be the one
`group_mlp_kernel.bf16_plan` predicts, also at the victims' full shapes.

The emulation checks the kernels' indices, fragment layouts, staging and
barriers, not the tensor cores' rounding nor speed: `chip_smoke.py` holds
the kernels against their plain versions on the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite

# label -> (groups, ns, cf, widths, rows of each group that repeat its row 0,
# SMs the persistent grid is sized for)
CASES = {
    "SSG SA1 (one group a tile)": (3, 64, 0, (64, 64, 128), (1, 9, 40), 1),
    "SSG SA2 (cf=128)": (2, 64, 128, (128, 128, 256), (1, 2), 1),
    "SSG GroupAll (cf=256, split over tiles, ties across the parts)":
        (1, 128, 256, (256, 512, 1024), (1, 31, 32, 63, 64, 127), 132),
    "MSG SA1 ns=16 (groups a tile, a ragged last tile)":
        (13, 16, 0, (32, 32, 64), (3,), 1),
    "MSG SA1 ns=32": (5, 32, 0, (64, 64, 128), (31,), 1),
    "MSG SA1 ns=128 (a 96-column layer)": (2, 128, 0, (64, 96, 128), (5, 127), 1),
    "MSG GroupAll cf=640": (1, 128, 640, (256, 512, 1024), (1, 64, 100), 132),
    "GroupAll widths, ns=100 (a ragged 64-row tile), ties across the 64-row parts":
        (1, 100, 256, (256, 512, 1024), (1, 15, 16, 63, 64, 99), 132),
    "GroupAll widths, ns=48 (48-row groups, 16 padding rows a tile), ties across "
    "the 16-row warp segments": (3, 48, 0, (256, 512, 1024), (15, 16, 31, 32, 47), 1),
    "widths 512/512/1024 at cf=128 (the widest the streamed plan takes)":
        (1, 64, 128, (512, 512, 1024), (1, 63), 132),
    "widths 1024 (past the streamed plan: staged)": (1, 16, 0, (1024, 1024, 1024), (3,), 1),
    "GroupAll widths at cf=1024, ns=100 (past the streamed plan's whole input: staged, "
    "32-row parts, one ragged), ties across the parts":
        (1, 100, 1024, (256, 512, 1024), (1, 31, 32, 63, 64, 99), 1),
    "widths 24/40/36, ns=24, cf=16": (5, 24, 16, (24, 40, 36), (5, 23), 1),
    "ns=200 split in two, cf=32": (2, 200, 32, (32, 32, 64), (0, 127, 128, 199), 1),
    "5 tiles on 4 persistent blocks (2 SMs), a ragged last tile":
        (37, 16, 0, (32, 32, 64), (7,), 2),
    "SA2 widths at the shared-memory limit, ns=300 in 5 parts on one block":
        (2, 300, 128, (128, 128, 256), (0, 63, 64, 299), 1),
    # past the resident plan: the staged kernels took it when the case was
    # named, the streamed ones do now (`STREAMED`); the name is the test's id
    "widths 128/256/512 at cf=128 (past the resident plan: staged)":
        (1, 32, 128, (128, 256, 512), (1, 31), 1),
    "ns=33, c3=37 (gx, group values and dgx off 16-byte lines: read and "
    "stored in place)": (7, 33, 0, (32, 32, 37), (4, 32), 1),
    "ns=24 (groups off m16 tiles), 5 tiles on 2 persistent blocks, a ragged "
    "last tile": (23, 24, 0, (32, 32, 64), (3, 23), 1),
}

# the cases whose kernels are the streamed ones (weights past the resident
# plan), and those past the streamed plan too (the staged ones)
STREAMED = {"SSG GroupAll (cf=256, split over tiles, ties across the parts)",
            "MSG GroupAll cf=640",
            "GroupAll widths, ns=100 (a ragged 64-row tile), ties across the 64-row parts",
            "GroupAll widths, ns=48 (48-row groups, 16 padding rows a tile), ties across "
            "the 16-row warp segments",
            "widths 512/512/1024 at cf=128 (the widest the streamed plan takes)",
            "widths 128/256/512 at cf=128 (past the resident plan: staged)"}
STAGED = {"widths 1024 (past the streamed plan: staged)",
          "GroupAll widths at cf=1024, ns=100 (past the streamed plan's whole input: "
          "staged, 32-row parts, one ragged), ties across the parts"}

# the victims' full shapes (groups at b = 32), planned only
PLANS = {
    "SSG SA1": (16384, 64, 0, (64, 64, 128)),
    "SSG SA2": (4096, 64, 128, (128, 128, 256)),
    "SSG GroupAll": (32, 128, 256, (256, 512, 1024)),
    "MSG SA1 ns=16": (16384, 16, 0, (32, 32, 64)),
    "MSG SA1 ns=32": (16384, 32, 0, (64, 64, 128)),
    "MSG SA1 ns=128": (16384, 128, 0, (64, 96, 128)),
    "MSG GroupAll": (32, 128, 640, (256, 512, 1024)),
    "widths 1024, cf=4096": (32, 128, 4096, (1024, 1024, 1024)),
    "GroupAll widths, cf=1024": (32, 128, 1024, (256, 512, 1024)),
    "widths 256/1024/1024, cf=128": (32, 128, 128, (256, 1024, 1024)),
    "widths 256/512/2048, cf=256": (32, 128, 256, (256, 512, 2048)),
}

# the device kernels (forward, backward) each full shape's plan picks: the
# resident weights serve every victim shape but GroupAll's, the streamed
# kernels GroupAll; the staged ones every shape past the streamed plan:
# where a1 and a2 of 64 rows (widths padded to 128) and layer 1's whole
# input [64][cf] do not fit beside two 32 KB stages (widths of 1024; c1 +
# c2 past about 1280; GroupAll's widths at cf >= 992), and in the backward
# also where c2 (padded to 128) passes 512 or c3 1024
KERNEL = {"SSG GroupAll": ("wgmma", "wgmma"), "MSG GroupAll": ("wgmma", "wgmma"),
          "widths 1024, cf=4096": ("tiles", "tiles"),
          "GroupAll widths, cf=1024": ("tiles", "tiles"),
          "widths 256/1024/1024, cf=128": ("tiles", "tiles"),
          "widths 256/512/2048, cf=256": ("wgmma", "tiles")}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("group_mlp_bf16_emu")
    (build / "group_mlp_bf16_emu.cpp").write_text(
        _rewrite((CSRC / "group_mlp_bf16.cu").read_text()))
    exe = build / "group_mlp_bf16"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "group_mlp_bf16.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe, build, {}


def _inputs(case):
    """gx, gf (bf16; the tied rows repeat their group's row 0), the fold
    (bf16 weights at He-like scale, bf16 biases) and g (float32 holding bf16
    values, some entries 0)."""
    groups, ns, cf, widths, tied, _ = CASES[case]
    rng = np.random.RandomState(len(case))
    gx = torch.from_numpy(0.3 * rng.randn(groups, 1, ns, 3).astype(np.float32))
    gf = (torch.from_numpy(np.maximum(rng.randn(groups, 1, ns, cf), 0).astype(np.float32))
          if cf else None)
    for t in (gx, gf):
        if t is not None and tied:
            t[:, :, list(tied)] = t[:, :, :1].clone()
    parts, cin = [], 3 + cf
    for w in widths:
        parts.append(torch.from_numpy((rng.randn(cin, w) * np.sqrt(2.0 / cin))
                                      .astype(np.float32)))
        parts.append(torch.from_numpy(0.1 * rng.randn(w).astype(np.float32)))
        cin = w
    p = gk.fold_mlp_bf16(*parts)
    g = torch.from_numpy(rng.randn(groups, 1, widths[-1]).astype(np.float32))
    g[..., ::5] = 0.0
    g = g.to(torch.bfloat16).float()
    return (gx.to(torch.bfloat16), None if gf is None else gf.to(torch.bfloat16), p, g)


def _run(emulated, case):
    exe, build, cache = emulated
    if case in cache:
        return cache[case]
    groups, ns, cf, (c1, c2, c3), _, sms = CASES[case]
    gx, gf, p, g = _inputs(case)
    bits = lambda t: t.contiguous().view(torch.int16).numpy().tobytes()  # noqa: E731
    blob = [bits(gx), bits(gf) if gf is not None else b""]
    for name in ("kw1", "kb1", "kw2", "kb2", "kw3", "kb3", "kw1t", "kw2t", "kw3t", "kpf",
                 "kpb"):
        t = getattr(p, name)
        blob.append(t.numpy().tobytes() if t.dtype == torch.float32 else bits(t))
    blob.append(g.numpy().tobytes())
    tag = re.sub(r"\W+", "_", case)
    src, dst = build / f"in_{tag}.bin", build / f"out_{tag}.bin"
    src.write_bytes(b"".join(blob))
    res = subprocess.run([str(exe), str(src), str(dst), str(groups), str(ns),
                          str(cf), str(c1), str(c2), str(c3), str(p.kpf.numel()),
                          str(p.kpb.numel()), str(sms)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    raw = dst.read_bytes()
    no, rows = groups * c3, groups * ns
    f = np.frombuffer(raw, np.float32)
    i = np.frombuffer(raw, np.int32)
    assert f.size == 2 * no + rows * (3 + cf)
    out = dict(
        pooled=torch.from_numpy(f[:no].reshape(groups, 1, c3).copy()),
        cnt=torch.from_numpy(i[no:2 * no].reshape(groups, 1, c3).copy()),
        dgx=torch.from_numpy(f[2 * no:2 * no + rows * 3].reshape(groups, 1, ns, 3).copy()),
        dgf=torch.from_numpy(f[2 * no + rows * 3:].reshape(groups, 1, ns, cf).copy()),
        plans=res.stdout)
    cache[case] = out
    return out


def _chain(a, w):
    """a [R, K] @ w [K, N] as one float32 chain from 0, k ascending (the
    emulated mma's order; the products of bf16 values are exact)."""
    acc = torch.zeros(a.shape[0], w.shape[1])
    for k in range(a.shape[1]):
        acc = acc + a[:, k:k + 1] * w[k]
    return acc


def _oracle(case):
    """The emulated kernels' outputs, step by step: the padded layers as
    fmaf chains, the pool, and the backward through the same roundings."""
    groups, ns, cf, (c1, c2, c3), _, _ = CASES[case]
    gx, gf, p, g = _inputs(case)
    x = torch.zeros(groups * ns, 16 + cf)
    x[:, :3] = gx.float().reshape(-1, 3)
    if gf is not None:
        x[:, 16:] = gf.float().reshape(-1, cf)
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    a1 = r(torch.relu(_chain(x, p.kw1.float()) + p.kb1))
    a2 = r(torch.relu(_chain(a1, p.kw2.float()) + p.kb2))
    a3 = torch.relu(_chain(a2, p.kw3.float()) + p.kb3)[:, :c3].reshape(groups, 1, ns, c3)
    pooled = a3.amax(dim=2)
    eq = (a3 == pooled[:, :, None]) & (a3 > 0)
    cnt = (a3 == pooled[:, :, None]).sum(dim=2, dtype=torch.int32)
    d3 = torch.zeros(groups * ns, p.kw3.shape[1])
    d3[:, :c3] = r(torch.where(eq, (g / cnt)[:, :, None], 0.0)).reshape(-1, c3)
    d2 = r(torch.where(a2 > 0, _chain(d3, p.kw3t.float()), 0.0))
    d1 = r(torch.where(a1 > 0, _chain(d2, p.kw2t.float()), 0.0))
    d0 = _chain(d1, p.kw1t.float())
    return dict(pooled=pooled, cnt=cnt, dgx=d0[:, :3].reshape(groups, 1, ns, 3),
                dgf=d0[:, 16:].reshape(groups, 1, ns, cf))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_source_matches_the_oracle(emulated, case):
    got, want = _run(emulated, case), _oracle(case)
    for what in ("pooled", "cnt"):
        assert torch.equal(got[what], want[what]), (
            f"{what}: {(got[what] != want[what]).sum().item()} entries differ")
    gx, gf, p, _ = _inputs(case)
    plain, _ = gk.group_mlp_fwd_bf16_plain(gx, gf, p)
    assert (got["pooled"] - plain).abs().max() <= 2.0 ** -8 * plain.abs().max()
    if CASES[case][4]:
        assert (got["cnt"] > 1).any()  # the repeated rows tie


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_source_matches_the_oracle(emulated, case):
    got, want = _run(emulated, case), _oracle(case)
    for what in ("dgx", "dgf"):
        assert torch.equal(got[what], want[what]), (
            f"{what}: {(got[what] != want[what]).sum().item()} entries differ")
    assert got["dgx"].abs().max() > 0  # some cotangent reached the rows


def _plan(out, which):
    """A printed plan ("fwd" or "bwd"): rows, parts, smem, depth, tiles,
    grid."""
    return tuple(map(int, re.search(
        which + r" rows=(\d+) parts=(\d+) smem=(\d+) depth=(\d+) tiles=(\d+) grid=(\d+)",
        out).groups()))


def _kind(out, which):
    """The kernel a printed plan runs: resident, wgmma or tiles."""
    return re.search(which + r" rows=.* kind=(\w+)", out).group(1)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plans_match_the_wrapper(emulated, case):
    groups, ns, cf, widths, _, sms = CASES[case]
    out = _run(emulated, case)["plans"]
    for which in ("fwd", "bwd"):
        rows, parts, smem, depth, tiles, grid = _plan(out, which)
        plan = gk.bf16_plan(ns, cf, widths, which == "bwd")
        assert (rows, parts, smem, depth) == (plan.rows, plan.parts, plan.smem,
                                              plan.depth), out
        assert _kind(out, which) == plan.kind, out
        assert (plan.kind == "wgmma") == (0 < depth < 32) == (case in STREAMED), out
        assert (plan.kind == "tiles") == (depth == 32) == (case in STAGED), out
        if 0 < depth < 32:  # 64-row tiles, groups on 16-row segments
            assert tiles == (groups * parts if parts > 1
                             else -(-groups // (64 // (-(-ns // 16) * 16))))
            assert grid == gk.bf16_wgmma_grid(groups, ns, cf, widths, which == "bwd",
                                              sms), out
            continue
        assert tiles == (groups * parts if parts > 1 else -(-groups // (rows // ns)))
        if depth == 0:  # persistent: as many blocks as 1-2 an SM, at most one a tile
            assert grid == min(tiles, sms * (2 if smem <= 113 * 1024 else 1)), out
        else:  # a block a tile
            assert grid == tiles, out


@pytest.mark.parametrize("shape", sorted(PLANS))
def test_full_shapes_plan_as_the_wrapper(emulated, shape):
    exe, _, _ = emulated
    groups, ns, cf, widths = PLANS[shape]
    res = subprocess.run([str(exe), "plan", "-", str(groups), str(ns), str(cf),
                          *map(str, widths)], capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    for which, kind in zip(("fwd", "bwd"), KERNEL.get(shape, ("resident", "resident"))):
        rows, parts, smem, depth = _plan(res.stdout, which)[:4]
        plan = gk.bf16_plan(ns, cf, widths, which == "bwd")
        assert (rows, parts, smem, depth) == (plan.rows, plan.parts, plan.smem,
                                              plan.depth) and smem <= 232448, res.stdout
        assert _kind(res.stdout, which) == plan.kind == kind, res.stdout
        assert gk.bf16_kernel(ns, cf, widths, which == "bwd") == (
            f"gmlp_bf16_{which}_{kind}"), res.stdout
