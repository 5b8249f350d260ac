"""The scatter-add CUDA source (geoa3_tpu_torch/csrc/scatter.cu), compiled
with g++ against tests/cuda_emu/cuda_runtime.h and run on the CPU
(tests/cuda_emu/scatter.cpp).

Row 13 (`geoa3_scatter_add_nc`, on `scatter_rows` of
csrc/scatter_rows.cuh) is held against `scatter_add_nc_plain` at 2e-5 of the
output's largest entry (float32 sums in another order: a group's first
index and its repeats summed first, the rest by atomics) on the indices the
gathers give it: SSG SA1 and SA2 ball indices, under-full balls (padding
repeats), a kNN's k = 17, three_interpolate's 3, and on a flat index whose
S is not a multiple of the group, C = 1, 5, 64, 130 and a cotangent one
float past alignment (scalar atomics), empty balls (every slot into point
0), out-of-range indices (dropped, a group's first index among them),
n = 1, S = 0, a group larger than S and a group of 1. Each case asserts the
plan the entry takes (float4 rows or not). Rows 2 and 14
(`geoa3_scatter_add_3t`, `geoa3_scatter_add_3`) are held against their
plain versions at 1e-5 of the largest entry: the shared route, the o2a
backward's strided planes, the global route past 19,370 rows and a kNN
index. The outputs start as NaN, so an entry's zeroing (or its whole
store) is checked, and the program fails on a write past the output.

The emulation runs the kernels' own index arithmetic and atomics, one
thread a CUDA thread; it says nothing of speed or of the card's memory
model, which `chip_smoke.py` covers on the card.
"""

from __future__ import annotations

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geoa3_tpu_torch.ops.kernels import ballquery_group_kernel as bk
from geoa3_tpu_torch.ops.kernels import fps_kernel as fk
from geoa3_tpu_torch.ops.kernels import scatter_kernel as sk
from geoa3_tpu_torch.workload import synthetic_batch
from tests.test_torch_group_mlp_emulated import CSRC, EMU, _rewrite


def _ball(seed, b, n, m, ns, radius):
    xyz, _ = synthetic_batch(b, n, seed, device="cpu")
    pick = fk.fps_plain(xyz, m).long()
    centres = torch.gather(xyz, 1, pick[..., None].expand(-1, -1, 3)).contiguous()
    return bk.ball_query_plain(xyz, centres, radius, ns), n


def _nearest(seed, b, n, m, k):
    """The k nearest of m known points for each of n points: [b, n, k]."""
    xyz, _ = synthetic_batch(b, n, seed, device="cpu")
    d = torch.cdist(xyz, xyz[:, :m])
    return d.topk(k, largest=False).indices.to(torch.int32), m


def _indices(kind, seed):
    """idx [b, ..., g] int32 and the output's rows."""
    rng = np.random.RandomState(seed)
    if kind == "sa1":
        return _ball(seed, 2, 1024, 40, 64, 0.2)
    if kind == "sa2":
        return _ball(seed, 2, 512, 24, 64, 0.4)
    if kind == "sparse":
        return _ball(seed, 2, 1024, 32, 64, 0.1)
    if kind == "knn":
        return _nearest(seed, 2, 256, 256, 17)
    if kind == "three":
        return _nearest(seed, 2, 256, 64, 3)
    if kind == "flat":
        return torch.from_numpy(rng.randint(0, 300, (2, 1000)).astype(np.int32)), 300
    if kind == "empty":
        return torch.zeros(2, 24, 64, dtype=torch.int32), 512
    if kind == "outside":
        idx = rng.randint(0, 200, (2, 40, 16))
        idx[rng.rand(*idx.shape) < 0.2] = 200  # n itself
        idx[rng.rand(*idx.shape) < 0.1] = -1
        idx[:, ::5, :] = idx[:, ::5, :1]  # repeats of the first index
        idx[0, 0, :3] = -7  # a group whose first index is outside, repeated
        idx[1, 3, 0] = 10**6
        return torch.from_numpy(idx.astype(np.int32)), 200
    if kind == "one":
        return torch.zeros(3, 10, 8, dtype=torch.int32), 1
    if kind == "none":
        return torch.zeros(2, 0, dtype=torch.int32), 50
    raise ValueError(kind)


# label -> (indices, C, group (None: the index's last dimension), shift of
# ct in floats, whether the entry must take float4 rows)
NC_CASES = {
    "SSG SA1 ball idx, C=128": ("sa1", 128, None, 0, 1),
    "SSG SA2 ball idx, C=128": ("sa2", 128, None, 0, 1),
    "under-full balls r=0.1 (padding repeats), C=128": ("sparse", 128, None, 0, 1),
    "knn_gather idx k=17, C=64 (half a warp idle)": ("knn", 64, None, 0, 1),
    "three_interpolate idx, C=128": ("three", 128, None, 0, 1),
    "flat S=1000, not a multiple of the group": ("flat", 128, 64, 0, 1),
    "C=1 (one lane a row)": ("sa2", 1, None, 0, 0),
    "C=5 (scalar rows)": ("sa2", 5, None, 0, 0),
    "C=130 (scalar rows past a warp)": ("sa2", 130, None, 0, 0),
    "ct one float past alignment, C=128": ("sa2", 128, None, 1, 0),
    "empty balls (every slot into point 0)": ("empty", 128, None, 0, 1),
    "out-of-range indices dropped, C=128": ("outside", 128, None, 0, 1),
    "out-of-range indices dropped, C=5": ("outside", 5, None, 0, 0),
    "n=1": ("one", 8, None, 0, 1),
    "S=0": ("none", 16, 64, 0, 1),
    "group larger than S": ("flat", 32, 5000, 0, 1),
    "group of 1": ("flat", 12, 1, 0, 1),
}

# label -> (entry, b, S, n, C (8: the [b, 8, S] planes), g)
ROW_2_14_CASES = {
    "row 2: [2,1024] into 1024, shared route": ("3t", 2, 1024, 1024, 3, 1),
    "row 2: the o2a backward's [b, 8, S] planes": ("3t", 2, 1024, 1024, 8, 1),
    "row 2: n=20000, global route": ("3t", 1, 3000, 20000, 3, 1),
    "row 14: kNN idx [2,256,17] into 256, out-of-range dropped": ("3", 2, 256 * 17, 256, 3, 17),
}


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The test program, built from the rewritten source."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the emulated kernel")
    build = tmp_path_factory.mktemp("scatter_emu")
    (build / "scatter_emu.cpp").write_text(_rewrite((CSRC / "scatter.cu").read_text()))
    exe = build / "scatter"
    res = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-Wno-unknown-pragmas", "-I", str(build), "-I", str(CSRC), "-I", str(EMU),
         str(EMU / "scatter.cpp"), "-o", str(exe)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, (res.stdout + res.stderr)[-4000:]
    return exe, build


def _run(emulated, entry, label, idx, ct, n, C, g, shift=0):
    exe, build = emulated
    b, S = idx.shape
    tag = re.sub(r"\W+", "_", label)
    src, dst = build / f"in_{tag}.bin", build / f"out_{tag}.bin"
    src.write_bytes(idx.numpy().astype(np.int32).tobytes()
                    + ct.numpy().astype(np.float32).tobytes())
    res = subprocess.run([str(exe), entry, str(src), str(dst), str(b), str(S),
                          str(n), str(C), str(g), str(shift)],
                         capture_output=True, text=True, timeout=300)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out
    oc = C if entry == "nc" else 3
    got = np.frombuffer(dst.read_bytes(), np.float32)
    assert got.size == b * n * oc
    return torch.from_numpy(got.reshape(b, n, oc).copy()), out


def _close(got, want, rel):
    """Within `rel` of want's largest entry; equal where want is all zeros.
    NaN (an element left unwritten) fails either way."""
    if not want.any():
        assert torch.equal(got, want)
        return
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item(), err


def test_the_launch_rewrite_keeps_every_launch():
    src = (CSRC / "scatter.cu").read_text()
    out = _rewrite(src)
    assert "<<<" not in out and out.count("emu_launch(") == src.count("<<<") > 0


def test_rows_13_and_15_share_one_row_scatter():
    """Row 13 runs row 15's `scatter_rows` from the shared header; the old
    one-thread-a-channel kernel and its header are gone."""
    assert not (CSRC / "scatter.cuh").exists()
    for name in ("scatter.cu", "ballquery_group.cu"):
        src = (CSRC / name).read_text()
        assert '#include "scatter_rows.cuh"' in src
        assert "scatter_rows" in src.split('#include "scatter_rows.cuh"')[1]
        assert "geoa3_scatter_nc_kernel" not in src


@pytest.mark.parametrize("case", sorted(NC_CASES))
def test_row_13_source_matches_the_plain_version(emulated, case):
    kind, C, group, shift, vec = NC_CASES[case]
    idx, n = _indices(kind, len(case))
    g = idx.shape[-1] if group is None else group
    b = idx.shape[0]
    flat = idx.reshape(b, -1)
    rng = np.random.RandomState(len(case) + 1)
    ct = torch.from_numpy(rng.randn(b, flat.shape[1], C).astype(np.float32))
    got, out = _run(emulated, "nc", case, flat, ct, n, C, g, shift)
    assert re.search(r"vec=(\d)", out).group(1) == str(vec), out
    want = sk.scatter_add_nc_plain(flat, ct, n)
    _close(got, want, 2e-5)
    if kind == "empty":
        assert not got[:, 1:].any()


@pytest.mark.parametrize("case", sorted(ROW_2_14_CASES))
def test_rows_2_and_14_source_match_their_plain_versions(emulated, case):
    entry, b, S, n, C, g = ROW_2_14_CASES[case]
    rng = np.random.RandomState(len(case))
    if entry == "3":
        idx, _ = _nearest(len(case), b, n, n, g)
        idx = idx.numpy().reshape(b, S)
        idx[:, ::97] = n  # dropped
        idx = torch.from_numpy(idx)
    else:
        idx = torch.from_numpy(rng.randint(0, n, (b, S)).astype(np.int32))
    ct = torch.from_numpy(rng.randn(b, C if C == 8 else S, S if C == 8 else 3)
                          .astype(np.float32))
    got, _ = _run(emulated, entry, case, idx, ct, n, C, g)
    if entry == "3":
        want = sk.scatter_add_3_plain(idx.reshape(b, S // g, g), ct.reshape(b, S // g, g, 3), n)
    else:
        view = ct[:, :3].transpose(1, 2) if C == 8 else ct
        want = sk.scatter_add_3t_plain(idx, view, n)
    _close(got, want, 1e-5)
