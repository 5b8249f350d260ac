"""Build and load the port's hand-written CUDA kernels.

Every `geoa3_tpu_torch/csrc/*.cu` file exposes a plain C interface (pointers,
sizes and a stream in; the launch's `cudaGetLastError()` out). They are
compiled with `nvcc` for Hopper (`sm_90a`), one `nvcc -c` per source started
together, then linked into one shared library that `ctypes` loads. The
library lands in `build/kernels/` at the repository root (listed in
`.gitignore`), named by a hash of the sources and flags, so an edited source
is rebuilt on its next use and an unchanged one is reused.

Nothing here runs at import time: the first kernel launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_REPO = Path(__file__).resolve().parents[3]
CSRC = _REPO / "geoa3_tpu_torch" / "csrc"
BUILD_DIR = _REPO / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_VP = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C entry points: name -> argument types (every entry returns cudaError_t)
SIGNATURES = {
    # adv, ori, pay, b, n, m, keys (b*(n+m) int64 scratch), a2o, o2a, gp,
    # op, stream
    "geoa3_nn1_payload": [
        _VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    # adv, ori, b, n, m, keys, a2o, o2a, stream
    "geoa3_nn1_dual": [_VP, _VP, _I, _I, _I, _VP, _VP, _VP, _VP],
    # query, points, b, n, m, k, dists, idx, nbrs, stream
    "geoa3_knn": [_VP, _VP, _I, _I, _I, _I, _VP, _VP, _VP, _VP],
    # idx, ct, b, S, n, ct's batch/source/channel strides, out, stream
    "geoa3_scatter_add_3t": [_VP, _VP, _I, _I, _I, _LL, _LL, _LL, _VP, _VP],
    # idx, ct, b, n, k, m, out, stream
    "geoa3_scatter_add_3": [_VP, _VP, _I, _I, _I, _I, _VP, _VP],
    # idx, ct, b, S, n, C, g (sources a team owns), out (zeroed by the
    # entry), stream
    "geoa3_scatter_add_nc": [_VP, _VP, _I, _I, _I, _I, _I, _VP, _VP],
    # xyz, centres, feats (or null), w1, b1, w2, b2, w3, b3, b, n, m, ns, cf,
    # c1, c2, c3, r2, P, Yc, idx, pooled, cnt, scratch (or null: split
    # balls' partials), stream
    "geoa3_sa_fused_fwd": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
        _I, _I, _F, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    # P, Yc, idx, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt, gout, b, n,
    # m, ns, cf, c1, c2, c3, dP, dYc, dxyz, dcentres, dfeats (or null), stream
    "geoa3_sa_fused_bwd": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _I, _I, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _VP, _VP,
    ],
    # xyz, start (or null), b, n, m, skip, idx, stream
    "geoa3_fps": [_VP, _VP, _I, _I, _I, _I, _VP, _VP],
    # xyz, centres, feats (or null), b, n, m, ns, cf, r2, idx, gx, gf, stream
    "geoa3_ballquery_group_fwd": [
        _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP, _VP, _VP, _VP,
    ],
    # xyz, centres, b, n, m, ns, r2, idx, stream
    "geoa3_ball_query": [_VP, _VP, _I, _I, _I, _I, _F, _VP, _VP],
    # idx, dgx, dgf (or null), b, n, m, ns, cf, dxyz, dcentre, dfeats (or
    # null; dxyz and dfeats zeroed by the entry), stream
    "geoa3_ballquery_group_bwd": [
        _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP,
    ],
    # gx, gf (or null), w1, b1, w2, b2, w3, b3, groups, ns, cf, c1, c2, c3,
    # pooled, cnt, scratch (or null where ns <= 32), stream
    "geoa3_group_mlp_fwd": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP,
        _VP, _VP, _VP,
    ],
    # gx, gf (or null), w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pooled, cnt,
    # gout, groups, ns, cf, c1, c2, c3, dgx, dgf (or null), stream
    "geoa3_group_mlp_bwd": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _I, _I, _I, _I, _I, _I, _VP, _VP, _VP,
    ],
    # gx, gf (or null), w1, b1, w2, b2, w3, b3 (padded bf16 weights, float32
    # biases), pf (the streamed kernel's packed weights), groups, ns, cf, c1,
    # c2, c3, pooled, cnt, scratch (or null where no group is split), stream
    "geoa3_group_mlp_fwd_bf16": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP,
        _VP, _VP, _VP,
    ],
    # gx, gf (or null), w1, b1, w2, b2, w3, b3, w1t, w2t, w3t, pf, pb, pooled,
    # cnt, gout, groups, ns, cf, c1, c2, c3, dgx, dgf (or null), stream
    "geoa3_group_mlp_bwd_bf16": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP,
    ],
    # cloud, b, n, k, mask, stream
    "geoa3_kappa_selmask": [_VP, _I, _I, _I, _VP, _VP],
    # cloud, normal, b, n, k, kappa, mask, stream
    "geoa3_kappa_fwd": [_VP, _VP, _I, _I, _I, _VP, _VP, _VP],
    # cloud, normal, ref, mask, b, n, k, curv, grad, stream
    "geoa3_curv_term": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP],
    # cloud, normal, mask, b, n, k, kappa, stream
    "geoa3_kappa_frommask": [_VP, _VP, _VP, _I, _I, _I, _VP, _VP],
    # cloud, normal, mask, g, b, n, k, direct, grad, stream
    "geoa3_kappa_bwd": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _VP, _VP],
    # x, w3, bias, B, n, cin, cout, taps, pooled, cnt, rows, stream
    "geoa3_pool_fwd": [_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP],
    # w3t, pooled_g, cnt, rows, x, bias, pooled, w3, B, n, cin, cout, taps,
    # dx, stream
    "geoa3_pool_bwd": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP,
    ],
    # x, w3, bias, B, n, cin, cout, taps, x_bf16, pooled, cnt, rows, stream
    "geoa3_pool_fwd_bf16": [
        _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP, _VP, _VP, _VP,
    ],
    # w3t, pooled_g, cnt, rows, x, bias, pooled, w3, B, n, cin, cout, taps,
    # x_bf16, dx (x's type, written once), stream
    "geoa3_pool_bwd_bf16": [
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I, _VP,
        _VP,
    ],
}

_lock = threading.Lock()
_lib = None
_entries: dict = {}  # C entry name -> its ctypes function, bound at load


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link them into one .so; returns its
    path. A no-op when the library for the current sources already exists."""
    out = BUILD_DIR / f"libgeoa3_kernels_{_digest()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        objs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
            )))
        errors = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- {src.name} ---\n{log.decode()}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                *map(str, objs)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)
        if res.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + res.stdout.decode())
        os.replace(tmp_so, out)  # atomic: concurrent builds agree
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use). Loading binds every
    C entry of SIGNATURES once, into `_entries`."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(so, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _entries[name] = fn
            _lib = so
    return _lib


# set by utils.profiling.debug_nans: each launch then raises if it wrote a
# NaN into a floating-point argument that held none before it
check_nans = False


def _nan_free(args) -> list:
    return [isinstance(a, torch.Tensor) and a.is_floating_point()
            and not bool(torch.isnan(a).any()) for a in args]


def launch(name: str, *args) -> None:
    """Call C entry `name` with tensors (passed by data pointer; None is a
    null pointer), ints and floats, on the current CUDA stream; raise if the
    launch was refused. After the first load a call takes no lock and looks
    nothing up but `name` in a dict: ctypes converts the ints, floats and
    None by the entry's argtypes."""
    fn = _entries.get(name)
    if fn is None:
        lib()
        fn = _entries[name]
    clean = _nan_free(args) if check_nans else None
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
               for a in args], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    if clean is not None:
        made = [i for i, (was, now) in enumerate(zip(clean, _nan_free(args)))
                if was and not now]
        if made:
            raise FloatingPointError(f"{name} wrote a NaN into argument(s) {made}")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
               contiguous: bool = True) -> None:
    """Validate what a kernel takes: a CUDA tensor on the current card (the
    kernels run on its stream), of this dtype and shape (None in `shape`
    matches any size), contiguous unless the kernel reads it through its
    strides."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name}: a tensor on {t.device} while "
                         f"cuda:{torch.cuda.current_device()} is the current device")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
