"""Self-kNN selection and curvature: CUDA kernel wrappers, plain versions.

Replaces five kernels of geoa3_tpu/ops/pallas/kappa_kernel.py (exact
selection; the packed mode is a TPU layout option left for later):

  * `kappa_selmask`  <- `_kappa_selmask_kernel` (`kappa_selmask_call`)
  * `kappa_fwd`      <- `_kappa_fwd_kernel` (`_kappa_fwd_call`)
  * `curv_term`      <- `_curv_term_frommask_kernel`
                        (`curv_term_frommask_pallas`)
  * `kappa_frommask` <- `_kappa_frommask_kernel` (`_kappa_frommask_call`)
  * `kappa_bwd`      <- `_kappa_bwd_kernel` (`_kappa_bwd_call`)

Source: csrc/kappa.cu (+ csrc/select.cuh, the selection it shares with the
kNN). Bound on the H100: bytes, the [b, n, n] int8 mask written by the
selection or read by the other three (32 MB at the main path's
[32,1024,1024]). The selection streams the cloud through shared memory and
keeps each row's k best keys in a warp's registers, so it takes any n the
output fits; its distances are rounded step by step like
`pairwise_sqdist`, so masks are bitwise the plain version's. The mask
readers read each mask row once and give each of its members a lane
(`kappa_frommask` and `kappa_bwd`: a half-warp a row, the row's own
column, whose term is 0, left out); the gradients are summed with global
atomics. `curv_term` stages the cloud (12 n bytes of shared memory: n <=
MASK_MAX_N). `kappa_frommask` and `kappa_bwd` share one mask stream: each
block bulk-copies (TMA) its contiguous range of mask rows through a ring
of shared-memory stages while it stages the cloud (as float4, where it
fits; through L2 past n = 6,864), its normals and cotangents, and runs
each row from shared memory; they take the same n as `curv_term`.

Two forms of the pair term. The direct one, |unit(p_j - p_i) . n_i| with
unit(v) = v / max(|v|, 1e-12), is what the reference's normalize computes,
what the TPU's curvature term builds from per-plane differences and what
the JAX engine's CPU path composes: `kappa_fwd` and `curv_term` use it. The
expansion one, |n_i.p_j - n_i.p_i| / max(sqrt(d), 1e-12) with d from the
distance expansion and the square root (and its gradient) gated off where
d == 0, is the TPU's `_kappa_frommask_kernel` and the JAX package's composed
`knn_kappa_from_mask`: `kappa_frommask` uses it. `kappa_bwd` is the
gradient of either: see its docstring.
"""

from __future__ import annotations

import torch

from geoa3_tpu_torch.ops.distance import pairwise_sqdist, sqnorm3
from geoa3_tpu_torch.ops.kernels import _build

EPS = 1e-12  # the reference normalisation clamp (Lib/loss_utils.py:79)
MAX_K = 64  # the selection keeps a row's k best keys in two registers a lane
# curv_term stages the cloud as three float planes beside one list of k+1
# members and one partial sum for each of 16 warps in a block's 232,448
# bytes of shared memory; the other two mask readers take the same n.
MASK_MAX_N = (232448 - 16 * (MAX_K + 1) * 4 - 16 * 4) // 12  # 19,018


def select_idx_plain(cloud, k):
    """[b, n, k+1] int64: self first, then the k nearest other points in
    ascending distance, lowest index on ties (stable sort)."""
    d = pairwise_sqdist(cloud, cloud)
    d.diagonal(dim1=1, dim2=2).fill_(-1.0)
    return torch.sort(d, dim=-1, stable=True).indices[..., : k + 1]


def _mask_from_idx(idx, n):
    mask = torch.zeros(idx.shape[0], n, n, dtype=torch.int8, device=idx.device)
    return mask.scatter_(2, idx, 1)


def kappa_selmask_plain(cloud, k):
    """Plain PyTorch version of `kappa_selmask`."""
    return _mask_from_idx(select_idx_plain(cloud, k), cloud.shape[1])


def kappa_fwd_plain(cloud, normal, k):
    """Plain PyTorch version of `kappa_fwd`: the composed
    knn -> normalise -> |dot| -> mean of ops.knn_kappa."""
    idx = select_idx_plain(cloud, k)
    b, n, _ = cloud.shape
    nbr = torch.gather(
        cloud[:, None].expand(b, n, n, 3), 2,
        idx[..., 1:, None].expand(-1, -1, -1, 3),
    )  # [b, n, k, 3]
    return _kappa_direct(cloud, normal, nbr, k), _mask_from_idx(idx, n)


def _gated_sqrt(d):
    """sqrt(d) with the square root (and its infinite slope) gated off where
    d == 0: the value is 0 there and no gradient passes."""
    safe = d > 0
    return torch.where(safe, torch.where(safe, d, torch.ones_like(d)).sqrt(),
                       torch.zeros_like(d))


def _kappa_direct(cloud, normal, nbr, k):
    """sum over the neighbours nbr [b, n, *, 3] of |unit(p_j - p_i) . n_i| / k
    with the direct difference (differentiable in cloud and nbr; a neighbour
    on its centre adds 0 and passes no gradient)."""
    v = nbr - cloud[:, :, None, :]
    v = v / _gated_sqrt(sqnorm3(v)).clamp_min(EPS)[..., None]
    nrm = normal[:, :, None, :]
    dot = v[..., 0] * nrm[..., 0] + v[..., 1] * nrm[..., 1] + v[..., 2] * nrm[..., 2]
    return dot.abs().sum(-1) / k


def kappa_direct_from_mask_plain(cloud, normal, mask, k):
    """kappa_fwd's kappa with the selection read from `mask` (k+1 ones per
    row, self included; the self term is 0). Differentiable in cloud."""
    b, n, _ = cloud.shape
    cols = mask.nonzero()[:, 2]
    if cols.numel() != b * n * (k + 1):
        raise ValueError(f"mask rows must hold k+1 = {k + 1} members each")
    idx = cols.view(b, n, k + 1)
    nbr = torch.gather(
        cloud[:, None].expand(b, n, n, 3), 2,
        idx[..., None].expand(-1, -1, -1, 3),
    )
    return _kappa_direct(cloud, normal, nbr, k)


def kappa_from_mask_plain(cloud, normal, mask, k):
    """kappa_i = sum_j mask_ij |n_i.p_j - n_i.p_i| / max(r_ij, eps) / k with
    r_ij = sqrt(d_ij) gated to 0 where d_ij == 0 (differentiable in cloud)."""
    pn = (
        normal[:, :, None, 0] * cloud[:, None, :, 0]
        + normal[:, :, None, 1] * cloud[:, None, :, 1]
        + normal[:, :, None, 2] * cloud[:, None, :, 2]
    )  # [b, i, j] = n_i . p_j
    sdiag = pn.diagonal(dim1=1, dim2=2)
    r = _gated_sqrt(pairwise_sqdist(cloud, cloud))
    a = (pn - sdiag[..., None]).abs() / r.clamp_min(EPS)
    return (mask.to(cloud.dtype) * a).sum(-1) / k


def curv_term_plain(cloud, normal, ref, mask, k):
    """Plain PyTorch version of `curv_term`: the direct-form term from the
    mask's members and its gradient by autograd."""
    with torch.enable_grad():
        c = cloud.detach().requires_grad_(True)
        kappa = kappa_direct_from_mask_plain(c, normal, mask, k)
        curv = ((kappa - ref) ** 2).mean(-1)
        (grad,) = torch.autograd.grad(curv.sum(), c)
    return curv.detach(), grad


RADII = ("direct", "expansion")


def kappa_bwd_plain(cloud, normal, mask, g, k, radius):
    """Plain PyTorch version of `kappa_bwd`: autograd through the plain
    forward that `radius` names, with the mask held fixed."""
    fwd = {"direct": kappa_direct_from_mask_plain,
           "expansion": kappa_from_mask_plain}[radius]
    with torch.enable_grad():
        c = cloud.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(fwd(c, normal, mask, k), c, g)
    return grad


def _check_k(n, k, max_n=None):
    if not 0 <= k < n:
        raise ValueError(f"need 0 <= k < n, got k={k}, n={n}")
    if k > MAX_K:
        raise ValueError(f"the kappa kernels take k <= {MAX_K}, got {k}")
    if max_n is not None and n > max_n:
        raise ValueError(f"the mask-reading kappa kernels take n <= {max_n}, "
                         f"got {n}")


def kappa_selmask(cloud, k):
    """cloud [b, n, 3] -> [b, n, n] int8 membership mask: each row holds
    itself plus its k nearest other points (lowest index on ties). Any n
    whose mask fits; k <= MAX_K. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if not cloud.is_cuda:
        return kappa_selmask_plain(cloud, k)
    b, n, _ = cloud.shape
    _check_k(n, k)
    _build.check_cuda(cloud, "cloud", torch.float32, (b, n, 3))
    mask = torch.empty(b, n, n, dtype=torch.int8, device=cloud.device)
    _build.launch("geoa3_kappa_selmask", cloud, b, n, k, mask)
    kappa_selmask.launches += 1
    return mask


def kappa_fwd(cloud, normal, k):
    """cloud, normal [b, n, 3] -> (kappa [b, n], mask [b, n, n] int8) with
    kappa_i = mean over the k nearest other points j of
    |unit(p_j - p_i) . n_i|. Its gradient is `kappa_bwd(..., "direct")`.
    Any n whose mask fits; k <= MAX_K. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if not cloud.is_cuda:
        return kappa_fwd_plain(cloud, normal, k)
    b, n, _ = cloud.shape
    _check_k(n, k)
    _build.check_cuda(cloud, "cloud", torch.float32, (b, n, 3))
    _build.check_cuda(normal, "normal", torch.float32, (b, n, 3))
    kappa = torch.empty(b, n, dtype=torch.float32, device=cloud.device)
    mask = torch.empty(b, n, n, dtype=torch.int8, device=cloud.device)
    _build.launch("geoa3_kappa_fwd", cloud, normal, b, n, k, kappa, mask)
    kappa_fwd.launches += 1
    return kappa, mask


def curv_term(cloud, normal, ref, mask, k):
    """cloud, normal [b, n, 3], ref [b, n], mask [b, n, n] int8 (k+1
    members a row, self included) -> (curv [b] = mean_i (kappa_i - ref_i)^2,
    d curv / d cloud [b, n, 3]) with kappa in the direct form. n <=
    MASK_MAX_N. The kernel adds into outputs it zeroes on the stream with
    global atomics, so the sums vary in the last bits from run to run. CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if not cloud.is_cuda:
        return curv_term_plain(cloud, normal, ref, mask, k)
    b, n, _ = cloud.shape
    _check_k(n, k, MASK_MAX_N)
    _build.check_cuda(cloud, "cloud", torch.float32, (b, n, 3))
    _build.check_cuda(normal, "normal", torch.float32, (b, n, 3))
    _build.check_cuda(ref, "ref", torch.float32, (b, n))
    _build.check_cuda(mask, "mask", torch.int8, (b, n, n))
    curv = torch.empty(b, dtype=torch.float32, device=cloud.device)
    grad = torch.empty(b, n, 3, dtype=torch.float32, device=cloud.device)
    _build.launch("geoa3_curv_term", cloud, normal, ref, mask, b, n, k, curv,
                  grad)
    curv_term.launches += 1
    return curv, grad


def kappa_frommask(cloud, normal, mask, k):
    """cloud, normal [b, n, 3], mask [b, n, n] int8 -> kappa [b, n] =
    sum_j mask_ij |n_i.p_j - n_i.p_i| / max(r_ij, 1e-12) / k with r_ij the
    square root of the expansion distance (the TPU kernel's form). Its
    gradient is `kappa_bwd(..., "expansion")`. n <= MASK_MAX_N. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if not cloud.is_cuda:
        return kappa_from_mask_plain(cloud, normal, mask, k)
    b, n, _ = cloud.shape
    _check_k(n, k, MASK_MAX_N)
    _build.check_cuda(cloud, "cloud", torch.float32, (b, n, 3))
    _build.check_cuda(normal, "normal", torch.float32, (b, n, 3))
    _build.check_cuda(mask, "mask", torch.int8, (b, n, n))
    kappa = torch.empty(b, n, dtype=torch.float32, device=cloud.device)
    _build.launch("geoa3_kappa_frommask", cloud, normal, mask, b, n, k, kappa)
    kappa_frommask.launches += 1
    return kappa


def kappa_bwd(cloud, normal, mask, g, k, radius):
    """cloud, normal [b, n, 3], mask [b, n, n] int8, g [b, n] ->
    [b, n, 3] = sum_i g_i d kappa_i / d cloud, with the selection held fixed.

    The port has two kappa forwards with different radii, and the backward
    must be the gradient of the forward it belongs to:

      * radius="direct": `kappa_fwd`, r_ij = |p_j - p_i| from the direct
        difference;
      * radius="expansion": `kappa_frommask`, r_ij = the square root of
        the expansion distance, gated at 0.

    (The TPU package shares one backward because both its forwards use the
    expansion.) One device function, templated on the radius, serves both.
    |x|'(0) = 0 on the self column and on coincident points, and the radius
    passes no gradient at or below the 1e-12 clamp. Neighbour-side terms are
    added with atomics into an output the C entry zeroes on the stream, so
    sums vary in the last bits from run to run. n <= MASK_MAX_N. CPU tensors
    take the plain version; CUDA tensors launch the kernel."""
    if radius not in RADII:
        raise ValueError(f"radius must be one of {RADII}, got {radius!r}")
    if not cloud.is_cuda:
        return kappa_bwd_plain(cloud, normal, mask, g, k, radius)
    b, n, _ = cloud.shape
    _check_k(n, k, MASK_MAX_N)
    _build.check_cuda(cloud, "cloud", torch.float32, (b, n, 3))
    _build.check_cuda(normal, "normal", torch.float32, (b, n, 3))
    _build.check_cuda(mask, "mask", torch.int8, (b, n, n))
    _build.check_cuda(g, "g", torch.float32, (b, n))
    grad = torch.empty(b, n, 3, dtype=torch.float32, device=cloud.device)
    _build.launch("geoa3_kappa_bwd", cloud, normal, mask, g, b, n, k,
                  int(radius == "direct"), grad)
    kappa_bwd.launches += 1
    return grad


kappa_selmask.launches = 0
kappa_frommask.launches = 0
kappa_bwd.launches = 0
kappa_fwd.launches = 0
curv_term.launches = 0
