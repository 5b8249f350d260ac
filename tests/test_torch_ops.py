"""The port's kernel families and ops against the JAX package, on the CPU.

Each kernel's plain PyTorch version (what the port runs on CPU tensors, and
what chip_smoke.py holds each CUDA kernel against on the card) is compared
with the JAX Pallas kernel it replaces, run as tests/test_pallas_kernels.py
runs it (TPU interpret mode, or CPU interpret mode for the pool kernel), and
each op with its geoa3_tpu.ops counterpart (the composed CPU path). Inputs
come from numpy seeds; b=2, n=128, k=8.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from geoa3_tpu import losses as jlosses
from geoa3_tpu import ops as jops
from geoa3_tpu_torch import losses as tlosses
from geoa3_tpu_torch import ops as tops
from geoa3_tpu_torch.ops import kernels as tk
from geoa3_tpu_torch.ops.kernels import kappa_kernel as kk
from geoa3_tpu_torch.ops.kernels import knn_kernel as qk
from geoa3_tpu_torch.ops.kernels import nn1_kernel as nk
from geoa3_tpu_torch.ops.kernels import pool_matmul_kernel as pk
from geoa3_tpu_torch.ops.kernels import scatter_kernel as sk

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
B, N, K = 2, 128, 8
# the TPU kernels' hi/lo split-bf16 products: ~2^-16 relative per term
HILO = 2.0**-15


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(seed, b=B, n=N):
    rng = np.random.RandomState(seed)
    c = rng.randn(b, n, 3).astype(np.float32)
    c /= np.linalg.norm(c, axis=-1, keepdims=True).max()
    nrm = rng.randn(b, n, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return c, nrm, rng


def _with_ties(c):
    """Exact duplicates: every distance to them ties exactly."""
    c = c.copy()
    c[0, 64] = c[0, 10]
    c[0, 65] = c[0, 10]
    c[1, 100] = c[1, 7]
    return c


# ---------------------------------------------------------------- nn1 ----


class TestNN1Payload:
    def _inputs(self, seed, ties=False):
        ori, _, rng = _cloud(seed)
        adv = (ori + 0.02 * rng.randn(*ori.shape)).astype(np.float32)
        if ties:
            ori = _with_ties(ori)
            adv[0, 3] = adv[0, 90]  # two adv rows tie for every ori column
            adv[1, 20] = ori[1, 7]  # an adv point on a duplicated ori point
        pay = rng.randn(B, 8, N).astype(np.float32)
        return adv, ori, pay

    @pytest.mark.parametrize("ties", [False, True])
    def test_plain_matches_pallas_kernel(self, ties):
        from geoa3_tpu.ops.pallas.nn1_kernel import nn1_dual_payload_pallas

        adv, ori, pay = self._inputs(0, ties)
        with pltpu.force_tpu_interpret_mode():
            want = nn1_dual_payload_pallas(
                jnp.asarray(adv), jnp.asarray(ori), jnp.asarray(pay),
                row_block=32, select="exact",
            )
        got = nk.nn1_dual_payload_plain(_t(adv), _t(ori), _t(pay))
        # indices exact; payload and coordinate copies bit-equal
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    @pytest.mark.parametrize("ties", [False, True])
    def test_op_matches_composed(self, ties):
        adv, ori, pay = self._inputs(1, ties)
        want = jops.nn1_dual_payload(
            jnp.asarray(adv), jnp.asarray(ori), jnp.asarray(pay)
        )
        got = tops.nn1_dual_payload(_t(adv), _t(ori), _t(pay))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_lowest_index_tie_break(self):
        adv, ori, pay = self._inputs(2, ties=True)
        a2o, o2a, _, _ = nk.nn1_dual_payload_plain(_t(adv), _t(ori), _t(pay))
        # adv row 20 sits on ori 7 == ori 100 of instance 1: lowest wins
        assert a2o[1, 20].item() == 7
        assert o2a[1, 7].item() == 20


# ------------------------------------------------------------ scatter ----


class TestScatter:
    def test_plain_matches_pallas_kernel(self):
        from geoa3_tpu.ops.pallas.scatter_kernel import scatter_add_3t_pallas

        rng = np.random.RandomState(3)
        idx = rng.randint(0, N, (B, N)).astype(np.int32)
        ct = rng.randn(B, N, 3).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = scatter_add_3t_pallas(jnp.asarray(idx), jnp.asarray(ct), N)
        got = sk.scatter_add_3t_plain(_t(idx), _t(ct), N)
        # split-bf16 one-hot products: 2^-16 of each summed term
        np.testing.assert_allclose(
            got.numpy(), np.asarray(want), rtol=HILO, atol=HILO * np.abs(ct).max()
        )

    @pytest.mark.parametrize("layout", ["rows", "planes"])
    @pytest.mark.parametrize("s", [N, N * (K + 1)])
    def test_wrapper_matches_pallas_kernel(self, layout, s):
        """`scatter_add_3t` with its cotangent as [b, S, 3] rows, or as the
        first three rows of [b, 8, S] planes seen through their strides (the
        o2a backward's layout), at S = n and at S = n (k + 1) sources."""
        from geoa3_tpu.ops.pallas.scatter_kernel import scatter_add_3t_pallas

        rng = np.random.RandomState(30 + s)
        idx = rng.randint(0, N, (B, s)).astype(np.int32)
        planes = rng.randn(B, 8, s).astype(np.float32)
        ct = np.ascontiguousarray(planes[:, :3].transpose(0, 2, 1))
        with pltpu.force_tpu_interpret_mode():
            want = scatter_add_3t_pallas(jnp.asarray(idx), jnp.asarray(ct), N)
        arg = _t(ct) if layout == "rows" else _t(planes)[:, :3].transpose(1, 2)
        got = sk.scatter_add_3t(_t(idx), arg, N)
        # split-bf16 one-hot products: 2^-16 of each summed term
        atol = HILO * (np.abs(ct).max() if s == N else np.abs(ct).sum(1).max())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=HILO,
                                   atol=atol)

    def test_o2a_coord_planes_grad_matches_composed(self):
        ori, _, rng = _cloud(4)
        adv = (ori + 0.02 * rng.randn(*ori.shape)).astype(np.float32)
        pay = np.zeros((B, 8, N), np.float32)
        w = rng.randn(B, 3, N).astype(np.float32)

        def jloss(p):
            _, o2a, _, op = jops.nn1_dual_payload(p, jnp.asarray(ori), jnp.asarray(pay))
            return jnp.sum(jops.o2a_coord_planes(p, o2a, op)[:, :3] ** 2 * w)

        want = jax.grad(jloss)(jnp.asarray(adv))
        p = _t(adv).requires_grad_(True)
        _, o2a, _, op = tops.nn1_dual_payload(p, _t(ori), _t(pay))
        (tops.o2a_coord_planes(p, o2a, op)[:, :3] ** 2 * _t(w)).sum().backward()
        # both sum the same few colliding cotangents in f32
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# -------------------------------------------------------------- kappa ----


class TestKappaSelection:
    @pytest.mark.parametrize("ties", [False, True])
    def test_plain_matches_pallas_kernel(self, ties):
        from geoa3_tpu.ops.pallas.kappa_kernel import kappa_selmask_call

        c, _, _ = _cloud(5)
        if ties:
            c = _with_ties(c)
        with pltpu.force_tpu_interpret_mode():
            want = kappa_selmask_call(jnp.asarray(c), K, 64, "exact")
        got = kk.kappa_selmask_plain(_t(c), K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.sum(-1) == K + 1).all()

    @pytest.mark.parametrize("ties", [False, True])
    def test_op_matches_composed(self, ties):
        c, _, _ = _cloud(6)
        if ties:
            c = _with_ties(c)
        want = jops.kappa_select_mask(jnp.asarray(c), K)
        got = tops.kappa_select_mask(_t(c), K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_duplicates_select_lowest_index(self):
        c = _with_ties(_cloud(7)[0])
        mask = kk.kappa_selmask_plain(_t(c), 1)
        # row 10's nearest other point is its duplicate 64 (d = 0; 64 < 65)
        assert mask[0, 10, 64] == 1 and mask[0, 10, 65] == 0
        assert mask[0, 65, 10] == 1 and mask[0, 65, 64] == 0


class TestKappaFwd:
    def test_plain_matches_pallas_kernel(self):
        from geoa3_tpu.ops.pallas.kappa_kernel import _kappa_fwd_call

        c, nrm, _ = _cloud(8)
        with pltpu.force_tpu_interpret_mode():
            wk, wm = _kappa_fwd_call(jnp.asarray(c), jnp.asarray(nrm), K, 64, "exact")
        gk, gm = kk.kappa_fwd_plain(_t(c), _t(nrm), K)
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
        # the TPU kernel's unit vectors come from the distance expansion
        # (documented ~1e-3 relative vs the direct difference used here)
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=1e-3, atol=1e-5)

    @pytest.mark.parametrize("ties", [False, True])
    def test_get_kappa_ori_matches_composed(self, ties):
        c, nrm, _ = _cloud(9)
        if ties:
            c = _with_ties(c)
        want = jlosses.get_kappa_ori(jnp.asarray(c), jnp.asarray(nrm), K)
        got = tlosses.get_kappa_ori(_t(c), _t(nrm), K)
        # same neighbours and per-pair terms; the mean sums in another order
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)

    def test_knn_kappa_is_forward_only(self):
        """Forward-only no longer: knn_kappa carries a gradient to the cloud
        (the kappa backward kernel's plain version here) and none to the
        normal."""
        c, nrm, _ = _cloud(10)
        p = _t(c).requires_grad_(True)
        q = _t(nrm).requires_grad_(True)
        tops.knn_kappa(p, q, K).sum().backward()
        assert q.grad is None
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0


class TestCurvTerm:
    def _inputs(self, seed):
        c, nrm, rng = _cloud(seed)
        ref = np.abs(rng.randn(B, N)).astype(np.float32)
        mask = np.asarray(jops.kappa_select_mask(jnp.asarray(c), K))
        moved = (c + 1e-3 * rng.randn(*c.shape)).astype(np.float32)  # stale mask
        return moved, nrm, ref, mask

    @staticmethod
    def _direct(nrm, ref, mask, k):
        """curv(x) [b] as the JAX engine's CPU lazy path composes it
        (geoa3_tpu/attack/engine.py:242-250): the mask's non-self members
        (ascending index) gathered with `knn_gather`, the direct differences
        normalised by max(|v|, 1e-12), |. n_i| averaged over k, then
        mean_i (kappa_i - ref_i)^2."""
        m = np.array(mask, copy=True)
        n = m.shape[1]
        m[:, np.arange(n), np.arange(n)] = 0
        idx = jnp.asarray(np.nonzero(m)[2].reshape(m.shape[0], n, k).astype(np.int32))

        def curv(x):
            v = jops.knn_gather(x, idx) - x[:, :, None, :]
            v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
            kap = jnp.abs(jnp.sum(v * jnp.asarray(nrm)[:, :, None, :], axis=-1)).mean(-1)
            return jnp.mean((kap - jnp.asarray(ref)) ** 2, axis=-1)

        return curv

    def test_plain_matches_pallas_kernel(self):
        from geoa3_tpu.ops.pallas.kappa_kernel import curv_term_frommask_pallas

        c, nrm, ref, mask = self._inputs(11)
        cw = np.array([0.7, 1.3], np.float32)
        args = (jnp.asarray(nrm), jnp.asarray(ref), jnp.asarray(mask))
        with pltpu.force_tpu_interpret_mode():
            want = curv_term_frommask_pallas(jnp.asarray(c), *args, K, 64)
            wgrad = jax.grad(
                lambda x: jnp.sum(cw * curv_term_frommask_pallas(x, *args, K, 64))
            )(jnp.asarray(c))
        p = _t(c).requires_grad_(True)
        got = tops.curv_term_from_mask(p, _t(nrm), _t(ref), _t(mask), K)
        (got * _t(cw)).sum().backward()
        # both take the direct form; what is left is the TPU kernel's hi/lo
        # split-bf16 products of n_i . p_j (~2^-16 relative a term), its
        # rsqrt and its factored weights (measured over four seeds: values
        # within 6e-7 relative, gradients within 7.1e-5 of the largest entry)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=5e-6, atol=1e-7)
        wg = np.asarray(wgrad)
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=0,
                                   atol=3e-4 * np.abs(wg).max())

    def test_value_and_grad_match_composed(self):
        c, nrm, ref, mask = self._inputs(12)
        cw = np.array([0.7, 1.3], np.float32)
        curv = self._direct(nrm, ref, mask, K)
        want = curv(jnp.asarray(c))
        wgrad = jax.grad(lambda x: jnp.sum(cw * curv(x)))(jnp.asarray(c))
        p = _t(c).requires_grad_(True)
        got = tops.curv_term_from_mask(p, _t(nrm), _t(ref), _t(mask), K)
        (got * _t(cw)).sum().backward()
        # the same direct composition on both sides; XLA and PyTorch sum in
        # other orders
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-4, atol=1e-6)

    def test_near_origin_ulp_pair_stays_finite(self):
        """Two points one ulp apart near the origin: the direct difference is
        one ulp, |v| ~ 7e-15 lies under the 1e-12 clamp, and the pair's
        gradient is n_i / 1e-12 times its weight: large, finite, and the
        composed direct path's on every row."""
        c, nrm, rng = _cloud(13)
        c[0, 5] = np.array([1e-7, -2e-7, 3e-7], np.float32)
        c[0, 6] = c[0, 5]
        c[0, 6, 0] = np.nextafter(c[0, 5, 0], np.float32(1.0))
        ref = np.abs(rng.randn(B, N)).astype(np.float32)
        mask = kk.kappa_selmask_plain(_t(c), K)
        assert mask[0, 5, 6] == 1
        p = _t(c).requires_grad_(True)
        val = tops.curv_term_from_mask(p, _t(nrm), _t(ref), mask, K)
        val.sum().backward()
        assert torch.isfinite(val).all() and torch.isfinite(p.grad).all()
        curv = self._direct(nrm, ref, mask.numpy(), K)
        want = curv(jnp.asarray(c))
        wgrad = jax.grad(lambda x: jnp.sum(curv(x)))(jnp.asarray(c))
        np.testing.assert_allclose(val.detach().numpy(), np.asarray(want), rtol=1e-5)
        assert np.abs(p.grad.numpy()[0, 5:7]).max() > 1e6  # the clamp binds
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(wgrad),
                                   rtol=1e-4, atol=1e-6)

    def test_direct_gradient_is_closer_to_float64_than_expansion(self):
        """On a cloud with close pairs (a second copy of a quarter of the
        points moved by 1e-4) the float32 gradient of the direct form is
        nearer its float64 evaluation than the expansion form's is to its
        own: the expansion's |p_i|^2 + |p_j|^2 - 2 p_i.p_j cancels in float32
        where the pair is close."""
        c, nrm, rng = _cloud(14)
        c[:, N // 2:N // 2 + N // 4] = c[:, :N // 4] + 1e-4 * rng.randn(B, N // 4, 3)
        ref = np.abs(rng.randn(B, N)).astype(np.float32)
        mask = kk.kappa_selmask_plain(_t(c), K)

        def expansion(x, nv, rv):
            with torch.enable_grad():
                x = x.detach().requires_grad_(True)
                kap = kk.kappa_from_mask_plain(x, nv, mask, K)
                (g,) = torch.autograd.grad(((kap - rv) ** 2).mean(-1).sum(), x)
            return g

        def gap(fn):
            g32 = fn(_t(c), _t(nrm), _t(ref))
            g64 = fn(_t(c).double(), _t(nrm).double(), _t(ref).double())
            return ((g32.double() - g64).abs().max() / g64.abs().max()).item()

        direct = gap(lambda x, nv, rv: kk.curv_term_plain(x, nv, rv, mask, K)[1])
        exp = gap(expansion)
        assert direct < exp, (direct, exp)
        assert direct < 1e-5


# --------------------------------------------------------------- pool ----


class TestPoolAffineMax:
    def _inputs(self, seed, taps, ties=False):
        rng = np.random.RandomState(seed)
        x = rng.randn(B, 64, 128).astype(np.float32)
        if ties:
            x[:, 1::2] = x[:, ::2]  # every row duplicated: exact ties (taps=1)
        w = (rng.randn(taps, 128, 256) * 0.2).astype(np.float32)
        bias = (rng.randn(256) * 0.1).astype(np.float32)
        return x, w, bias

    @pytest.mark.parametrize("taps,ties", [(1, False), (3, False), (1, True)])
    def test_plain_matches_pallas_kernel(self, taps, ties):
        from geoa3_tpu.ops.pallas.pool_matmul_kernel import pool_affine_max

        x, w, bias = self._inputs(14 + taps, taps, ties)
        jw, jb = jnp.asarray(w), jnp.asarray(bias)
        want = pool_affine_max(jnp.asarray(x), jw, jb, 0, True)[:, 0]
        wgrad = jax.grad(
            lambda v: jnp.sum(pool_affine_max(v, jw, jb, 0, True) ** 2)
        )(jnp.asarray(x))
        xt = _t(x).requires_grad_(True)
        got = pk.pool_affine_max(xt, _t(w), _t(bias))
        (got**2).sum().backward()
        # float32 products of 128*taps terms summed in other orders (the
        # interpret-mode kernel runs its 3-pass split, ~2^-21 relative); the
        # input gradient sums 256 such columns, bounded against its largest
        # entry (tests/test_pallas_kernels.py holds the kernel to 2e-3)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        wg = np.asarray(wgrad)
        np.testing.assert_allclose(xt.grad.numpy(), wg,
                                   rtol=1e-4, atol=1e-4 * np.abs(wg).max())


class TestPoolTies:
    """`pool_ties_plain`, the plain version of the forward kernel's whole
    output (pooled, tie count, first MAX_TIES tied rows), against ties read
    off the JAX package's composed `_affine` on inputs with runs of
    duplicated rows (exact ties by construction)."""

    def _inputs(self, seed, taps):
        rng = np.random.RandomState(seed)
        x = np.maximum(rng.randn(B, 64, 128), 0).astype(np.float32)
        x[0, 10:20] = 3.0 * x[0, 10]  # a run that holds many columns' max
        for start in (40, 50):  # two runs: two tied rows at a column's max
            x[1, start:start + taps] = 3.0 * x[1, 3]
        w = (rng.randn(taps, 128, 256) / np.sqrt(taps * 128)).astype(np.float32)
        bias = (rng.randn(256) * 0.1).astype(np.float32)
        return x, w, bias

    @pytest.mark.parametrize("taps", [1, 3])
    def test_ties_match_composed_affine(self, taps):
        from geoa3_tpu.ops.pallas.pool_matmul_kernel import _affine

        x, w, bias = self._inputs(40 + taps, taps)
        pooled, cnt, rows = pk.pool_ties_plain(_t(x), _t(w), _t(bias))
        for b in range(B):
            z = np.asarray(_affine(jnp.asarray(x[b]), jnp.asarray(w),
                                   jnp.asarray(bias), True))
            zmax = z.max(0)
            tied = z == zmax
            np.testing.assert_array_equal(cnt[b].numpy(), tied.sum(0))
            for c in range(z.shape[1]):
                first = np.flatnonzero(tied[:, c])[:pk.MAX_TIES]
                want = np.zeros(pk.MAX_TIES, np.int32)
                want[:len(first)] = first
                np.testing.assert_array_equal(rows[b, c].numpy(), want)
            # the composed path's split-bf16 products: 2^-16 of each of the
            # 128 * taps summed terms, bounded by their largest absolute sum
            np.testing.assert_allclose(
                pooled[b].numpy(), zmax, rtol=0,
                atol=HILO * np.abs(x[b]).max() * np.abs(w).sum((0, 1)).max())
        assert (cnt > pk.MAX_TIES).any() and ((cnt > 1) & (cnt <= pk.MAX_TIES)).any()
        assert torch.equal(pooled, pk.pool_affine_max_plain(_t(x), _t(w), _t(bias)))

    def test_short_clouds_pad_rows_with_zero(self):
        z = torch.tensor([[[1.0, 2.0], [1.0, 0.5]]])  # n = 2 < MAX_TIES
        pooled, cnt, rows = pk.max_ties(z)
        assert pooled.tolist() == [[1.0, 2.0]] and cnt.tolist() == [[2, 1]]
        assert rows.tolist() == [[[0, 1, 0, 0], [0, 0, 0, 0]]]


# ----------------------------------------------- boundaries and counts ----


def test_import_leaves_jax_out():
    code = (
        "import sys, geoa3_tpu_torch, geoa3_tpu_torch.ops.kernels; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'geoa3_tpu' or m.startswith('geoa3_tpu.')]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_no_source_names_jax_or_the_jax_package():
    bad = re.compile(r"^\s*(import jax|from jax)|\bgeoa3_tpu\.|"
                     r"(from|import)\s+geoa3_tpu(\s|$)", re.M)
    files = sorted((REPO / "geoa3_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    offenders = [str(f) for f in files if bad.search(f.read_text())]
    assert not offenders, offenders


def test_cpu_tensors_never_launch_kernels():
    tk.reset_launch_counts()
    c, nrm, rng = _cloud(16)
    ct, nt = _t(c), _t(nrm)
    pay = torch.zeros(B, 8, N)
    _, o2a, gp, _ = nk.nn1_dual_payload(ct, ct, pay)
    sk.scatter_add_3t(o2a, torch.ones(B, N, 3), N)
    mask = kk.kappa_selmask(ct, K)
    kk.kappa_fwd(ct, nt, K)
    kk.curv_term(ct, nt, gp[:, 6], mask, K)
    kk.kappa_frommask(ct, nt, mask, K)
    for radius in kk.RADII:
        kk.kappa_bwd(ct, nt, mask, torch.ones(B, N), K, radius)
    nk.nn1_dual(ct, ct)
    qk.knn(ct, ct, K)
    x = torch.randn(B, 16, 64, requires_grad=True)
    pk.pool_affine_max(x, torch.randn(1, 64, 64), torch.zeros(64)).sum().backward()
    assert tk.launch_counts() == {name: 0 for name in tk.KERNELS}


def test_cuda_entry_point_refuses_cpu_only_tensors():
    """The CUDA kernels validate what they take: a CPU tensor handed to a
    kernel entry raises instead of running anywhere else."""
    x = torch.randn(B, 16, 64)
    with pytest.raises(ValueError, match="CUDA"):
        pk.pool_fwd(x, torch.randn(1, 64, 64), torch.zeros(64))
