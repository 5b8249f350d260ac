"""The port's kNN, bare dual 1-NN, kappa-from-mask and kappa-backward modules
against the JAX package, on the CPU.

Each kernel's plain PyTorch version (what the port runs on CPU tensors, and
what chip_smoke.py holds each CUDA kernel against on the card) is compared
with the Pallas kernel it replaces in TPU interpret mode, and each op with
its geoa3_tpu.ops counterpart (the composed CPU path), values and gradients.
Inputs come from numpy seeds; b=2, n=128, k=8.
"""

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
from geoa3_tpu_torch.ops.kernels import kappa_kernel as kk
from geoa3_tpu_torch.ops.kernels import knn_kernel as qk
from geoa3_tpu_torch.ops.kernels import nn1_kernel as nk
from geoa3_tpu_torch.ops.kernels import scatter_kernel as sk
from tests.test_torch_ops import (
    HILO,
    NN1_CASES,
    _check_coincident,
    _cloud,
    _nn1_inputs,
    _t,
    _with_ties,
)

torch.set_num_threads(1)
B, N, K = 2, 128, 8
DENSE = 4500  # past the 4096 points the kNN and kappa kernels once took


def _knn_case(name):
    """(query, points, k) for the three shapes the slice drives."""
    c, _, rng = _cloud(20)
    if name == "self_ties":  # self-kNN with duplicated points
        c = _with_ties(c)
        return c, c, K + 1
    if name == "cross":  # query != points, m != n
        q = (c + 0.02 * rng.randn(*c.shape)).astype(np.float32)
        return q, c[:, :96].copy(), K
    if name == "one_row":  # the patch seed of partial-variable mode
        return c[:, 5:6].copy(), c, 4
    raise AssertionError(name)


KNN_CASES = ["self_ties", "cross", "one_row"]


# ---------------------------------------------------------------- knn ----


class TestKNN:
    @pytest.mark.parametrize("case", KNN_CASES)
    def test_plain_matches_pallas_kernel(self, case):
        from geoa3_tpu.ops.pallas.knn_kernel import knn_pallas

        q, p, k = _knn_case(case)
        with pltpu.force_tpu_interpret_mode():
            want = knn_pallas(jnp.asarray(q), jnp.asarray(p), k, row_block=32)
        dists, idx, nbrs = qk.knn_plain(_t(q), _t(p), k)
        # indices exact (ties to the lowest index), coordinate copies
        # bit-equal; the distance block is a matrix product there and
        # elementwise here: float32 rounding of the same expansion
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(nbrs.numpy(), np.asarray(want.nbrs))
        np.testing.assert_allclose(dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("case", KNN_CASES)
    def test_op_matches_composed(self, case):
        q, p, k = _knn_case(case)
        want = jops.knn_points(jnp.asarray(q), jnp.asarray(p), k)
        got = tops.knn_points(_t(q), _t(p), k)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_array_equal(got.nbrs.numpy(), np.asarray(want.nbrs))
        # both recompute the distances from the gathered coordinates
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-6, atol=1e-9)

    def test_duplicates_take_the_lowest_index_in_order(self):
        c = _with_ties(_cloud(21)[0])
        _, idx, _ = qk.knn_plain(_t(c), _t(c), 4)
        # instance 0: points 10, 64, 65 coincide; the self column is not
        # special, so all three rows start 10, 64, 65
        for row in (10, 64, 65):
            assert idx[0, row, :3].tolist() == [10, 64, 65]

    def test_k1_is_an_argmin(self):
        q, p, _ = _knn_case("cross")
        want = jops.knn_points(jnp.asarray(q), jnp.asarray(p), 1)
        got = tops.knn_points(_t(q), _t(p), 1)
        np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-6, atol=1e-9)

    @pytest.mark.parametrize("case", ["self_ties", "cross"])
    def test_grad_matches_composed(self, case):
        q, p, k = _knn_case(case)
        rng = np.random.RandomState(22)
        w = rng.randn(q.shape[0], q.shape[1], k).astype(np.float32)
        wn = rng.randn(q.shape[0], q.shape[1], k, 3).astype(np.float32)
        same = case == "self_ties"

        def jloss(a, b_):
            r = jops.knn_points(a, a if same else b_, k)
            return jnp.sum(r.dists * w) + jnp.sum(r.nbrs * wn)

        wq, wp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q), jnp.asarray(p))
        tq = _t(q).requires_grad_(True)
        tp = _t(p).requires_grad_(True)
        r = tops.knn_points(tq, tq if same else tp, k)
        ((r.dists * _t(w)).sum() + (r.nbrs * _t(wn)).sum()).backward()
        # the neighbour gather's backward is a scatter-add of n*k rows: the
        # same few float32 terms in another order
        np.testing.assert_allclose(tq.grad.numpy(), np.asarray(wq),
                                   rtol=1e-5, atol=1e-5)
        if not same:
            np.testing.assert_allclose(tp.grad.numpy(), np.asarray(wp),
                                       rtol=1e-5, atol=1e-5)

    def test_planes_match_composed(self):
        q, p, k = _knn_case("cross")
        want = jops.knn_points_planes(jnp.asarray(q), jnp.asarray(p), k)
        got = tops.knn_points_planes(_t(q), _t(p), k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    def test_limits_are_checked(self):
        c = _t(_cloud(23)[0])
        with pytest.raises(ValueError, match="k"):
            qk.knn(c, c, qk.MAX_K + 1)
        with pytest.raises(ValueError, match="k"):
            qk.knn(c, c[:, :4], 5)

    def test_dense_points_match_composed(self):
        """m = 4500, past the 4096 points the kernel once took: the CPU path
        has no limit on m, as the JAX package's composed top_k has none."""
        c, _, rng = _cloud(40, 1, DENSE)
        q = (c[:, :400] + 0.01 * rng.randn(1, 400, 3)).astype(np.float32)
        want = jops.knn_points(jnp.asarray(q), jnp.asarray(c), K)
        _, idx, nbrs = qk.knn(_t(q), _t(c), K)
        got = tops.knn_points(_t(q), _t(c), K)
        for i_, n_ in ((idx, nbrs), (got.idx, got.nbrs)):
            np.testing.assert_array_equal(i_.numpy(), np.asarray(want.idx))
            np.testing.assert_array_equal(n_.numpy(), np.asarray(want.nbrs))
        # both recompute the distances from the gathered coordinates
        np.testing.assert_allclose(got.dists.numpy(), np.asarray(want.dists),
                                   rtol=1e-6, atol=1e-9)


class TestGathers:
    def _idx(self, seed, s):
        """Duplicate-heavy indices: half of them hit three rows."""
        rng = np.random.RandomState(seed)
        idx = rng.randint(0, N, (B, s)).astype(np.int32)
        idx[:, ::2] = rng.randint(0, 3, (B, (s + 1) // 2))
        return idx, rng

    def test_scatter_with_more_sources_than_rows(self):
        """The scatter as the backward of knn_gather: s = n*k sources into n
        rows, many of them colliding."""
        from geoa3_tpu.ops.pallas.scatter_kernel import scatter_add_3t_pallas

        idx, rng = self._idx(24, N * K)
        ct = rng.randn(B, N * K, 3).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = scatter_add_3t_pallas(jnp.asarray(idx), jnp.asarray(ct), N)
        got = sk.scatter_add_3t_plain(_t(idx), _t(ct), N).numpy()
        exact = np.zeros((B, N, 3), np.float64)
        for b in range(B):
            np.add.at(exact[b], idx[b], ct[b].astype(np.float64))
        # float32 sums of up to ~170 colliding terms against float64
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-4)
        # the TPU kernel's split-bf16 one-hot products: 2^-16 of each term
        np.testing.assert_allclose(got, np.asarray(want), rtol=HILO,
                                   atol=HILO * np.abs(ct).sum(1).max())

    def test_knn_gather_grad_matches_composed(self):
        c = _cloud(25)[0]
        idx, rng = self._idx(26, N * 4)
        idx = idx.reshape(B, N, 4)
        w = rng.randn(B, N, 4, 3).astype(np.float32)
        want = jax.grad(
            lambda x: jnp.sum(jops.knn_gather(x, jnp.asarray(idx)) * w)
        )(jnp.asarray(c))
        x = _t(c).requires_grad_(True)
        out = tops.knn_gather(x, _t(idx))
        np.testing.assert_array_equal(
            out.detach().numpy(), np.asarray(jops.knn_gather(jnp.asarray(c), jnp.asarray(idx)))
        )
        (out * _t(w)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)

    def test_gather_rows3_grad_matches_composed(self):
        c = _cloud(27)[0]
        idx, rng = self._idx(28, 200)  # s != n
        w = rng.randn(B, 200, 3).astype(np.float32)
        want = jax.grad(
            lambda x: jnp.sum(jops.gather_rows3(x, jnp.asarray(idx)) * w)
        )(jnp.asarray(c))
        x = _t(c).requires_grad_(True)
        (tops.gather_rows(x, _t(idx)) * _t(w)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


# ----------------------------------------------------------- nn1_dual ----


class TestNN1Dual:
    def _inputs(self, seed, ties):
        adv, ori, _ = _nn1_inputs(seed, ties)
        return adv, ori

    @pytest.mark.parametrize("ties", list(NN1_CASES))
    def test_plain_matches_pallas_kernel(self, ties):
        from geoa3_tpu.ops.pallas.nn1_kernel import nn1_dual_pallas

        adv, ori = self._inputs(30, ties)
        with pltpu.force_tpu_interpret_mode():
            want = nn1_dual_pallas(jnp.asarray(adv), jnp.asarray(ori),
                                   row_block=NN1_CASES[ties])
        got = nk.nn1_dual_plain(_t(adv), _t(ori))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        _check_coincident(ties, *want)

    @pytest.mark.parametrize("ties", list(NN1_CASES))
    def test_op_matches_composed_and_the_payload_kernel(self, ties):
        adv, ori = self._inputs(31, ties)
        want = jops.nn1_dual(jnp.asarray(adv), jnp.asarray(ori))
        got = tops.nn1_dual(_t(adv), _t(ori))
        pay = nk.nn1_dual_payload_plain(_t(adv), _t(ori),
                                        torch.zeros(B, 8, ori.shape[1]))
        for g, w, p in zip(got, want, pay[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            assert torch.equal(g, p)
        _check_coincident(ties, *got)


# -------------------------------------------------- kappa from a mask ----


def _without_self(mask):
    """The mask with its self column cleared: jax.grad of the composed path
    takes |x|'(0) = 1 there, which adds +-w/1e-12 n_i pairs that cancel only
    in exact arithmetic (ROADMAP.md section 3); the port takes 0."""
    out = np.array(mask, copy=True)
    i = np.arange(out.shape[1])
    out[:, i, i] = 0
    return out


class TestKappaFromMask:
    def _inputs(self, seed, n=N):
        c, nrm, rng = _cloud(seed, B, n)
        mask = kk.kappa_selmask_plain(_t(c), K).numpy()
        moved = (c + 1e-3 * rng.randn(*c.shape)).astype(np.float32)  # stale mask
        return moved, nrm, mask, rng

    def test_plain_matches_pallas_kernel(self):
        from geoa3_tpu.ops.pallas.kappa_kernel import kappa_frommask_pallas

        c, nrm, mask, _ = self._inputs(32)
        with pltpu.force_tpu_interpret_mode():
            want = kappa_frommask_pallas(
                jnp.asarray(c), jnp.asarray(nrm), jnp.asarray(mask), K, 64
            )
        got = kk.kappa_from_mask_plain(_t(c), _t(nrm), _t(mask), K)
        # the TPU kernel's n_i.p_j products are split-bf16 (hi/lo): the
        # tolerance tests/test_pallas_kernels.py holds it to
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-5)

    def test_op_value_and_grad_match_composed(self):
        self._op_value_and_grad_match_composed(33, N)

    def test_op_value_and_grad_match_composed_at_a_ragged_n(self):
        """n % 16 != 0: mask rows off 16-byte lines, where the card's
        stream reads a row's head and tail on their own."""
        self._op_value_and_grad_match_composed(39, 100)

    def _op_value_and_grad_match_composed(self, seed, n):
        c, nrm, mask, rng = self._inputs(seed, n)
        w = rng.randn(B, n).astype(np.float32)
        jn = jnp.asarray(nrm)
        want = jops.knn_kappa_from_mask(jnp.asarray(c), jn, jnp.asarray(mask), K)
        mask_ns = jnp.asarray(_without_self(mask))
        wgrad = jax.grad(
            lambda x: jnp.sum(jops.knn_kappa_from_mask(x, jn, mask_ns, K) * w)
        )(jnp.asarray(c))
        p = _t(c).requires_grad_(True)
        got = tops.knn_kappa_from_mask(p, _t(nrm), _t(mask), K)
        (got * _t(w)).sum().backward()
        # same composition on both sides; XLA and PyTorch sum in other orders
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
        wg = np.asarray(wgrad)
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=1e-4,
                                   atol=1e-5 * np.abs(wg).max())


# ------------------------------------------------------ kappa backward ----


class TestKappaBwd:
    def test_plain_matches_pallas_kernel(self):
        """The expansion-radius backward against the TPU backward kernel,
        which both TPU forwards share."""
        from geoa3_tpu.ops.pallas.kappa_kernel import _kappa_bwd_call

        c, nrm, rng = _cloud(34)
        mask = kk.kappa_selmask_plain(_t(c), K)
        g = rng.randn(B, N).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = _kappa_bwd_call(
                jnp.asarray(c), jnp.asarray(nrm), jnp.asarray(mask.numpy()),
                jnp.asarray(g), K, 64,
            )
        got = kk.kappa_bwd_plain(_t(c), _t(nrm), mask, _t(g), K, "expansion")
        wg = np.asarray(want)
        # hi/lo products on the TPU side: the gradient tolerance that
        # tests/test_torch_ops.py holds the curvature term's kernel to,
        # bounded against the largest entry
        np.testing.assert_allclose(got.numpy(), wg, rtol=5e-3,
                                   atol=1e-3 * np.abs(wg).max())

    @pytest.mark.parametrize("ties", [False, True])
    def test_knn_kappa_grad_matches_composed(self, ties):
        """The direct-radius backward: d knn_kappa / d cloud against jax.grad
        of the composed path (gathered neighbours, direct differences, self
        already excluded)."""
        c, nrm, rng = _cloud(35)
        if ties:
            # a near-duplicate pair (exact duplicates make the composed
            # path's norm gradient nan)
            c[0, 64] = c[0, 10] + np.float32(1e-4)
        w = rng.randn(B, N).astype(np.float32)
        jn = jnp.asarray(nrm)
        want, wgrad = jax.value_and_grad(
            lambda x: jnp.sum(jops.knn_kappa(x, jn, K) * w)
        )(jnp.asarray(c))
        p = _t(c).requires_grad_(True)
        got = (tops.knn_kappa(p, _t(nrm), K) * _t(w)).sum()
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        wg = np.asarray(wgrad)
        # the same per-pair terms, summed by a scatter there and by autograd
        # through a gather here
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=1e-4,
                                   atol=1e-5 * np.abs(wg).max())

    def test_knn_kappa_and_kappa_ori_on_a_dense_cloud(self):
        """n = 4500, past the 4096 points the kappa kernels once took: the
        differentiable kappa and the attack's prologue against the JAX
        package's composed paths."""
        c, nrm, rng = _cloud(41, 1, DENSE)
        w = rng.randn(1, DENSE).astype(np.float32)
        jn = jnp.asarray(nrm)
        want, wgrad = jax.value_and_grad(
            lambda x: jnp.sum(jops.knn_kappa(x, jn, K) * w)
        )(jnp.asarray(c))
        p = _t(c).requires_grad_(True)
        got = (tops.knn_kappa(p, _t(nrm), K) * _t(w)).sum()
        got.backward()
        # the tolerances of test_knn_kappa_grad_matches_composed
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
        wg = np.asarray(wgrad)
        np.testing.assert_allclose(p.grad.numpy(), wg, rtol=1e-4,
                                   atol=1e-5 * np.abs(wg).max())
        # and of test_get_kappa_ori_matches_composed
        np.testing.assert_allclose(
            tlosses.get_kappa_ori(_t(c), _t(nrm), K).numpy(),
            np.asarray(jlosses.get_kappa_ori(jnp.asarray(c), jn, K)),
            rtol=1e-5, atol=1e-7)

    def test_the_two_radii_differ_only_by_rounding(self):
        c, nrm, rng = _cloud(36)
        mask = kk.kappa_selmask_plain(_t(c), K)
        g = _t(rng.randn(B, N).astype(np.float32))
        direct = kk.kappa_bwd(_t(c), _t(nrm), mask, g, K, "direct")
        expansion = kk.kappa_bwd(_t(c), _t(nrm), mask, g, K, "expansion")
        # |p_j - p_i| against sqrt of the float32 expansion: the closest
        # pairs (r ~ 0.02 on a unit cloud) carry ~1e-4 relative error in r
        scale = direct.abs().max()
        assert (direct - expansion).abs().max() <= 5e-3 * scale
        assert not torch.equal(direct, expansion)

    @pytest.mark.parametrize("radius", kk.RADII)
    def test_coincident_points_pass_no_gradient(self, radius):
        """|x|'(0) = 0 and no gradient through a radius at the clamp: exact
        duplicates inside a neighbourhood leave the gradient finite, and a
        cloud of nothing but duplicates has gradient zero."""
        c, nrm, rng = _cloud(37)
        c = _with_ties(c)
        mask = kk.kappa_selmask_plain(_t(c), K)
        assert mask[0, 10, 64] == 1
        g = _t(rng.randn(B, N).astype(np.float32))
        grad = kk.kappa_bwd(_t(c), _t(nrm), mask, g, K, radius)
        assert torch.isfinite(grad).all()
        same = torch.ones(1, 8, 3)
        m8 = kk.kappa_selmask_plain(same, 3)
        zero = kk.kappa_bwd(same, _t(nrm[:1, :8]), m8, torch.ones(1, 8), 3, radius)
        assert torch.equal(zero, torch.zeros_like(zero))

    def test_radius_is_checked(self):
        c, nrm, _ = _cloud(38)
        mask = kk.kappa_selmask_plain(_t(c), K)
        with pytest.raises(ValueError, match="radius"):
            kk.kappa_bwd(_t(c), _t(nrm), mask, torch.ones(B, N), K, "other")
