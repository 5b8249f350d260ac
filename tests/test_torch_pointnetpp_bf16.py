"""The bf16 PointNet++ victims (`--victim_dtype bfloat16 --arch PointNetPP |
PointNetPP_MSG`) of the port against the JAX package's, on the CPU.

The JAX reference is `make_eval_fn(model, variables, dtype=jnp.bfloat16)`
on the route it takes on the TPU: its grouped MLPs fused in their
single-pass bf16 mode (`group_mlp_kernel.pallas_available` and
`pool_matmul_kernel.pallas_available` -> True, `platform_f32_exact` ->
False, the Pallas kernels in interpret mode), its variables held as jax
arrays, its input gradient taken op by op. Pinned by monkeypatch, as the
port computes them (nothing in geoa3_tpu/ changes):
  * FPS on the coordinates in float32, as the TPU's FPS kernel takes them
    (its composed CPU loop keeps bf16 minima and picks other points);
  * the grouping's backward as float32 sums rounded once to bf16, the TPU's
    scatter kernels' rule (XLA's CPU scatter-add in bf16 rounds each add);
  * the centring's backward (grouped coordinates minus the centres, summed
    over nsample) in float32, rounded once, as jnp.sum and torch's autograd
    sum: XLA's CPU reduce_sum of bf16 (the transpose of the broadcast)
    accumulates in bf16, in windows of 32;
  * the fused kernel's products (`_mm`, `_mm_t`) through XLA's float32 dot
    of the same bf16 operands: the same exact products, whose float32 sums
    XLA's CPU runs in another order for bf16 operands (its bf16 dot) than
    for float32 ones, and the port's CPU matmul in the float32 dot's order.
    That order alone moves the bf16 victims a long way: switching the JAX
    kernel's products from one order to the other moves SSG's input
    gradient by 7.0e-3 of its largest entry and MSG's logits by 3.2e-3 and
    its gradient by 0.15 (`test_summation_order_yardstick` prints them: a
    pooled maximum or a bf16 rounding of an activation falls the other way,
    and a tie at a maximum moves the gradient between points).

Compared (inputs and weights from numpy seeds, models/convert.py carrying
the weights across):
  * the plain single-pass grouped MLP against JAX's `group_mlp_maxpool(gxp,
    gf, ns, False, ws)`: cf 0 and 128, GroupAll's widths, widths that are
    not multiples of 16, duplicated rows;
  * the bf16 ball query, idx bit-equal to `geoa3_tpu.ops.ball_query` on
    bf16 points with points planted at the radius; FPS on bf16 coordinates
    bit-equal to JAX's on their float32 values; the grouping's bf16
    backward;
  * the port's copy of the JAX gate `group_mlp_available`;
  * the SSG and MSG twins at b = 2, n = 1024: logits within 1e-3 of max
    |logit| and the input gradient of sum(logits^2) within 5e-3 of max |g|,
    and their logits more than 1e-3 from the float32 victim's;
  * the attack CLI with `--victim_dtype bfloat16 --arch PointNetPP`, and a
    twin in train mode refused.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geoa3_tpu.models.pointnetpp as jpp
import geoa3_tpu.ops as jops
import geoa3_tpu.ops.pallas.group_mlp_kernel as jgk
import geoa3_tpu.ops.pallas.pool_matmul_kernel as jpk
from geoa3_tpu.models.pointnetpp import PointNet2ClassificationMSG as JMSG
from geoa3_tpu.models.pointnetpp import PointNet2ClassificationSSG as JSSG
from geoa3_tpu.models.registry import make_eval_fn as jmake_eval_fn
from geoa3_tpu_torch import ops
from geoa3_tpu_torch.cli import main_attack
from geoa3_tpu_torch.models import bf16_grad_healthcheck, build_model, make_eval_fn
from geoa3_tpu_torch.models.convert import from_flax_variables
from geoa3_tpu_torch.ops.ball_query import pairwise_sqdist_bf16
from geoa3_tpu_torch.ops.kernels import group_mlp_kernel as gk
from tests.test_torch_pointnetpp import _clouds, _variables

torch.set_num_threads(2)
CLASSES = 10
BF = jnp.bfloat16


@jax.custom_vjp
def _group_points_f32(features, idx):
    return _GROUP_POINTS(features, idx)


def _gp_fwd(features, idx):
    return _GROUP_POINTS(features, idx), (idx, features)


def _gp_bwd(res, ct):
    """float32 sums of the bf16 cotangents, rounded once to the features'
    type."""
    idx, features = res
    b, n, c = features.shape
    m, ns = idx.shape[1:]
    g = jnp.zeros((b, n, c), jnp.float32).at[
        jnp.arange(b)[:, None], idx.reshape(b, m * ns)].add(
        ct.reshape(b, m * ns, c).astype(jnp.float32))
    return g.astype(features.dtype), None


_GROUP_POINTS = jops.group_points
_group_points_f32.defvjp(_gp_fwd, _gp_bwd)


@jax.custom_vjp
def _centred(grouped, centres):
    return grouped - centres[:, :, None, :]


def _centred_fwd(grouped, centres):
    return grouped - centres[:, :, None, :], None


def _centred_bwd(_, ct):
    return ct, -jnp.sum(ct, axis=2)  # jnp.sum sums bf16 in float32


_centred.defvjp(_centred_fwd, _centred_bwd)


def _query_and_group(radius, nsample, xyz, new_xyz, features, use_xyz):
    """geoa3_tpu/models/pointnetpp.py:_query_and_group with the centring's
    backward summed in float32."""
    idx = jops.ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = _centred(jops.group_points(xyz, idx), new_xyz)
    if features is not None:
        grouped_feats = jops.group_points(features, idx)
        return (grouped_xyz, grouped_feats) if use_xyz else grouped_feats
    return grouped_xyz


def _pin(mp, float32_dot=True):
    """The JAX bf16 victim on its TPU route with the port's roundings (the
    module docstring); `float32_dot=False` leaves its kernel's products on
    XLA's bf16 dot."""
    mp.setattr(jgk, "pallas_available", lambda: True)
    mp.setattr(jpk, "pallas_available", lambda: True)
    mp.setattr(jpk, "platform_f32_exact", lambda: False)
    fps = jops.furthest_point_sampling
    mp.setattr(jops, "furthest_point_sampling",
               lambda x, m: fps(x.astype(jnp.float32), m))
    mp.setattr(jops, "group_points", _group_points_f32)
    mp.setattr(jpp, "_query_and_group", _query_and_group)
    if float32_dot:
        mm, mm_t = jgk._mm, jgk._mm_t

        def lift(t):
            return t.astype(BF).astype(jnp.float32)

        mp.setattr(jgk, "_mm", lambda x, w, exact: mm(x, w, exact) if exact
                   else jnp.dot(lift(x), lift(w), preferred_element_type=jnp.float32))
        mp.setattr(jgk, "_mm_t", lambda g, w, exact: mm_t(g, w, exact) if exact
                   else jnp.dot(lift(g), lift(w).T, preferred_element_type=jnp.float32))


def _jax_logits_and_grad(jmodel, variables, pc):
    jfn = jmake_eval_fn(jmodel, jax.tree.map(jnp.asarray, variables), dtype=BF)
    out = np.asarray(jfn(jnp.asarray(pc)))
    grad = np.asarray(jax.grad(lambda p: jnp.sum(jfn(p) ** 2))(jnp.asarray(pc)))
    return out, grad


ARCHS = {"SSG": (JSSG, "PointNetPP", 0), "MSG": (JMSG, "PointNetPP_MSG", 10)}


@pytest.fixture(scope="module")
def victims():
    """arch -> (JAX model, variables, the port's float32 model, the pinned
    JAX reference's logits and gradient at `_clouds(2)`)."""
    out = {}
    for name, (jcls, arch, seed) in ARCHS.items():
        jmodel = jcls(classes=CLASSES)
        variables = _variables(jmodel, 3, seed)
        model = build_model(arch, classes=CLASSES, device="cpu")
        model.load_state_dict(from_flax_variables(variables))
        with pytest.MonkeyPatch.context() as mp:
            _pin(mp)
            ref = _jax_logits_and_grad(jmodel, variables, _clouds(2))
        out[name] = (jmodel, variables, model, ref)
    return out


def _port_logits_and_grad(model, pc):
    x = torch.from_numpy(pc).requires_grad_(True)
    logits = make_eval_fn(model, dtype=torch.bfloat16)(x)
    (g,) = torch.autograd.grad((logits ** 2).sum(), x)
    assert logits.dtype == torch.float32 and g.dtype == torch.float32
    return logits.detach().numpy(), g.numpy()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bf16_victim_matches_jax(victims, arch, capsys):
    _, _, model, (want, wgrad) = victims[arch]
    got, grad = _port_logits_and_grad(model, _clouds(2))
    scale = np.abs(want).max()
    assert scale > 1e-2 and np.abs(wgrad).max() > 1e-4
    with capsys.disabled():
        print(f"\n{arch} bf16 twin against the pinned JAX victim: logits err / max "
              f"|logit| {np.abs(got - want).max() / scale:.3e}, input gradient err / "
              f"max |g| {np.abs(grad - wgrad).max() / np.abs(wgrad).max():.3e}, "
              f"{(grad == wgrad).mean():.4f} of the gradient bit-equal")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(grad, wgrad, rtol=0, atol=5e-3 * np.abs(wgrad).max())
    # the mode runs: the float32 victim's logits are further away
    with torch.no_grad():
        f32 = make_eval_fn(model)(torch.from_numpy(_clouds(2))).numpy()
    assert np.abs(got - f32).max() > 1e-3 * scale


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_summation_order_yardstick(victims, arch, capsys):
    """How far the JAX bf16 victim itself moves when only its kernel's
    float32 sums run in another order (XLA's bf16 dot, unpinned, against
    its float32 dot): the reason the reference is pinned."""
    jmodel, variables, _, (want, wgrad) = victims[arch]
    with pytest.MonkeyPatch.context() as mp:
        _pin(mp, float32_dot=False)
        other, ograd = _jax_logits_and_grad(jmodel, variables, _clouds(2))
    lerr = np.abs(other - want).max() / np.abs(want).max()
    gerr = np.abs(ograd - wgrad).max() / np.abs(wgrad).max()
    rel = np.linalg.norm(ograd - wgrad) / np.linalg.norm(wgrad)
    with capsys.disabled():
        print(f"\n{arch} bf16 victim, its kernel's products in XLA's bf16-dot "
              f"order against its float32-dot order: logits err / max |logit| "
              f"{lerr:.3e}, input gradient err / max |g| {gerr:.3e}, relative L2 "
              f"{rel:.3e}, {(ograd == wgrad).mean():.4f} of the gradient bit-equal")
    assert not np.array_equal(ograd, wgrad)


def test_twin_leaves_the_float32_victim_alone_and_refuses_training(victims):
    _, _, model, _ = victims["SSG"]
    pc = torch.from_numpy(_clouds(3))
    with torch.no_grad():
        before = model(pc)
        fold = model.SA_modules[0].mlps[0].folded()
        make_eval_fn(model, dtype=torch.bfloat16)(pc)
        assert model.SA_modules[0].mlps[0][0].weight.dtype == torch.float32
        assert model.SA_modules[0].mlps[0].folded() is fold
        assert torch.equal(model(pc), before)
    import copy

    twin = copy.deepcopy(model).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 victim"):
        twin.train()(pc)


def test_healthcheck_passes_the_pointnetpp_twins(victims):
    for name in ARCHS:
        model = victims[name][2]
        assert bf16_grad_healthcheck(make_eval_fn(model, dtype=torch.bfloat16),
                                     b=2, n=512, device="cpu")


# label -> (b, m, ns, cf, widths, duplicated rows)
MLP_CASES = {
    "cf 0 (SA1-like)": (2, 8, 64, 0, (64, 64, 128), False),
    "cf 128 (SA2-like), duplicated rows": (2, 4, 32, 128, (128, 128, 256), True),
    "GroupAll widths, cf 256": (2, 1, 128, 256, (256, 512, 1024), False),
    "widths 24/40/36, duplicated rows": (1, 3, 12, 0, (24, 40, 36), True),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_plain_single_pass_mlp_matches_jax(case, monkeypatch):
    """group_mlp_maxpool_bf16 on the CPU (its plain versions) against the
    JAX kernel's single-pass mode in interpret mode, products pinned to
    XLA's float32 dot: the pooled maxima (bf16), dgx and dgf."""
    _pin(monkeypatch)
    b, m, ns, cf, widths, dup = MLP_CASES[case]
    rng = np.random.RandomState(len(case))
    gx = (0.3 * rng.randn(b, m, ns, 3)).astype(np.float32)
    gf = np.maximum(rng.randn(b, m, ns, cf), 0).astype(np.float32) if cf else None
    if dup:
        for t in (gx, gf):
            if t is not None:
                t[:, :, 1::3] = t[:, :, 0:1]
    parts, cin = [], 3 + cf
    for w in widths:
        parts.append((rng.randn(cin, w) * np.sqrt(2.0 / cin)).astype(np.float32))
        parts.append((0.1 * rng.randn(w)).astype(np.float32))
        cin = w
    ws = tuple(jnp.asarray(t if t.ndim == 2 else t[None]).astype(BF) for t in parts)
    g = jnp.asarray(rng.randn(b, m, widths[-1]).astype(np.float32)).astype(BF)

    def jfn(x, f):
        xp = x.transpose(0, 3, 1, 2).reshape(b, 3, m * ns)
        xp = jnp.concatenate([xp, jnp.zeros((b, 5, m * ns), xp.dtype)], axis=1)
        return jgk.group_mlp_maxpool(xp, f, ns, False, ws)

    xj = jnp.asarray(gx).astype(BF)
    fj = jnp.asarray(gf).astype(BF) if cf else None
    want, vjp = jax.vjp(jfn, xj, fj)
    wgx, wgf = vjp(g)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32)))

    p = gk.fold_mlp_bf16(*(t(w).reshape(w.shape[-2:] if w.shape[0] > 1 else w.shape[1:])
                           for w in ws))
    xt = t(xj).to(torch.bfloat16).requires_grad_(True)
    ft = t(fj).to(torch.bfloat16).requires_grad_(True) if cf else None
    got = gk.group_mlp_maxpool_bf16(xt, ft, p)
    assert got.dtype == torch.bfloat16
    grads = torch.autograd.grad((got.float() * t(g)).sum(),
                                [xt] + ([ft] if cf else []))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().detach().numpy(), want, rtol=0,
                               atol=2.0 ** -8 * np.abs(want).max())
    for d, w in zip(grads, (wgx, wgf)):
        assert d.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(d.float().numpy(), w, rtol=0,
                                   atol=5e-3 * np.abs(w).max())


def _bf16_points(seed, b, n, m, radius):
    """(xyz [b, n, 3], centres [b, m, 3]) in bf16: random points in the
    unit ball, the centres the first m of them, and for each of the first
    few centres points planted at r (1 + k 2^-9), k = -4 .. 4, along x, y
    and the diagonal: their distances fall on either side of r^2 by the
    roundings alone."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-1, 1, (b, n, 3)).astype(np.float32)
    xyz /= np.maximum(1.0, np.linalg.norm(xyz, axis=-1, keepdims=True))
    dirs = np.array([[1, 0, 0], [0, 1, 0], [1, 1, 1]], np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    slot = m
    for c in range(4):
        for d in dirs:
            for k in range(-4, 5):
                xyz[:, slot] = xyz[:, c] + radius * (1 + k * 2.0 ** -9) * d
                slot += 1
    xyz = jnp.asarray(xyz).astype(BF)
    return xyz, xyz[:, :m]


@pytest.mark.parametrize("shape", [(0.2, 64, 1024, 512), (0.4, 64, 512, 128),
                                   (0.1, 16, 1024, 512), (0.8, 128, 512, 128)],
                         ids=["SSG SA1", "SSG SA2", "MSG SA1 ns=16", "MSG SA2 ns=128"])
def test_bf16_ball_query_is_bit_equal_to_jax(shape):
    radius, ns, n, m = shape
    xyz, centres = _bf16_points(int(radius * 10) + ns, 2, n, m, radius)
    want = np.asarray(jops.ball_query(radius, ns, xyz, centres))

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    got = ops.ball_query(radius, ns, t(xyz), t(centres))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the planted points near the radius fall on both sides
    d = pairwise_sqdist_bf16(t(centres), t(xyz))[:, :4]
    r2 = np.float32(radius * radius)
    near = d[:, :, m:m + 4 * 27]
    assert (near < r2).any() and (near >= r2).any()


def test_fps_on_bf16_points_is_bit_equal_to_jax_on_float32():
    xyz, _ = _bf16_points(5, 2, 1024, 512, 0.2)
    want = np.asarray(jops.furthest_point_sampling(xyz.astype(jnp.float32), 512))
    got = ops.furthest_point_sampling(
        torch.from_numpy(np.asarray(xyz.astype(jnp.float32))).to(torch.bfloat16), 512)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("c", [3, 128])
def test_group_points_bf16_backward_sums_in_float32(c):
    rng = np.random.RandomState(c)
    feats = jnp.asarray(rng.randn(2, 512, c).astype(np.float32)).astype(BF)
    idx = jnp.asarray(rng.randint(0, 512, (2, 128, 64)).astype(np.int32))
    ct = jnp.asarray(rng.randn(2, 128, 64, c).astype(np.float32)).astype(BF)
    _, vjp = jax.vjp(lambda f: _group_points_f32(f, idx), feats)
    (want,) = vjp(ct)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    ft = t(feats).requires_grad_(True)
    out = ops.group_points(ft, torch.from_numpy(np.asarray(idx)))
    assert out.dtype == torch.bfloat16 and torch.equal(out, t(feats)[:, None].expand(
        -1, 128, -1, -1).gather(2, torch.from_numpy(np.asarray(idx)).long()[..., None]
                                .expand(-1, -1, -1, c)))
    (got,) = torch.autograd.grad(out, ft, t(ct))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


GATE_SHAPES = [  # (ns, m, widths, cf)
    (64, 512, (64, 64, 128), 0), (64, 128, (128, 128, 256), 128),
    (128, 1, (256, 512, 1024), 256), (16, 512, (32, 32, 64), 0),
    (32, 512, (64, 64, 128), 0), (128, 512, (64, 96, 128), 0),
    (32, 128, (64, 64, 128), 320), (128, 1, (256, 512, 1024), 640),
    (24, 7, (32, 32, 64), 0), (8193, 1, (64, 64, 128), 0), (1, 4, (8, 8, 8), 0),
    (64, 16, (64, 2048, 64), 0), (64, 512, (64, 64), 0), (100, 3, (64, 64, 128), 128),
]


@pytest.mark.parametrize("shape", GATE_SHAPES, ids=str)
def test_gate_is_the_jax_gate(shape):
    ns, m, widths, cf = shape
    want = ns > 1 and jgk.group_mlp_available(ns, m, widths, cf)
    assert gk.group_mlp_available(ns, m, widths, cf) == want


def test_cli_bf16_pointnetpp(tmp_path, monkeypatch):
    """The bf16 attack on the SSG victim on the CPU writes its outputs; the
    engine's gradient victim is the bf16 twin and its eval_logits_fn the
    float32 victim."""
    from geoa3_tpu_torch.workload import random_victim

    model, _ = random_victim("PointNetPP", device="cpu")
    torch.save(model.state_dict(), tmp_path / "victim.pt")
    seen = {}
    real = main_attack.make_attack_fn

    def spy(logits_fn, cfg, **kw):
        seen["logits_fn"], seen["eval_logits_fn"] = logits_fn, kw.get("eval_logits_fn")
        return real(logits_fn, cfg, **kw)

    monkeypatch.setattr(main_attack, "make_attack_fn", spy)
    n = 128
    saved = main_attack.main(main_attack.build_parser().parse_args([
        "--arch", "PointNetPP", "--attack", "GeoA3", "--attack_label", "Untarget",
        "--data_dir_file", f"synthetic:1:{n}", "--npoint", str(n),
        "--binary_max_steps", "1", "--iter_max_steps", "2", "--curv_loss_knn", "4",
        "-b", "10", "--victim_dtype", "bfloat16", "--exps_root", str(tmp_path / "exps"),
        "--checkpoint", str(tmp_path / "victim.pt"), "--device", "cpu"]))
    assert "PointNetPP_npoint" in saved
    mats = os.listdir(os.path.join(saved, "Mat"))
    with open(os.path.join(saved, "attack_result.txt")) as f:
        rate = float(f.read().strip().splitlines()[-1].split(":")[1])
    assert mats and rate == 10.0 * len(mats)
    pc = torch.from_numpy(_clouds(5)[:, :n].copy())
    with torch.no_grad():
        f32 = model(pc)
        assert torch.equal(seen["eval_logits_fn"](pc), f32)
        grad_pass = seen["logits_fn"](pc)
    assert grad_pass.dtype == torch.float32 and not torch.equal(grad_pass, f32)
