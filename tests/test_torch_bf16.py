"""The bf16 victim (`--victim_dtype bfloat16`) of the port against the JAX
package's, on the CPU.

The JAX reference is `make_eval_fn(model, variables, dtype=jnp.bfloat16)`
with its fused pools forced on in their single-pass bf16 mode
(`pool_matmul_kernel.pallas_available` -> True, `platform_f32_exact` ->
False, set by monkeypatch, as tests/test_pallas_kernels.py forces the
fused path), the Pallas kernels in interpret mode, its variables held as
jax arrays (as the JAX package's own initialiser returns them). Its input
gradient is taken by `jax.grad` op by op: compiled (`jax.jit`), the
rematerialised victim (make_eval_fn wraps PointNet in `jax.checkpoint`)
gives another gradient on the CPU, up to ~0.12 of its largest entry away
at b = 2, n = 128, while its logits stay the same.

Compared, with inputs and weights from numpy seeds (models/convert.py
carries the weights across):
  * the plain single-pass pool (`pool_affine_max_bf16`'s CPU path) against
    JAX's `pool_affine_max(x, w3, b, 0, False)`: taps 1 on bf16 x, taps 1
    and 3 on float32 x, and runs of duplicated rows (more than four ties);
    pooled within 1e-5 of max |z| and dx within 1e-5 of max |dx| (float32
    sums of exact bf16 products in other orders; the cotangent g / cnt is
    rounded to bf16 on both sides);
  * the bf16 PointNet victim (non-trivial BatchNorm statistics): logits
    within 1e-3 of max |logit|, the input gradient of sum(logits^2) within
    3e-2 of max |g|, and its logits more than 1e-3 from the port's own
    float32 victim's, which shows that the mode runs;
  * `bf16_grad_healthcheck` on a live and a dead victim, and the CLI: a
    bf16 PointNet attack on synthetic clouds writes its outputs, the
    float32 victim is the engine's `eval_logits_fn`, and a victim whose
    input gradient is zero is refused before any output.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geoa3_tpu.ops.pallas.pool_matmul_kernel as jpmk
from geoa3_tpu.models.pointnet import PointNet as JPointNet
from geoa3_tpu.models.registry import make_eval_fn as jmake_eval_fn
from geoa3_tpu.ops.pallas.pool_matmul_kernel import pool_affine_max as jpool
from geoa3_tpu_torch.cli import main_attack
from geoa3_tpu_torch.models import bf16_grad_healthcheck, build_model, make_eval_fn
from geoa3_tpu_torch.models.convert import from_flax_variables
from geoa3_tpu_torch.ops.kernels import pool_matmul_kernel as pk
from tests.test_torch_cli import _rate, _run, work  # noqa: F401 (fixture)
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(1)
B, N, CLASSES = 2, 128, 10

# label -> (taps, x in bf16, duplicated run length)
POOL_CASES = {
    "taps 1, bf16 x": (1, True, 0),
    "taps 1, float32 x": (1, False, 0),
    "taps 3, float32 x": (3, False, 0),
    # taps 3: a run's interior rows (its length less two) tie
    "taps 3, float32 x, eight duplicated rows": (3, False, 8),
    "taps 1, bf16 x, five duplicated rows": (1, True, 5),
}


@pytest.fixture
def forced_single_pass(monkeypatch):
    """The JAX victim's fused pools in their single-pass bf16 mode."""
    monkeypatch.setattr(jpmk, "pallas_available", lambda: True)
    monkeypatch.setattr(jpmk, "platform_f32_exact", lambda: False)


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_plain_single_pass_pool_matches_jax(case):
    taps, x_bf16, dup = POOL_CASES[case]
    rng = np.random.RandomState(len(case))
    x = np.maximum(rng.randn(2, 64, 128), 0).astype(np.float32)
    if dup:
        x[0, 20:20 + dup] = 3.0 * x[0, 20]
    w3 = jnp.asarray((rng.randn(taps, 128, 256) / np.sqrt(128 * taps))
                     .astype(np.float32)).astype(jnp.bfloat16)
    b = jnp.asarray(0.1 * rng.randn(256).astype(np.float32)).astype(jnp.bfloat16)
    g = rng.randn(2, 256).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16) if x_bf16 else jnp.asarray(x)
    want, vjp = jax.vjp(lambda v: jpool(v, w3, b, 0, False)[:, 0], xj)
    (dwant,) = vjp(jnp.asarray(g))
    want, dwant = np.asarray(want), np.asarray(dwant.astype(jnp.float32))

    xt = torch.from_numpy(x).to(torch.bfloat16 if x_bf16 else torch.float32)
    xt.requires_grad_(True)
    w3t = torch.from_numpy(np.array(w3.astype(jnp.float32))).to(torch.bfloat16)
    bt = torch.from_numpy(np.array(b.astype(jnp.float32)))
    got = pk.pool_affine_max_bf16(xt, w3t, bt)
    (dx,) = torch.autograd.grad((got * torch.from_numpy(g)).sum(), xt)
    assert got.dtype == torch.float32 and dx.dtype == xt.dtype
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(dx.float().numpy(), dwant, rtol=0,
                               atol=1e-5 * np.abs(dwant).max())
    pooled, cnt, rows = pk.pool_ties_bf16_plain(xt.detach(), w3t, bt)
    assert torch.equal(pooled, got.detach())
    if dup:
        assert (cnt > pk.MAX_TIES).any()  # a column past the recorded rows


@pytest.fixture(scope="module")
def victim():
    """(JAX model, its variables as jax arrays, the port's float32 model)."""
    jmodel = JPointNet(classes=CLASSES, npoint=N)
    variables = jmodel.init({"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, N, 3)), train=False)
    rng = np.random.RandomState(1)
    variables = {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng),
    }
    model = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
    model.load_state_dict(from_flax_variables(variables))
    return jmodel, jax.tree.map(jnp.asarray, variables), model


def _cloud(seed):
    pc = np.random.RandomState(seed).randn(B, N, 3).astype(np.float32)
    return pc / np.linalg.norm(pc, axis=-1).max()


def test_bf16_pointnet_matches_jax(victim, forced_single_pass):
    jmodel, variables, model = victim
    pc = _cloud(2)
    jfn = jmake_eval_fn(jmodel, variables, dtype=jnp.bfloat16)
    want = np.asarray(jfn(jnp.asarray(pc)))
    wgrad = np.asarray(jax.grad(lambda p: jnp.sum(jfn(p) ** 2))(jnp.asarray(pc)))

    logits_fn = make_eval_fn(model, dtype=torch.bfloat16)
    x = torch.from_numpy(pc).requires_grad_(True)
    got = logits_fn(x)
    (g,) = torch.autograd.grad((got ** 2).sum(), x)
    assert got.dtype == torch.float32 and g.dtype == torch.float32
    scale = np.abs(want).max()
    assert scale > 1e-2
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-3 * scale)
    np.testing.assert_allclose(g.numpy(), wgrad, rtol=0,
                               atol=3e-2 * np.abs(wgrad).max())
    # the mode runs: the float32 victim's logits are further away
    f32 = make_eval_fn(model)(torch.from_numpy(pc)).numpy()
    assert np.abs(got.detach().numpy() - f32).max() > 1e-3 * scale


def test_bf16_twin_leaves_the_float32_victim_alone(victim):
    _, _, model = victim
    pc = torch.from_numpy(_cloud(3))
    f32 = make_eval_fn(model)
    before = f32(pc)
    fold = model.conv5._fold if hasattr(model.conv5, "_fold") else None
    make_eval_fn(model, dtype=torch.bfloat16)(pc)
    assert model.conv1.weight.dtype == torch.float32
    assert getattr(model.conv5, "_fold", None) is fold
    assert torch.equal(f32(pc), before)


def test_bf16_twin_serves_eval_only(victim):
    _, _, model = victim
    import copy

    twin = copy.deepcopy(model).to(torch.bfloat16)
    pc = torch.from_numpy(_cloud(4)).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16 victim"):
        twin(pc, point_mask=torch.ones(B, N, dtype=torch.bool))
    with pytest.raises(ValueError, match="bf16 victim"):
        twin(pc, return_idx=True)
    with pytest.raises(ValueError, match="bf16 victim"):
        twin.train()(pc)


@pytest.mark.parametrize("arch", ["PointNetPP", "PointNetPP_MSG"])
def test_bf16_pointnetpp_is_refused(arch):
    model = build_model(arch, classes=CLASSES, npoint=N, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_eval_fn(model, dtype=torch.bfloat16)


def test_healthcheck_passes_a_live_victim(victim):
    _, _, model = victim
    assert bf16_grad_healthcheck(make_eval_fn(model, dtype=torch.bfloat16),
                                 b=4, n=64, device="cpu")


def test_healthcheck_refuses_a_dead_victim():
    def dead_fn(pc):  # logits fine, d/dx == 0
        return pc.detach().sum(dim=1)

    assert not bf16_grad_healthcheck(dead_fn, b=4, n=64, device="cpu")

    def zero_fn(pc):  # in the graph, with an all-zero gradient
        return 0.0 * pc.sum(dim=1)

    assert not bf16_grad_healthcheck(zero_fn, b=4, n=64, device="cpu")


def test_cli_bf16_victim(work, monkeypatch):  # noqa: F811
    """The bf16 attack on the CPU writes its outputs; the engine's gradient
    victim is the bf16 twin and its eval_logits_fn the float32 victim."""
    seen = {}
    real = main_attack.make_attack_fn

    def spy(logits_fn, cfg, **kw):
        seen["logits_fn"], seen["eval_logits_fn"] = logits_fn, kw.get("eval_logits_fn")
        return real(logits_fn, cfg, **kw)

    monkeypatch.setattr(main_attack, "make_attack_fn", spy)
    saved = _run(work, "bf16", "--victim_dtype", "bfloat16")
    mats = os.listdir(os.path.join(saved, "Mat"))
    assert mats and _rate(saved) == 10.0 * len(mats)
    assert os.path.isfile(os.path.join(saved, "attack_metrics.json"))
    model, _ = main_attack.load_victim("PointNet", 40, 64, work["ckpt"], "cpu")
    pc = torch.from_numpy(_cloud(5)[:, :64].copy())
    with torch.no_grad():
        f32 = model(pc)
        judged = seen["eval_logits_fn"](pc)
        grad_pass = seen["logits_fn"](pc)
    assert torch.equal(judged, f32)
    assert grad_pass.dtype == torch.float32 and not torch.equal(grad_pass, f32)


def test_cli_refuses_a_zero_gradient_bf16_victim(work, monkeypatch):  # noqa: F811
    real = main_attack.make_eval_fn

    def dead(model, dtype=None):
        fn = real(model, dtype)
        return fn if dtype is None else (lambda pc: fn(pc.detach()))

    monkeypatch.setattr(main_attack, "make_eval_fn", dead)
    with pytest.raises(SystemExit, match="all zero"):
        _run(work, "bf16_dead", "--victim_dtype", "bfloat16")
    assert not (work["dir"] / "bf16_dead").exists()  # refused before any output
