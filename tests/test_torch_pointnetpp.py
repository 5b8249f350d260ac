"""The port's PointNet++ SSG victim against the JAX model, on the CPU.

Weights come from the JAX model's own initialiser with random BatchNorm
statistics (numpy seed), carried across by models.convert; clouds of 1024
points, so that every set-abstraction level runs at its published shape
(1024 -> 512 x 64 -> 128 x 64 -> one group of 128). The JAX side is its
unfused CPU path (ball_query + group_points + Dense/BatchNorm/ReLU + max);
the port folds the BatchNorms into the layers and runs the kernels' plain
versions. 10 classes, b=2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu.models.convert import convert_pointnetpp_state_dict
from geoa3_tpu.models.pointnetpp import PointNet2ClassificationSSG as JSSG
from geoa3_tpu_torch.models import build_model, make_eval_fn
from geoa3_tpu_torch.models.convert import (
    from_flax_variables,
    load_reference_state_dict,
)
from geoa3_tpu_torch.models.pointnetpp import (
    PointNet2ClassificationSSG,
    PointnetSAModule,
    SharedMLP,
)
from geoa3_tpu_torch.utils.checkpoint import load_victim_state
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(2)
B, N, CLASSES = 2, 1024, 10


def _variables(model, channels, seed):
    variables = model.init({"params": jax.random.PRNGKey(seed)},
                           jnp.zeros((1, N, channels)), train=False)
    rng = np.random.RandomState(seed + 1)
    return {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng),
    }


def _clouds(seed, n=N):
    rng = np.random.RandomState(seed)
    pc = rng.randn(B, n, 3).astype(np.float32)
    return pc / np.linalg.norm(pc, axis=-1).max()


@pytest.fixture(scope="module")
def jax_victim():
    model = JSSG(classes=CLASSES)
    return model, _variables(model, 3, 0)


def _port(variables, **kw):
    model = PointNet2ClassificationSSG(classes=CLASSES, **kw).eval()
    model.load_state_dict(from_flax_variables(variables))
    return model


def test_logits_and_input_grad_match_jax(jax_victim):
    jmodel, variables = jax_victim
    pc = _clouds(2)

    def jloss(p):
        return jnp.sum(jmodel.apply(variables, p, train=False) ** 2)

    want = np.asarray(jmodel.apply(variables, jnp.asarray(pc), train=False))
    wgrad = np.asarray(jax.grad(jloss)(jnp.asarray(pc)))

    logits_fn = make_eval_fn(_port(variables))
    x = torch.from_numpy(pc).requires_grad_(True)
    got = logits_fn(x)
    (got**2).sum().backward()
    assert np.abs(want).max() > 1e-2 and np.abs(wgrad).max() > 1e-3
    # float32 layers in other summation orders, BatchNorm folded into the
    # weights: the tolerances of the JAX package's own fused-against-unfused
    # test (tests/test_pallas_kernels.py, TestFusedQueryGroupPipeline)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(x.grad.numpy(), wgrad, rtol=5e-3, atol=5e-3)
    # and far inside them, against the largest entry
    assert np.abs(got.detach().numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert np.abs(x.grad.numpy() - wgrad).max() <= 1e-3 * np.abs(wgrad).max()


def test_normals_as_features_match_jax():
    jmodel = JSSG(classes=CLASSES, use_normal=True)
    variables = _variables(jmodel, 6, 3)
    rng = np.random.RandomState(4)
    nrm = rng.randn(B, N, 3).astype(np.float32)
    pc = np.concatenate([_clouds(5), nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)], -1)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(pc), train=False))
    model = _port(variables, use_normal=True)
    assert model.SA_modules[0].mlps[0][0].weight.shape == (64, 6, 1, 1)
    with torch.no_grad():
        got = model(torch.from_numpy(pc)).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)
    with pytest.raises(ValueError, match=r"\[b, n, 6\]"):
        model(torch.from_numpy(pc[..., :3]))


def test_reference_state_dict_round_trip(jax_victim, tmp_path):
    """from_flax_variables writes the reference's names: the JAX package's
    own converter reads them back into the same tree, and they load into the
    port from a DataParallel-prefixed checkpoint file."""
    _, variables = jax_victim
    sd = from_flax_variables(variables)
    assert "SA_modules.1.mlps.0.3.weight" in sd and "fc_layer.7.bias" in sd
    assert sd["SA_modules.2.mlps.0.0.weight"].shape == (256, 259, 1, 1)
    back = convert_pointnetpp_state_dict({k: v.numpy() for k, v in sd.items()})
    want_leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))

    path = tmp_path / "model_best.pth.tar"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, path)
    model = build_model("PointNetPP", classes=CLASSES, device="cpu")
    load_reference_state_dict(model, load_victim_state(str(tmp_path), "PointNetPP"))
    pc = torch.from_numpy(_clouds(6))
    with torch.no_grad():
        assert torch.equal(model(pc), _port(variables)(pc))
    del sd["SA_modules.0.mlps.0.1.running_var"]
    with pytest.raises(KeyError, match="running_var"):
        load_reference_state_dict(model, sd)


def test_kept_fold_follows_new_weights(jax_victim):
    """The shared MLPs keep their BatchNorm-folded weights between calls;
    loading other weights into the same model must give that model's logits."""
    _, variables = jax_victim
    other = _variables(JSSG(classes=CLASSES), 3, 7)
    pc = torch.from_numpy(_clouds(8))
    model, fresh = _port(variables), _port(other)
    with torch.no_grad():
        first = model(pc)
        fold = model.SA_modules[0].mlps[0].folded()
        assert model.SA_modules[0].mlps[0].folded() is fold  # kept
        assert torch.equal(model(pc), first)
        model.load_state_dict(from_flax_variables(other))
        assert model.SA_modules[0].mlps[0].folded() is not fold
        assert torch.equal(model(pc), fresh(pc))
        assert not torch.equal(first, fresh(pc))


def test_structure_mirrors_reference():
    model = PointNet2ClassificationSSG(classes=CLASSES)
    names = [n for n, _ in model.named_parameters()]
    assert "SA_modules.0.mlps.0.0.weight" in names
    assert "SA_modules.2.mlps.0.7.bias" in names  # the third BatchNorm2d
    assert not any(n.endswith("0.bias") and "mlps" in n for n in names)  # bias-free convs
    assert [sa.npoint for sa in model.SA_modules] == [512, 128, None]
    assert [sa.radii[0] for sa in model.SA_modules] == [0.2, 0.4, None]
    assert [m.widths for sa in model.SA_modules for m in sa.mlps] == [
        (64, 64, 128), (128, 128, 256), (256, 512, 1024)]
    assert model.fc_layer[1].eps == 1e-5 and model.fc_layer[6].p == 0.5
    assert model.fc_layer[0].bias is None and model.fc_layer[7].bias is not None
    sa = PointnetSAModule([8, 8, 16], npoint=4, radius=0.5, nsample=4)
    assert sa.mlps[0][0].weight.shape == (8, 3, 1, 1)


def test_unported_modes_raise():
    model = PointNet2ClassificationSSG(classes=CLASSES)  # a fresh module trains
    with pytest.raises(NotImplementedError, match="train mode"):
        model(torch.zeros(1, N, 3))
    with pytest.raises(NotImplementedError, match="train mode"):
        build_model("PointNetPP_MSG", device="cpu").train()(torch.zeros(1, N, 3))
    with pytest.raises(FileNotFoundError):  # the MSG victim is ported now
        load_victim_state("nowhere", "PointNetPP_MSG")
    with pytest.raises(ValueError, match="Not support such arch"):
        load_victim_state("nowhere", "PointNetPP_SSG")
    with pytest.raises(NotImplementedError, match="use_xyz"):
        PointnetSAModule([8, 8, 16], npoint=4, radius=0.5, nsample=4, use_xyz=False)
    with pytest.raises(NotImplementedError, match="three layers"):
        SharedMLP(3, [8, 16]).eval()(torch.zeros(1, 2, 4, 3), None)
    with pytest.raises(NotImplementedError, match="three layers"):
        SharedMLP(6, [8, 16]).eval().whole_scale(
            torch.zeros(1, 8, 3), torch.zeros(1, 2, 3), torch.zeros(1, 8, 3), 0.5, 4)


def test_attack_on_the_ssg_victim_matches_jax(jax_victim):
    """A few steps of the default attack (CE + Chamfer + Hausdorff +
    curvature) on the SSG victim against the JAX engine, from the JAX
    engine's own initial offsets. The JAX engine compiles one search step at
    a time (host_binary_loop), which keeps its CPU compile short."""
    from geoa3_tpu.attack import AttackConfig as JConfig
    from geoa3_tpu.attack import engine as jengine
    from geoa3_tpu.models.registry import make_eval_fn as jmake_eval_fn
    from geoa3_tpu_torch.attack import AttackConfig, engine
    from geoa3_tpu_torch.data.synthetic import sample_shape

    jmodel, variables = jax_victim
    jfn = jmake_eval_fn(jmodel, variables)
    tfn = make_eval_fn(_port(variables))
    rng = np.random.RandomState(9)
    pcs, nrms = zip(*(sample_shape(i, N, rng) for i in (1, 6)))
    pc, nrm = np.stack(pcs), np.stack(nrms)
    pred = np.asarray(jfn(jnp.asarray(pc))).argmax(-1)
    gt = np.array([pred[0], (pred[1] + 1) % CLASSES], np.int64)
    steps = 4
    cfg = dict(arch="PointNetPP", attack_label="Untarget", classes=CLASSES,
               npoint=N, curv_loss_knn=8, binary_max_steps=1,
               iter_max_steps=steps, curv_knn_refresh_every=2)
    key = jax.random.PRNGKey(10)
    want = jengine.make_attack_fn(jfn, JConfig(**cfg), host_binary_loop=True)(
        jnp.asarray(pc), jnp.asarray(nrm), jnp.asarray(gt), jnp.asarray(gt), key)
    # the JAX engine's initial offset: key -> split -> k_run -> split -> k_init
    k_init = jax.random.split(jax.random.split(key)[1])[0]
    offset = np.array(1e-3 * jax.random.normal(k_init, (B, N, 3), jnp.float32))
    got = engine.make_attack_fn(
        tfn, AttackConfig(**cfg), init_offset=lambda i: torch.from_numpy(offset)
    )(*(torch.from_numpy(a) for a in (pc, nrm, gt, gt)))

    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_array_equal(got.best_attack_step.numpy(),
                                  np.asarray(want.best_attack_step))
    assert got.success[1] and got.all_loss.shape == (steps, B)
    # the tolerances of tests/test_torch_attack.py's whole-attack test
    np.testing.assert_allclose(got.all_loss.numpy(), np.asarray(want.all_loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.best_loss.numpy(), np.asarray(want.best_loss),
                               rtol=5e-3)
    np.testing.assert_allclose(got.best_attack.numpy(), np.asarray(want.best_attack),
                               rtol=0, atol=5e-3)
