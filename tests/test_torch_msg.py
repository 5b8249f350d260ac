"""The port's PointNet++ MSG victim against the JAX model, on the CPU.

Weights come from the JAX model's own initialiser with random BatchNorm
statistics (numpy seed), carried across by models.convert; clouds of 1024
points, so that every set-abstraction level runs at its published shape
(1024 -> 512 x {16, 32, 128} -> 128 x {32, 64, 128} with 320 features -> one
group of 128 with 640). The JAX side is its unfused CPU path (ball_query +
group_points + Dense/BatchNorm/ReLU + max); the port folds the BatchNorms
into the layers and runs the kernels' plain versions, SA2 (cf = 320) through
the whole-scale op as the JAX package routes it on the TPU. 10 classes,
b=2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu.models.convert import convert_pointnetpp_state_dict
from geoa3_tpu.models.pointnetpp import PointNet2ClassificationMSG as JMSG
from geoa3_tpu_torch.models import build_model, make_eval_fn
from geoa3_tpu_torch.models.convert import (
    from_flax_variables,
    load_reference_state_dict,
)
from geoa3_tpu_torch.models.pointnetpp import PointNet2ClassificationMSG
from geoa3_tpu_torch.ops.kernels import KERNELS
from geoa3_tpu_torch.utils.checkpoint import load_victim_state
from tests.test_torch_pointnetpp import _clouds, _variables

torch.set_num_threads(2)
B, N, CLASSES = 2, 1024, 10


@pytest.fixture(scope="module")
def jax_victim():
    model = JMSG(classes=CLASSES)
    return model, _variables(model, 3, 10)


def _port(variables, **kw):
    model = PointNet2ClassificationMSG(classes=CLASSES, **kw).eval()
    model.load_state_dict(from_flax_variables(variables))
    return model


def _jax_logits_and_grad(jmodel, variables, pc):
    def loss(p):
        out = jmodel.apply(variables, p, train=False)
        return jnp.sum(out ** 2), out

    (_, out), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(pc))
    return np.asarray(out), np.asarray(grad)


def _port_logits_and_grad(model, pc):
    x = torch.from_numpy(pc).requires_grad_(True)
    out = make_eval_fn(model)(x)
    (out ** 2).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def _compare(got, want):
    (out, grad), (wout, wgrad) = got, want
    assert np.abs(wout).max() > 1e-2 and np.abs(wgrad).max() > 1e-4
    # float32 layers in other summation orders, BatchNorm folded into the
    # weights, SA2's layer 1 from per-point projections: the tolerances of
    # tests/test_torch_pointnetpp.py's SSG test, which are the JAX package's
    # own fused-against-unfused model test's (tests/test_pallas_kernels.py,
    # TestSAFusedPipeline)
    np.testing.assert_allclose(out, wout, rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(grad, wgrad, rtol=5e-3, atol=5e-3)
    # and far inside them, against the largest entry
    assert np.abs(out - wout).max() <= 1e-4 * np.abs(wout).max()
    assert np.abs(grad - wgrad).max() <= 1e-3 * np.abs(wgrad).max()


def test_logits_and_input_grad_match_jax(jax_victim):
    jmodel, variables = jax_victim
    pc = _clouds(11)
    _compare(_port_logits_and_grad(_port(variables), pc),
             _jax_logits_and_grad(jmodel, variables, pc))


def test_normals_as_features_match_jax():
    """[b, n, 6]: SA1 takes 3 feature channels, so every scale of both
    levels goes through the whole-scale op (cf = 3 and 320)."""
    jmodel = JMSG(classes=CLASSES, use_normal=True)
    variables = _variables(jmodel, 6, 12)
    rng = np.random.RandomState(13)
    nrm = rng.randn(B, N, 3).astype(np.float32)
    pc = np.concatenate(
        [_clouds(14), nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)], -1)
    model = _port(variables, use_normal=True)
    assert model.SA_modules[0].mlps[2][0].weight.shape == (64, 6, 1, 1)
    _compare(_port_logits_and_grad(model, pc),
             _jax_logits_and_grad(jmodel, variables, pc))


def test_structure_mirrors_reference():
    model = build_model("PointNetPP_MSG", classes=CLASSES, device="cpu")
    assert isinstance(model, PointNet2ClassificationMSG) and not model.training
    assert [sa.npoint for sa in model.SA_modules] == [512, 128, None]
    assert [sa.radii for sa in model.SA_modules] == [
        (0.1, 0.2, 0.4), (0.2, 0.4, 0.8), (None,)]
    assert [sa.nsamples for sa in model.SA_modules] == [
        (16, 32, 128), (32, 64, 128), (None,)]
    assert [[m.widths for m in sa.mlps] for sa in model.SA_modules] == [
        [(32, 32, 64), (64, 64, 128), (64, 96, 128)],
        [(64, 64, 128), (128, 128, 256), (128, 128, 256)],
        [(256, 512, 1024)]]
    # SA inputs 3 -> 3 + 320 -> 3 + 640
    assert [sa.mlps[0][0].weight.shape[1] for sa in model.SA_modules] == [3, 323, 643]
    assert model.fc_layer[0].in_features == 1024


def test_reference_state_dict_round_trip(jax_victim, tmp_path):
    """from_flax_variables writes the reference's names for all three
    scales a level: the JAX package's own converter reads them back into the
    same tree, and they load into the port from a checkpoint file."""
    jmodel, variables = jax_victim
    sd = from_flax_variables(variables)
    assert "SA_modules.1.mlps.2.6.weight" in sd and "fc_layer.7.bias" in sd
    assert sd["SA_modules.1.mlps.0.0.weight"].shape == (64, 323, 1, 1)
    back = convert_pointnetpp_state_dict({k: v.numpy() for k, v in sd.items()})
    want_leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want_leaves)
    for path, leaf in want_leaves:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))

    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               tmp_path / "model_best.pth.tar")
    model = build_model("PointNetPP_MSG", classes=CLASSES, device="cpu")
    load_reference_state_dict(model, load_victim_state(str(tmp_path), "PointNetPP_MSG"))
    pc = torch.from_numpy(_clouds(15))
    with torch.no_grad():
        assert torch.equal(model(pc), _port(variables)(pc))
    del sd["SA_modules.1.mlps.2.7.running_mean"]
    with pytest.raises(KeyError, match="running_mean"):
        load_reference_state_dict(model, sd)


def test_routes_follow_the_jax_shape_rule(jax_victim, monkeypatch):
    """SA1 (cf = 0) and GroupAll take the split pair and the grouped MLP;
    SA2 (cf = 320) takes the whole-scale op, one call a scale."""
    from geoa3_tpu_torch import ops

    calls = {"ball_query_group": 0, "group_mlp_maxpool": 0, "sa_query_group_mlp": 0}
    for name in calls:
        orig = getattr(ops, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(ops, name, counted)
    with torch.no_grad():
        _port(jax_victim[1])(torch.from_numpy(_clouds(16)))
    assert calls == {"ball_query_group": 3, "group_mlp_maxpool": 4,
                     "sa_query_group_mlp": 3}
    assert all(fn.launches == 0 for fn in KERNELS.values())  # CPU: plain
