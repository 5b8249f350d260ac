"""The port's PointNet against the JAX PointNet, on the CPU.

Weights come from the JAX model's own initialiser with random BatchNorm
statistics (numpy seed), carried across by models.convert; a second case
loads a reference-style PyTorch state_dict into both packages. Small shapes:
b=2, n=128, 10 classes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geoa3_tpu.models.convert import convert_pointnet_state_dict
from geoa3_tpu.models.pointnet import PointNet as JPointNet
from geoa3_tpu_torch.models import build_model, make_eval_fn
from geoa3_tpu_torch.models.convert import (
    from_flax_variables,
    load_reference_state_dict,
)
from geoa3_tpu_torch.models.pointnet import PointNet

torch.set_num_threads(1)
B, N, CLASSES = 2, 128, 10


def _randomise_bn(tree, rng):
    """Non-trivial BatchNorm scale/bias and running statistics."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomise_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        elif k == "mean" or (k == "bias" and "scale" in tree):
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def jax_victim():
    model = JPointNet(classes=CLASSES, npoint=N)
    variables = model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, N, 3)), train=False
    )
    rng = np.random.RandomState(1)
    variables = {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng
        ),
    }
    return model, variables


def _clouds(seed):
    rng = np.random.RandomState(seed)
    pc = rng.randn(B, N, 3).astype(np.float32)
    return pc / np.linalg.norm(pc, axis=-1).max()


def _port(variables):
    model = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
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
    assert np.abs(want).max() > 1e-2  # the victim is not degenerate
    # float32 layers in other summation orders, and the port folds the
    # pools' BatchNorm into the conv weights (the JAX CPU path does not)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(x.grad.numpy(), wgrad, rtol=1e-3,
                               atol=1e-4 * np.abs(wgrad).max())



@pytest.mark.parametrize("masked", [False, True])
def test_return_idx_matches_jax(jax_victim, masked):
    """conv5's max-pool argmax (the critical points) of the JAX model's
    `return_idx`, with and without a point mask; a masked point is never
    chosen, and the logits are those of the plain forward."""
    _, variables = jax_victim
    jmodel = JPointNet(classes=CLASSES, npoint=N, return_idx=True)
    pc = _clouds(4)
    mask = np.random.RandomState(5).rand(B, N) > 0.3 if masked else None
    jlogits, jidx = jmodel.apply(
        variables, jnp.asarray(pc), train=False,
        point_mask=None if mask is None else jnp.asarray(mask))
    model = _port(variables)
    tmask = None if mask is None else torch.from_numpy(mask)
    logits, idx = model(torch.from_numpy(pc), point_mask=tmask, return_idx=True)
    assert idx.shape == (B, 1024)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if mask is not None:
        assert np.take_along_axis(mask, idx.numpy(), axis=1).all()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4 * np.abs(jlogits).max())
    plain = model(torch.from_numpy(pc), point_mask=tmask)
    np.testing.assert_allclose(logits.detach().numpy(), plain.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="eval-mode"):
        model.train()(torch.from_numpy(pc), return_idx=True)

def _reference_state_dict(rng):
    """A state_dict with the reference PyTorch PointNet's names and shapes."""
    sd = {}

    def conv(name, cin, cout, k=1):
        sd[f"{name}.weight"] = (rng.randn(cout, cin, k) / np.sqrt(cin * k)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)

    def linear(name, cin, cout):
        sd[f"{name}.weight"] = (rng.randn(cout, cin) / np.sqrt(cin)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = (0.5 + rng.rand(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_mean"] = (0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.running_var"] = (0.5 + rng.rand(c)).astype(np.float32)

    for tn, K in (("input_transform", 3), ("feature_transform", 64)):
        conv(f"{tn}.conv1", K, 64)
        conv(f"{tn}.conv2", 64, 128)
        conv(f"{tn}.conv3", 128, 1024)
        linear(f"{tn}.fc1", 1024, 512)
        linear(f"{tn}.fc2", 512, 256)
        linear(f"{tn}.fc3", 256, K * K)
        for i, c in enumerate((64, 128, 1024, 512, 256), start=1):
            bn(f"{tn}.bn{i}", c)
    for name, cin, cout in (("conv1", 3, 64), ("conv2", 64, 64),
                            ("conv3", 64, 64), ("conv4", 64, 128)):
        conv(name, cin, cout)
    conv("conv5", 128, 1024, k=3)
    linear("fc1", 1024, 512)
    linear("fc2", 512, 256)
    linear("fc3", 256, CLASSES)
    for i, c in enumerate((64, 64, 64, 128, 1024, 512, 256), start=1):
        bn(f"bn{i}", c)
    return sd


def test_reference_state_dict_loads_alike():
    sd = _reference_state_dict(np.random.RandomState(3))
    jmodel = JPointNet(classes=CLASSES, npoint=N)
    want = np.asarray(jmodel.apply(convert_pointnet_state_dict(sd),
                                   jnp.asarray(_clouds(4)), train=False))
    model = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
    load_reference_state_dict(model, {f"module.{k}": v for k, v in sd.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(_clouds(4))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_kept_pool_fold_follows_new_weights():
    """The pools keep their BatchNorm-folded weights between calls; loading
    other weights into the same model must give that model's logits, exactly
    as a model that never saw the first weights."""
    sd_a = _reference_state_dict(np.random.RandomState(6))
    sd_b = _reference_state_dict(np.random.RandomState(7))
    pc = torch.from_numpy(_clouds(8))
    model = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
    fresh = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
    load_reference_state_dict(model, sd_a)
    load_reference_state_dict(fresh, sd_b)
    with torch.no_grad():
        first = model(pc)
        assert torch.equal(model(pc), first)  # the kept fold is reused
        load_reference_state_dict(model, sd_b)
        assert torch.equal(model(pc), fresh(pc))


def test_reference_state_dict_must_be_complete():
    sd = _reference_state_dict(np.random.RandomState(5))
    del sd["conv5.weight"]
    model = build_model("PointNet", classes=CLASSES, npoint=N, device="cpu")
    with pytest.raises(KeyError, match="conv5.weight"):
        load_reference_state_dict(model, sd)


def test_structure_mirrors_reference():
    model = PointNet(classes=CLASSES)
    assert model.conv5.kernel_size == (3,) and model.conv5.padding == (1,)
    for name in ("bn1", "bn2", "bn3", "bn4", "bn5"):
        assert getattr(model, name).eps == 1e-3
        assert getattr(model.input_transform, name).eps == 1e-3
    assert model.bn6.eps == 1e-5 and model.bn7.eps == 1e-5
    assert model.dropout.p == 0.3
    eye = model.feature_transform.fc3.bias.detach().reshape(64, 64)
    assert torch.equal(eye, torch.eye(64))
    assert torch.count_nonzero(model.feature_transform.fc3.weight) == 0


def test_unported_modes_raise():
    with pytest.raises(ValueError, match="Not support such arch"):
        build_model("PointNetPP_SSG", device="cpu")
    assert build_model("PointNetPP", device="cpu").SA_modules[0].npoint == 512
    assert build_model("PointNetPP_MSG", device="cpu").SA_modules[0].nsamples == (
        16, 32, 128)
    # train mode is ported: a fresh module trains and returns the logits
    # and the feature transform, also on one cloud (flax's BatchNorm of one
    # row); the dropout draws from the generator given
    model = PointNet(classes=CLASSES)
    pc = torch.from_numpy(_clouds(3))
    g = torch.Generator().manual_seed(0)
    logits, transform = model(pc, generator=g)
    assert logits.shape == (B, CLASSES) and transform.shape == (B, 64, 64)
    again, _ = model(pc, generator=torch.Generator().manual_seed(0))
    assert torch.equal(logits, again)
    one, _ = model(pc[:1], generator=g)
    assert one.shape == (1, CLASSES) and torch.isfinite(one).all()
