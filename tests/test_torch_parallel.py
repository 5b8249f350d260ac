"""The port's data and tensor parallel (geoa3_tpu_torch/parallel) on gloo
ranks on the CPU, against the JAX package's sharded programs on its virtual
8-device mesh (tests/conftest.py) and against the port's own
single-process runs.

The ranks are separate processes (tests/torch_parallel_workers.py: torch
and the port only), each group joined through a file under tmp_path and
run with a time limit, so that no test can hang the suite. The groups start
before the JAX references are computed and run beside them.

  * The sharded attack, 2 ranks, on tests/test_parallel.py's toy victim and
    inputs, with the JAX engine's initial offsets fed as the global
    `init_offset`: against JAX's `make_sharded_attack_fn` at that test's
    tolerances (success equal, best_loss rtol 1e-4, best_attack atol 1e-4).
  * The sharded attack against the port's single-process attack at one
    seed, in default, jitter (+ projection and clip), subsample and
    partial-variable mode, and in the last three with the side draws given
    by the caller (`draws`) at the global shape: the same function per row, the same draws
    (every rank draws at the global shape), so the same numbers up to the
    rounding of one float32 sum (best_loss rtol 1e-5, best_attack atol
    1e-6).
  * One train step in float64 of PointNet at data 2, at data 1 x model 2
    and (4 ranks) at data 2 x model 2, and of PointNet++ SSG at data 2,
    against JAX's `make_sharded_train_step` with the dropout masks of the
    JAX apply: the loss (1e-5 relative), the gradients (1e-4 of each
    tensor's largest entry, test_torch_train.py's rule), the running
    statistics (1e-5 of the largest) and the parameters after Adam's step
    (1e-4 of the step's size, lr). Each model rank holds 512 of conv5's
    1024 rows and of its Adam moments.
  * The CLI with --mesh_data_parallel on 2 ranks (joined through a file)
    writes, from rank 0 alone, the Mat/ files of the single-process CLI.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

import geoa3_tpu.train as JT
from geoa3_tpu import parallel as jparallel
from geoa3_tpu.attack import AttackConfig as JConfig
from geoa3_tpu_torch.attack import AttackConfig, engine
from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main
from geoa3_tpu_torch.models.convert import from_flax_variables
from tests import torch_parallel_workers as W
from tests.test_torch_train import (
    PN,
    PP,
    _cfgs,
    _clouds,
    _jax_step,
    _port_model,
    _variables,
    _vanishing,
)

torch.set_num_threads(1)
B, N = 8, 32


class _Group:
    """A group of rank processes started now and read later."""

    def __init__(self, case, world, workdir, inputs, timeout=150):
        import threading

        self.out, self.err = None, None

        def run():
            try:
                self.out = W.launch(case, world, workdir, inputs, timeout)
            except Exception as e:  # re-raised by result()
                self.err = e

        self.thread = threading.Thread(target=run)
        self.thread.start()

    def result(self):
        self.thread.join()
        if self.err is not None:
            raise self.err
        return self.out


def _jax_victim(scale=2.0):
    Wj = jax.random.normal(jax.random.PRNGKey(0), (3, 8))

    def logits_fn(pc):
        return scale * jnp.max(jnp.einsum("bnd,dc->bnc", pc, Wj), axis=1)

    return logits_fn, np.asarray(Wj)


def _clouds_normals(rng, b, n):
    pc = rng.randn(b, n, 3).astype(np.float32) * 0.3
    normal = rng.randn(b, n, 3).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return pc, normal


def _jax_offsets(key, bs_steps, shape):
    """The JAX engine's initial offsets (tests/test_torch_attack.py)."""
    out = []
    for _ in range(bs_steps):
        key, k_run = jax.random.split(key)
        k_init, _ = jax.random.split(k_run)
        out.append(torch.from_numpy(np.array(
            1e-3 * jax.random.normal(k_init, shape, jnp.float32))))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def attack(tmp_path_factory):
    """The 2-rank attack group, the JAX sharded reference and the port's
    single-process runs."""
    jvictim, Wn = _jax_victim()
    rng = np.random.RandomState(0)
    pc, normal = _clouds_normals(rng, B, N)
    gt = np.argmax(np.asarray(jvictim(jnp.asarray(pc))), -1).astype(np.int64)
    jcfg = dict(attack_label="Untarget", classes=8, npoint=N,
                binary_max_steps=1, iter_max_steps=10, curv_loss_knn=4)
    key = jax.random.PRNGKey(0)
    modes = {}
    for i, (mode, (cfg, n)) in enumerate(W.MODES.items()):
        mpc, mnrm = _clouds_normals(np.random.RandomState(10 + i), B, n)
        mgt = (2.0 * (mpc @ Wn).max(axis=1)).argmax(-1)
        modes[mode] = dict(cfg=cfg, pc=_t(mpc), normal=_t(mnrm),
                           gt=_t(mgt), seed=i)
    inputs = dict(W=_t(Wn), modes=modes, jax=dict(
        cfg=jcfg, pc=_t(pc), normal=_t(normal), gt=_t(gt),
        offsets=_jax_offsets(key, 1, (B, N, 3))))
    group = _Group("attack", 2, tmp_path_factory.mktemp("attack_ranks"), inputs)

    mesh = jparallel.make_mesh()
    fn = jparallel.make_sharded_attack_fn(jvictim, JConfig(**jcfg), mesh)
    spc, snormal, sgt = jparallel.shard_batch(mesh, pc, normal, gt.astype(np.int32))
    jres = fn(spc, snormal, sgt, sgt, key)
    single = {}
    victim = W.toy_victim(inputs["W"], 2.0)
    for mode, m in modes.items():
        fn1 = engine.make_attack_fn(victim, AttackConfig(**m["cfg"]))
        single[mode] = fn1(m["pc"], m["normal"], m["gt"], m["gt"],
                           torch.Generator().manual_seed(m["seed"]))
    for mode in W.DRAW_MODES:
        m = modes[mode]
        cfg = AttackConfig(**m["cfg"])
        fn1 = engine.make_attack_fn(victim, cfg,
                                    draws=W.SeededDraws(*m["pc"].shape[:2], cfg))
        single[f"draws_{mode}"] = fn1(m["pc"], m["normal"], m["gt"], m["gt"],
                                      torch.Generator().manual_seed(m["seed"]))
    return dict(jax=jres, single=single, inputs=inputs, ranks=group.result())


def test_sharded_attack_matches_jax(attack):
    got, want = attack["ranks"][0]["jax"], attack["jax"]
    np.testing.assert_array_equal(got["success"].numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got["best_loss"].numpy(), np.asarray(want.best_loss),
                               rtol=1e-4)
    np.testing.assert_allclose(got["best_attack"].numpy(),
                               np.asarray(want.best_attack), atol=1e-4)


@pytest.mark.parametrize("mode", sorted(W.MODES) + [f"draws_{m}" for m in W.DRAW_MODES])
def test_sharded_attack_matches_single_process(attack, mode):
    """draws_*: the side draws given by the caller at the global shape."""
    one = attack["single"][mode]
    for rank_out in attack["ranks"]:  # every rank returns the global result
        got = rank_out[mode]
        for name in ("success", "best_attack_step", "best_attack_bs_idx", "target"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          getattr(one, name).numpy(), err_msg=name)
        np.testing.assert_allclose(got["best_loss"].numpy(), one.best_loss.numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["best_attack"].numpy(),
                                   one.best_attack.numpy(), atol=1e-6)
        np.testing.assert_allclose(got["all_loss"].numpy(), one.all_loss.numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert attack["single"][mode].success.any(), "no row succeeds: a vacuous check"


def test_sharded_attack_with_separate_eval_fn(attack):
    """tests/test_parallel.py:76-101: the success judge is another victim;
    every recorded success holds under it."""
    res = attack["ranks"][0]["judged"]
    inp = attack["inputs"]
    judge = W.toy_victim(inp["W"], 2.5)
    preds = judge(res["best_attack"]).argmax(-1).numpy()
    succ, gt = res["success"].numpy(), inp["jax"]["gt"].numpy()
    assert succ.any() and (preds[succ] != gt[succ]).all()


def test_mesh_shapes_and_batch_split(attack):
    for r, out in enumerate(attack["ranks"]):
        assert out["mesh"] == (2, 1)
        assert out["rows"] == [[0, 1, 2, 3], [4, 5, 6, 7]][r]
        assert "does not split over 2 data ranks" in out["uneven"]
        assert "mesh needs 4 ranks" in out["too_big"]


# ---------------------------------------------------------------- training

TRAIN_RUNS = {  # name -> (arch config, (n_data, n_model), world)
    "PointNet_dp2": (PN, (2, 1), 2),
    "PointNet_tp2": (PN, (1, 2), 2),
    "PointNetPP_dp2": (dict(arch="PointNetPP", **PP), (2, 1), 2),
    "PointNet_dp2_tp2": (PN, (2, 2), 4),
}


def _jax_sharded_step(jcfg, variables, pc, target, seed, mesh_shape):
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        state = JT.TrainState(v["params"], v["batch_stats"],
                              JT.make_optimizer(jcfg).init(v["params"]),
                              jnp.zeros((), jnp.int32))
        n = mesh_shape[0] * mesh_shape[1]
        mesh = jparallel.make_mesh(*mesh_shape, devices=jax.devices()[:n])
        step, place = jparallel.make_sharded_train_step(
            jcfg, mesh, tensor_parallel=mesh_shape[1] > 1)
        new, metrics = step(place(state), jnp.asarray(pc, jnp.float64),
                            jnp.asarray(target), jax.random.PRNGKey(seed))
        tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
        return dict(loss=float(metrics["loss"]), params=tree(new.params),
                    stats=tree(new.batch_stats))


@pytest.fixture(scope="module")
def train(tmp_path_factory):
    variables, runs, refs = {}, {}, {}
    for name, (kw, mesh_shape, world) in TRAIN_RUNS.items():
        jcfg, tcfg = _cfgs(**kw)
        if jcfg.arch not in variables:
            variables[jcfg.arch] = _variables(jcfg, 0)
        v = variables[jcfg.arch]
        b = jcfg.batch_size
        pc = _clouds(b, jcfg.npoint, 1)
        target = np.arange(b) % jcfg.classes
        want = _jax_step(jcfg, v, pc, target, 3, x64=True)
        model = _port_model(tcfg, v).double()
        runs.setdefault(world, {})[name] = dict(
            cfg=kw, mesh=mesh_shape, state_dict=model.state_dict(),
            pc=_t(pc).double(), target=_t(target), keep=want["keep"],
            eval=mesh_shape[1] > 1)
        refs[name] = (jcfg, v, pc, target, want, mesh_shape)
    groups = {world: _Group("train", world, tmp_path_factory.mktemp(f"train{world}"),
                            dict(runs=r)) for world, r in runs.items()}
    out = {}
    for name, (jcfg, v, pc, target, want, mesh_shape) in refs.items():
        out[name] = dict(want=want, sharded=_jax_sharded_step(
            jcfg, v, pc, target, 3, mesh_shape), lr=jcfg.lr)
    for world, group in groups.items():
        for r, rank_out in enumerate(group.result()):
            for name, rec in rank_out.items():
                out[name].setdefault("ranks", {})[rec["coords"]] = rec
    return out


@pytest.mark.parametrize("run", list(TRAIN_RUNS))
def test_sharded_train_step_matches_jax(train, run):
    rec = train[run]
    want, sharded, ranks = rec["want"], rec["sharded"], rec["ranks"]
    n_model = TRAIN_RUNS[run][1][1]
    first = ranks[(0, 0)]
    # every rank reports the global loss, the one of JAX's sharded step
    for r in ranks.values():
        np.testing.assert_allclose(float(r["loss"]), sharded["loss"], rtol=1e-5)
    np.testing.assert_allclose(sharded["loss"], want["loss"], rtol=1e-5)
    grads = from_flax_variables({"params": want["grads"], "batch_stats": want["stats"]})
    gmax = max(np.abs(grads[k].numpy()).max() for k in first["grads"])
    after = from_flax_variables({"params": sharded["params"],
                                 "batch_stats": sharded["stats"]})
    for k, p in first["params"].items():
        split = p.shape != after[k].shape
        assert split == (n_model > 1 and p.dim() >= 2 and after[k].shape[0] >= 512), k
        g = torch.cat([ranks[(0, m)]["grads"][k] for m in range(n_model)]) if split \
            else first["grads"][k]
        w = grads[k].numpy()
        scale = np.abs(w).max()
        if _vanishing(k):
            scale = max(scale, 1e-2 * gmax)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * scale, k
        full = torch.cat([ranks[(0, m)]["params"][k] for m in range(n_model)]) \
            if split else p
        np.testing.assert_allclose(full.numpy(), after[k].numpy(), rtol=0,
                                   atol=1e-4 * rec["lr"], err_msg=k)
        for other in ranks.values():  # replicas agree
            if not split:
                assert torch.equal(other["params"][k], p), k
    for k, buf in first["buffers"].items():
        if k.endswith(("running_mean", "running_var")):
            ref = after[k].numpy()
            np.testing.assert_allclose(buf.numpy(), ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=k)
            for other in ranks.values():
                assert torch.equal(other["buffers"][k], buf), k
    if n_model > 1:
        for r in ranks.values():
            assert r["params"]["conv5.weight"].shape == (512, 128, 3)
            assert r["moments"]["conv5.weight"] == (512, 128, 3)
            assert r["moments"]["bn5.weight"] == (1024,)
            assert "train mode only" in r["eval"]  # a split model refuses eval


# ---------------------------------------------------------------- the CLI

def test_cli_mesh_data_parallel_matches_one_process(tmp_path):
    from geoa3_tpu_torch.workload import random_victim

    torch.save(random_victim("PointNet", 40, 64, device="cpu")[0].state_dict(),
               tmp_path / "victim.pt")

    def argv(root):
        return ["--attack", "GeoA3", "--attack_label", "Untarget",
                "--data_dir_file", "synthetic:1:64", "--npoint", "64",
                "--binary_max_steps", "1", "--iter_max_steps", "4",
                "--curv_loss_knn", "4", "-b", "4", "--device", "cpu",
                "--checkpoint", str(tmp_path / "victim.pt"),
                "--exps_root", str(tmp_path / root)]

    # rank 1 is given another experiment root: it must write nothing there
    group = _Group("cli", 2, tmp_path / "group", dict(argv=[
        argv(f"ranks{r}") + ["--mesh_data_parallel"] for r in range(2)]))
    single = cli_main(build_parser().parse_args(argv("single")))
    # without torchrun's environment the flag runs a world of one, in process
    alone = cli_main(build_parser().parse_args(argv("world1") + ["--mesh_data_parallel"]))
    assert not torch.distributed.is_initialized()  # the CLI's own group is gone
    outs = group.result()
    assert not (tmp_path / "ranks1").exists()
    assert "Finish!" in outs[0]["stdout"] and "attack success" in outs[0]["stdout"]
    assert "Finish!" not in outs[1]["stdout"]  # rank 1 prints nothing of the run
    mats = sorted(os.listdir(os.path.join(single, "Mat")))
    assert mats
    for root in ("ranks0", "world1"):
        sharded = str(single).replace(str(tmp_path / "single"), str(tmp_path / root))
        assert sorted(os.listdir(os.path.join(sharded, "Mat"))) == mats
        for f in mats:
            a = sio.loadmat(os.path.join(single, "Mat", f))["adversary_point_clouds"]
            b = sio.loadmat(os.path.join(sharded, "Mat", f))["adversary_point_clouds"]
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
        for f in ("attack_result.txt", "batches_done.txt"):
            with open(os.path.join(single, f)) as fa, \
                    open(os.path.join(sharded, f)) as fb:
                assert fa.read() == fb.read(), f
    assert str(alone).startswith(str(tmp_path / "world1"))
    assert outs[0]["saved"].startswith(str(tmp_path / "ranks0"))


def test_cli_refuses_is_debug_with_mesh(tmp_path):
    args = build_parser().parse_args(
        ["--attack", "GeoA3", "--data_dir_file", "synthetic:1:64", "--npoint",
         "64", "--device", "cpu", "--exps_root", str(tmp_path / "x"),
         "--mesh_data_parallel", "--is_debug"])
    with pytest.raises(SystemExit, match="is_debug"):
        cli_main(args)
    assert not (tmp_path / "x").exists()


def test_cuda_without_a_card_raises():
    from geoa3_tpu_torch import parallel

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed(device="cuda")
    assert not torch.distributed.is_initialized()
