"""The port's attack CLI against the JAX package's on the CPU.

One victim (PointNet, 40 classes, 64 points, random weights and BatchNorm
statistics) is initialised in the JAX package and saved twice: as the JAX
CLI's msgpack checkpoint, and, through models.convert.from_flax_variables,
as a torch.save'd state_dict for the port. Both CLIs then attack the same
synthetic .mat with the same arguments (the invocations of
tests/test_cli_e2e.py, cut to a few steps). Compared: the experiment
directory's name, the file names, the .mat keys and shapes. The synthetic
labels are not what a random victim predicts, so most instances count as
fooled at the first step and the saving path runs.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from geoa3_tpu.models.pointnet import PointNet as JPointNet
from geoa3_tpu.utils.checkpoint import save_checkpoint
from geoa3_tpu_torch.cli.main_attack import (
    _attack_config,
    _refuse_unported,
    build_parser,
    main,
)
from geoa3_tpu_torch.data import make_synthetic_attack_set
from geoa3_tpu_torch.models.convert import from_flax_variables
from geoa3_tpu_torch.utils.checkpoint import load_victim_state
from tests.test_torch_models import _randomise_bn

torch.set_num_threads(1)
NPOINT = 64


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    jmodel = JPointNet(classes=40, npoint=NPOINT)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, NPOINT, 3)), train=False
    )
    rng = np.random.RandomState(1)
    variables = {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng),
    }
    jdir = d / "victim_jax"
    save_checkpoint(str(jdir), variables, is_best=True)
    tfile = d / "victim.pt"
    torch.save(from_flax_variables(variables), tfile)
    mat = d / "set.mat"
    sio.savemat(mat, make_synthetic_attack_set(num_per_class=1, npoint=NPOINT))
    dense = d / "dense.mat"
    sio.savemat(dense, make_synthetic_attack_set(num_per_class=1, npoint=2 * NPOINT))
    return dict(dir=d, jax_ckpt=str(jdir), ckpt=str(tfile), mat=str(mat),
                dense=str(dense))


def _args(work, exps, *extra, data=None, attack=True):
    base = [
        "--attack_label", "Untarget",
        "--data_dir_file", data or work["mat"],
        "--npoint", str(NPOINT),
        "--binary_max_steps", "1",
        "--iter_max_steps", "6",
        "--curv_loss_knn", "4",
        "-b", "4",
        "--exps_root", str(work["dir"] / exps),
    ]
    if attack:
        base += ["--attack", "GeoA3"]
    return base + list(extra)


def _run(work, exps, *extra, **kw):
    argv = _args(work, exps, *extra, **kw) + ["--checkpoint", work["ckpt"],
                                              "--device", "cpu"]
    return main(build_parser().parse_args(argv))


def _tree(saved_dir):
    return {sub: sorted(os.listdir(os.path.join(saved_dir, sub)))
            for sub in ("Mat", "PC", "Obj", "Records")}


def _rate(saved_dir):
    with open(os.path.join(saved_dir, "attack_result.txt")) as f:
        return float(f.read().strip().splitlines()[-1].split(":")[1])


def test_same_layout_as_the_jax_cli(work):
    from geoa3_tpu.cli.main_attack import build_parser as jparser, main as jmain

    jdir = jmain(jparser().parse_args(
        _args(work, "jax") + ["--checkpoint", work["jax_ckpt"]]))
    tdir = _run(work, "torch")
    # the same experiment directory name under each root
    assert os.path.relpath(jdir, work["dir"] / "jax") == os.path.relpath(
        tdir, work["dir"] / "torch")
    jt, tt = _tree(jdir), _tree(tdir)
    assert len(tt["Mat"]) == len(tt["PC"]) > 0
    # same victim, same clouds: the same instances succeed with the same
    # predicted class, so the file names agree
    assert tt == jt
    for name in ("attack_result.txt", "attack_metrics.json", "batches_done.txt"):
        assert os.path.isfile(os.path.join(jdir, name)), name
        assert os.path.isfile(os.path.join(tdir, name)), name
    jm = sio.loadmat(os.path.join(jdir, "Mat", jt["Mat"][0]))
    tm = sio.loadmat(os.path.join(tdir, "Mat", tt["Mat"][0]))
    keys = lambda m: sorted(k for k in m if not k.startswith("__"))  # noqa: E731
    assert keys(tm) == keys(jm) == ["adversary_point_clouds", "attack_label", "gt_label"]
    for k in keys(tm):
        assert tm[k].shape == jm[k].shape and tm[k].dtype == jm[k].dtype, k
    assert tm["adversary_point_clouds"].shape == (3, NPOINT)
    assert _rate(tdir) == _rate(jdir)
    with open(os.path.join(jdir, "attack_metrics.json")) as f:
        jmet = json.load(f)
    with open(os.path.join(tdir, "attack_metrics.json")) as f:
        tmet = json.load(f)
    assert sorted(tmet) == sorted(jmet)
    assert tmet["num_successful"] == jmet["num_successful"]
    with open(os.path.join(tdir, "PC", tt["PC"][0])) as f:
        line = f.readline().split()
    assert line[0] == "v" and len(line) == 7


def test_eval_mode_no_attack(work, capsys):
    saved = _run(work, "eval", attack=False)
    assert os.path.basename(saved) == "Evaluating_0"
    assert "Prec@1" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(saved, "attack_result.txt"))


def test_resume_start_batch_and_stale_clearing(work):
    extra = ("--id", "0", "--iter_max_steps", "4")
    saved = _run(work, "resume", *extra)
    with open(os.path.join(saved, "batches_done.txt")) as f:
        done = int(f.read())
    assert done == 3  # 10 instances in batches of 4
    full_rate, n_mats = _rate(saved), len(os.listdir(os.path.join(saved, "Mat")))
    _run(work, "resume", *extra, "--start_batch", str(done - 1))
    # unique (instance, target) pairs of the whole run, recounted from Mat/
    assert _rate(saved) >= full_rate - 1e-6
    assert len(os.listdir(os.path.join(saved, "Mat"))) >= n_mats
    # a fresh run into the same directory clears stale per-instance files
    stale = [os.path.join(saved, "Mat", "adv_999_gt0_attack1_expect0.mat"),
             os.path.join(saved, "PC", "adv_999_gt0_attack1_expect0.obj")]
    for s in stale:
        open(s, "wb").close()
    _run(work, "resume", *extra)
    assert not any(os.path.exists(s) for s in stale)
    assert len(os.listdir(os.path.join(saved, "Mat"))) == n_mats


def test_margin_retry(work):
    # targeted attacks at a tiny budget leave failures for the retry pass
    saved = _run(work, "margin", "--attack_label", "All", "-b", "2",
                 "--iter_max_steps", "3", "--margin_retry",
                 data="synthetic:1:64")
    with open(os.path.join(saved, "attack_result.txt")) as f:
        txt = f.read()
    assert "attack success:" in txt
    if float(txt.splitlines()[0].split(":")[1]) < 100.0:
        assert "margin retry closed:" in txt
        assert os.listdir(os.path.join(saved, "MarginRetry"))
        assert os.path.isfile(os.path.join(saved, "margin_done.txt"))


def test_is_debug_dumps(work):
    saved = _run(work, "debug", "--is_debug", "--binary_max_steps", "2")
    dumps = sorted(f for f in os.listdir(os.path.join(saved, "Obj"))
                   if f.endswith(".xyz"))
    assert any(f.endswith("_bs0.xyz") for f in dumps)
    assert any(f.endswith("_bs1.xyz") for f in dumps)
    rows = np.loadtxt(os.path.join(saved, "Obj", dumps[0]))
    assert rows.shape == (NPOINT, 6)  # xyz + normal per point


def test_save_normal_from_a_dense_twin(work):
    saved = _run(work, "normal", "--is_save_normal",
                 "--dense_data_dir_file", work["dense"])
    mats = os.listdir(os.path.join(saved, "Mat"))
    assert mats
    m = sio.loadmat(os.path.join(saved, "Mat", mats[0]))
    assert m["est_normal"].shape == m["adversary_point_clouds"].shape
    norms = np.linalg.norm(m["est_normal"].T, axis=1)
    assert (norms > 0.5).all() and (norms < 1.5).all()


def test_side_modes_and_recorders_run(work):
    saved = _run(work, "modes", "--is_pre_jitter_input", "--jitter_k", "8",
                 "--is_pro_grad", "--cc_linf", "0.1", "--is_use_lr_scheduler",
                 "--is_record_loss", "--is_record_converged_steps")
    assert saved.endswith(
        "_LRExp_ProGrad_cclinf0.1_PreJitter0.01_0.05_estNormalVery50")
    recs = os.listdir(os.path.join(saved, "Records"))
    assert {"converge_iter.mat", "loss_iter.mat"} <= set(recs)
    loss = sio.loadmat(os.path.join(saved, "Records", "loss_iter.mat"))["loss"]
    assert loss.shape == (6, 10)  # steps x instances, padding rows dropped
    saved = _run(work, "modes", "--is_partial_var", "--optim", "sgd",
                 "--iter_max_steps", "50")
    assert saved.endswith("_PartOpt_k3")


def test_refresh_falls_back_to_the_largest_divisor():
    args = build_parser().parse_args(["--iter_max_steps", "37"])
    assert _attack_config(args).curv_knn_refresh_every == 1
    args = build_parser().parse_args(["--iter_max_steps", "100"])
    assert _attack_config(args).curv_knn_refresh_every == 10
    args = build_parser().parse_args(
        ["--iter_max_steps", "16", "--curv_knn_refresh_every", "6"])
    assert _attack_config(args).curv_knn_refresh_every == 4


LIFTED = {("--is_subsample_opt",), ("--uniform_loss_weight", "1"),
          ("--arch", "PointNetPP"), ("--arch", "PointNetPP_MSG"),
          ("--mesh_data_parallel",), ("--victim_dtype", "bfloat16")}


@pytest.mark.parametrize("flags", [
    ("--is_subsample_opt",), ("--uniform_loss_weight", "1"),
    ("--arch", "PointNetPP"), ("--arch", "PointNetPP_MSG"),
    ("--mesh_data_parallel",), ("--victim_dtype", "bfloat16"),
    ("--victim_dtype", "bfloat16", "--arch", "PointNetPP"),
    ("--victim_dtype", "bfloat16", "--arch", "PointNetPP_MSG"),
])
def test_refused_switches_raise(work, flags):
    """The switches that are still refused raise with their ROADMAP message
    before any output; the ones lifted since (farthest-point sampling, the
    single- and multi-scale PointNet++ victims, data parallel and the bf16
    PointNet victim are ported) pass the gate. bf16 stays refused on both
    PointNet++ victims."""
    args = build_parser().parse_args(_args(work, "refused", *flags))
    if flags in LIFTED:
        _refuse_unported(args)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _run(work, "refused", *flags)
    assert not (work["dir"] / "refused").exists()  # refused before any output


def test_oversized_clouds_are_refused_at_reevaluation(work):
    """Clouds of 2 x npoint points are no longer refused: the attack moves
    the whole cloud, and the re-evaluation (and nothing else) sees a
    random-start FPS resampling to --npoint."""
    saved = _run(work, "dense", "--npoint", str(NPOINT), data=work["dense"])
    mats = os.listdir(os.path.join(saved, "Mat"))
    assert mats and _rate(saved) == 10.0 * len(mats)
    m = sio.loadmat(os.path.join(saved, "Mat", mats[0]))
    assert m["adversary_point_clouds"].shape == (3, 2 * NPOINT)
    with open(os.path.join(saved, "attack_metrics.json")) as f:
        met = json.load(f)
    assert met["num_successful"] == len(mats) and np.isfinite(met["mean_chamfer"])


def test_subsample_mode_with_the_uniform_loss_runs(work):
    """--is_subsample_opt on clouds of 512 points resampled to 256 every step
    (the uniform loss's smallest ball then holds 4 samples, enough for its
    3-NN): the engine's eval_num-fold resampling vote decides, the saved
    clouds keep all their points, and the run is reproducible under --id 0."""
    trees = []
    for _ in range(2):
        saved = _run(work, "subsample", "--is_subsample_opt", "--eval_num", "3",
                     "--uniform_loss_weight", "0.5", "--iter_max_steps", "3",
                     "--id", "0", "--npoint", "256", data="synthetic:1:512")
        trees.append(_tree(saved))
    assert "UniLoss0.5" in saved
    assert trees[0] == trees[1] and trees[0]["Mat"]
    m = sio.loadmat(os.path.join(saved, "Mat", trees[0]["Mat"][0]))
    assert m["adversary_point_clouds"].shape == (3, 512)


def _runs_like_the_jax_cli(tmp_path, arch, jcls):
    """The JAX CLI and the port's on the same weights of a PointNet++ victim
    (`arch`, the JAX class `jcls`): the same experiment directory, the same
    instances succeed, the same .mat contract. The two CLIs draw different
    initial offsets (1e-3 N(0, 1)) and a random-weight victim holds several
    classes within that of each other, so the predicted class in a file name
    may differ; it is left out of the comparison."""
    from geoa3_tpu.cli.main_attack import build_parser as jparser, main as jmain

    n = 128
    jmodel = jcls(classes=40)
    variables = jmodel.init({"params": jax.random.PRNGKey(1)},
                            jnp.zeros((1, n, 3)), train=False)
    rng = np.random.RandomState(2)
    variables = {
        "params": _randomise_bn(jax.tree.map(np.asarray, variables["params"]), rng),
        "batch_stats": _randomise_bn(
            jax.tree.map(np.asarray, variables["batch_stats"]), rng),
    }
    save_checkpoint(str(tmp_path / "jax"), variables, is_best=True)
    torch.save(from_flax_variables(variables), tmp_path / "victim.pt")
    common = ["--arch", arch, "--attack", "GeoA3", "--attack_label",
              "Untarget", "--data_dir_file", "synthetic:1:128", "--npoint",
              str(n), "--binary_max_steps", "1", "--iter_max_steps", "2",
              "--curv_loss_knn", "4", "-b", "10"]
    jdir = jmain(jparser().parse_args(common + [
        "--exps_root", str(tmp_path / "jexps"), "--checkpoint", str(tmp_path / "jax")]))
    tdir = main(build_parser().parse_args(common + [
        "--exps_root", str(tmp_path / "texps"), "--checkpoint",
        str(tmp_path / "victim.pt"), "--device", "cpu"]))
    assert os.path.relpath(jdir, tmp_path / "jexps") == os.path.relpath(
        tdir, tmp_path / "texps")
    assert arch + "_npoint" in os.path.relpath(tdir, tmp_path / "texps")
    strip = lambda names: [re.sub(r"_attack\d+_", "_", f) for f in names]  # noqa: E731
    jt, tt = _tree(jdir), _tree(tdir)
    assert tt["Mat"] and {k: strip(v) for k, v in tt.items()} == {
        k: strip(v) for k, v in jt.items()}
    assert _rate(tdir) == _rate(jdir)
    jm = sio.loadmat(os.path.join(jdir, "Mat", jt["Mat"][0]))
    m = sio.loadmat(os.path.join(tdir, "Mat", tt["Mat"][0]))
    assert m["adversary_point_clouds"].shape == (3, n)
    assert {k: np.shape(v) for k, v in m.items() if not k.startswith("__")} == {
        k: np.shape(v) for k, v in jm.items() if not k.startswith("__")}


def test_pointnetpp_runs_like_the_jax_cli(work, tmp_path):
    """--arch PointNetPP (the single-scale victim) against the JAX CLI."""
    from geoa3_tpu.models.pointnetpp import PointNet2ClassificationSSG as JSSG

    _runs_like_the_jax_cli(tmp_path, "PointNetPP", JSSG)


def test_pointnetpp_msg_runs_like_the_jax_cli(work, tmp_path):
    """--arch PointNetPP_MSG (the multi-scale victim) against the JAX CLI."""
    from geoa3_tpu.models.pointnetpp import PointNet2ClassificationMSG as JMSG

    _runs_like_the_jax_cli(tmp_path, "PointNetPP_MSG", JMSG)


def test_msgpack_checkpoint_is_refused(work):
    for path in (work["jax_ckpt"],
                 os.path.join(work["jax_ckpt"], "model_best.msgpack")):
        with pytest.raises(ValueError, match="from_flax_variables"):
            load_victim_state(path)
    with pytest.raises(FileNotFoundError):
        load_victim_state(str(work["dir"] / "nothing_here"))


def test_reference_checkpoint_layouts_load(work, tmp_path):
    sd = torch.load(work["ckpt"], weights_only=True)
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "epoch": 3}, tmp_path / "model_best.pth.tar")
    got = load_victim_state(str(tmp_path))
    assert sorted(got) == sorted(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    torch.save({"not": "weights"}, tmp_path / "bad.pt")
    with pytest.raises(ValueError, match="state_dict"):
        load_victim_state(str(tmp_path / "bad.pt"))
