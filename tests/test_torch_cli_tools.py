"""The port's defense, smoothness and data-tool CLIs against the JAX package's,
on the CPU.

One victim file, `victim.pt` (a random PointNet of 40 classes at 64 points,
from workload.random_victim), and one for PointNet++ SSG, are loaded by both
packages. A random victim's logits move by ~0.2% from cloud to cloud, so
each victim's last layer is rescaled to make that movement one unit and
the ten attacked classes are favoured, so that predictions differ between
clouds and the distillation keeps some of them. The JAX package loads the
files through
utils.checkpoint.load_victim_variables, the port through load_victim_state.
Both CLIs then run on copies of one synthetic Mat/ directory of 64-point
clouds (so no cloud is resampled, and both see the same points) and their
outputs are compared: the result lines, and each instance's prediction as
the name of its dumped .obj. A prediction whose top two logits lie within
the logits' tolerance could differ between the packages; such instances are
counted (none at these seeds) and would be set aside. The random drop draws
other numbers in each package, so only its drop count is compared. The
numpy-only copies (augmentations, the training-set readers, the virtual-scan
distillation, the mesh sampler and reconstruction, the resampling and export
CLIs) are held bit-equal to the JAX package's numpy paths.
"""

import os
import re
import shutil

import numpy as np
import pytest
import scipy.io as sio
import torch

import geoa3_tpu.native
from geoa3_tpu.attack import resample_reconstruct_from_pc as jreconstruct
from geoa3_tpu.cli import defense as jdefense_cli
from geoa3_tpu.cli import gen_data_mat as jgen_cli
from geoa3_tpu.cli import resample_mat as jresample_cli
from geoa3_tpu.cli import save_ori_obj as jsave_cli
from geoa3_tpu.cli import smoothness as jsmooth_cli
from geoa3_tpu.data.gen_data_mat import sample_points_from_mesh as jsample_mesh
from geoa3_tpu_torch import defense
from geoa3_tpu_torch.attack import alpha_shape_mesh, resample_reconstruct_from_pc
from geoa3_tpu_torch.cli import defense as defense_cli
from geoa3_tpu_torch.cli import gen_data_mat as gen_cli
from geoa3_tpu_torch.cli import resample_mat as resample_cli
from geoa3_tpu_torch.cli import save_ori_obj as save_cli
from geoa3_tpu_torch.cli import smoothness as smooth_cli
from geoa3_tpu_torch.data import io as gio
from geoa3_tpu_torch.data.gen_data_mat import sample_points_from_mesh
from geoa3_tpu_torch.data.io import read_ply_ascii
from geoa3_tpu_torch.data.modelnet import TEN_LABEL_NAMES
from geoa3_tpu_torch.data.synthetic import (
    TEN_LABEL_INDEXES,
    make_synthetic_attack_set,
    sample_shape,
)
from geoa3_tpu_torch.measurement import point_smoothness
from geoa3_tpu_torch.workload import random_victim

torch.set_num_threads(1)
NPOINT, CLOUDS = 64, 12
LOGIT_TOL = 1e-4  # relative to the largest logit, tests/test_torch_models.py's


def _candidates():
    """gen_data_mat's synthetic candidates at seed 0 (two per instance kept)."""
    rng = np.random.RandomState(0)
    return np.stack([sample_shape(c, NPOINT, rng)[0]
                     for c in range(10) for _ in range(4)])


def _victim(arch, clouds):
    """A random victim whose logits l become (l - mean) / std over `clouds`,
    plus 2 for the attacked classes: its last layer's weight and bias are
    rescaled (W' = s W, b' = s (b - mean))."""
    model, _ = random_victim(arch, npoint=NPOINT, seed=3, device="cpu")
    last = model.fc3 if arch == "PointNet" else model.fc_layer[-1]
    with torch.no_grad():
        logits = model(torch.from_numpy(clouds))
        mean, s = logits.mean(0), 1.0 / (logits - logits.mean(0)).std()
        last.weight.mul_(s)
        last.bias.copy_(s * (last.bias - mean))
        last.bias[TEN_LABEL_INDEXES] += 2.0
    return model.requires_grad_(False)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_tools")
    # 64-point synthetic clouds with a few outliers
    rng = np.random.RandomState(5)
    pcs = np.stack([sample_shape(i % 10, NPOINT, rng)[0] for i in range(CLOUDS)])
    pcs[:, :3] += rng.choice([-1.5, 1.5], size=(CLOUDS, 3, 3)).astype(np.float32)
    victims = {}
    for arch, name in (("PointNet", "victim.pt"), ("PointNetPP", "victim_ssg.pt")):
        model = _victim(arch, np.concatenate([pcs, _candidates()]))
        torch.save(model.state_dict(), d / name)
        victims[arch] = (model, str(d / name))
    # the labels make every branch of the rates count: defended back to gt,
    # still the attack's target, and gt == attack label
    with torch.no_grad():
        pred = victims["PointNet"][0](torch.from_numpy(pcs)).argmax(-1).numpy()
    mat = d / "Mat"
    mat.mkdir()
    for i in range(CLOUDS):
        gt, atk = (int(pred[i]), int(pred[i] + 1) % 40) if i % 2 == 0 else (
            int(pred[i] + 2) % 40, int(pred[i]))
        if i % 5 == 0:
            atk = gt
        gio.save_adversarial_mat(str(mat / f"adv_{i}.mat"), pcs[i], gt, atk)
    return dict(dir=d, mat=mat, victims=victims, clouds=pcs)


def _copy_mat(work, tag):
    root = work["dir"] / tag
    shutil.copytree(work["mat"], root / "Mat")
    return root


def _defense_args(parser, root, arch, ckpt, dtype, extra=()):
    return parser.parse_args([
        "--datadir", str(root / "Mat"), "--npoint", str(NPOINT), "--arch", arch,
        "--defense_type", dtype, "--drop_num", "8", "--outlier_knn", "2",
        "--alpha", "1.1", "--checkpoint", ckpt, "--is_record_all", *extra])


def _predictions(root):
    """instance -> (gt, attack, defended prediction) from the .obj names."""
    out = {}
    for f in os.listdir(root / "Defensed"):
        m = re.fullmatch(r"Gt(\d+)_record_(\d+)_attack(\d+)_defensedGT(\d+)\.obj", f)
        out[int(m[2])] = (int(m[1]), int(m[3]), int(m[4]))
    return out


def _near_ties(model, arch, pc, dtype):
    """Instances whose port logits' top two lie within LOGIT_TOL."""
    res = defense.point_removal(torch.from_numpy(pc), dtype, 8, 1.1, 2)
    logits = defense_cli.classify(model, arch, res)
    top2 = logits.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    return set(np.flatnonzero((gap <= LOGIT_TOL * logits.abs().max()).numpy()))


@pytest.mark.parametrize("arch,dtype", [
    ("PointNet", "outliers_fixNum"), ("PointNet", "outliers_variance"),
    ("PointNet", "rand_drop"), ("PointNetPP", "outliers_fixNum"),
    ("PointNetPP", "outliers_variance"), ("PointNetPP", "rand_drop"),
])
def test_defense_cli_matches_jax(work, arch, dtype):
    model, ckpt = work["victims"][arch]
    roots = {}
    for tag, cli, extra in (("jax", jdefense_cli, ()),
                            ("port", defense_cli, ("--device", "cpu"))):
        root = _copy_mat(work, f"{tag}_{arch}_{dtype}")
        rates = cli.main(_defense_args(cli.build_parser(), root, arch, ckpt,
                                       dtype, extra))
        lines = (root / "defense_result.txt").read_text().splitlines()
        roots[tag] = (root, rates, lines)
    (jroot, jrates, jlines), (proot, prates, plines) = roots["jax"], roots["port"]
    assert len(jlines) == len(plines) == 1
    if dtype == "rand_drop":
        # other draws in each package: the drop count alone is common
        tail = lambda s: s.split("%, ")[-1]  # noqa: E731
        assert tail(plines[0]) == tail(jlines[0]) == "8.00n] random drop: drop_num 8"
        assert prates["avg_drop_point"] == jrates["avg_drop_point"] == 8.0
        return
    jpred, ppred = _predictions(jroot), _predictions(proot)
    assert sorted(jpred) == sorted(ppred) == list(range(CLOUDS))
    differ = {i for i in jpred if jpred[i] != ppred[i]}
    ties = _near_ties(model, arch, work["clouds"], dtype)
    assert differ <= ties and not ties, (differ, ties)
    assert plines == jlines and prates == jrates
    # the defended clouds themselves, as the dumps hold them
    for i, (gt, atk, pred) in ppred.items():
        name = f"Gt{gt}_record_{i}_attack{atk}_defensedGT{pred}.obj"
        assert (proot / "Defensed" / name).read_text() == (
            jroot / "Defensed" / name).read_text()


def test_defense_cli_refuses_a_missing_card(work, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ckpt = work["victims"]["PointNet"]
    args = _defense_args(defense_cli.build_parser(), work["dir"], "PointNet",
                         ckpt, "outliers_fixNum")
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        defense_cli.main(args)


def test_smoothness_cli_matches_jax(work):
    # two clouds of another size, which the CLIs batch apart (sorted after
    # the others by file name, before them by size)
    rng = np.random.RandomState(9)
    extra_pcs = np.stack([sample_shape(i, 96, rng)[0] for i in range(2)])
    clouds = list(work["clouds"]) + list(extra_pcs)
    results = {}
    for tag, cli, extra in (("jax", jsmooth_cli, []),
                            ("port", smooth_cli, ["--device", "cpu"])):
        root = _copy_mat(work, f"smooth_{tag}")
        for i, pc in enumerate(extra_pcs):
            gio.save_adversarial_mat(str(root / "Mat" / f"z_{i}.mat"), pc, 0, 1)
        avg = cli.main(cli.build_parser().parse_args(
            ["--datadir", str(root), "--k", "8", "--k2", "8", *extra]))
        results[tag] = (avg, sio.loadmat(root / "metric" / "k8.mat")["smoothness"],
                        (root / "metric" / "result.txt").read_text())
    (javg, jval, jtxt), (pavg, pval, ptxt) = results["jax"], results["port"]
    assert pval.shape == jval.shape == (1, CLOUDS + 2)
    # each cloud's value comes from a point with a well-defined normal
    for pc in clouds:
        values, eigval = point_smoothness(torch.from_numpy(pc[None]), 8, 8)
        ev = eigval[0, values[0].argmax()]
        assert ev[1] - ev[0] >= 1e-3 * ev[2]
    np.testing.assert_allclose(pval, jval, rtol=1e-4, atol=0)
    assert ptxt == jtxt and abs(pavg - javg) <= 1e-4 * abs(javg)


def test_gen_data_mat_cli_matches_jax(work):
    model, ckpt = work["victims"]["PointNet"]
    paths = {}
    for tag, cli, extra in (("jax", jgen_cli, []),
                            ("port", gen_cli, ["--device", "cpu"])):
        paths[tag] = cli.main(cli.build_parser().parse_args(
            ["--datadir", "synthetic", "--npoint", str(NPOINT),
             "--max_out_num", "2", "--checkpoint", ckpt,
             "--outdir", str(work["dir"] / f"gen_{tag}"), *extra]))
    assert os.path.basename(paths["jax"]) == os.path.basename(paths["port"])
    # the candidates' predictions: no near tie, so both keep the same set
    with torch.no_grad():
        logits = model(torch.from_numpy(_candidates()))
    top2 = logits.topk(2, dim=-1).values
    assert ((top2[:, 0] - top2[:, 1]) > LOGIT_TOL * logits.abs().max()).all()
    want, got = sio.loadmat(paths["jax"]), sio.loadmat(paths["port"])
    assert got["data"].shape[0] >= 2  # the victim keeps some of two classes
    for key in ("data", "normal", "label"):
        np.testing.assert_array_equal(got[key], want[key])


def test_resample_mat_matches_jax(tmp_path):
    src = str(tmp_path / "dense.mat")
    sio.savemat(src, make_synthetic_attack_set(num_per_class=2, npoint=128, classes=3))
    outs = {}
    for tag, cli in (("jax", jresample_cli), ("port", resample_cli)):
        outs[tag] = str(tmp_path / f"resampled_{tag}.mat")
        cli.main(cli.build_parser().parse_args(
            ["--input", src, "--output", outs[tag], "--npoint", "32"]))
    got, want = sio.loadmat(outs["port"]), sio.loadmat(outs["jax"])
    assert got["data"].shape == got["normal"].shape == (6, 3, 32)
    assert np.linalg.norm(got["data"][0].T, axis=1).max() <= 1.0 + 1e-5
    for key in ("data", "normal", "label"):
        np.testing.assert_array_equal(got[key], want[key])


def test_save_ori_obj_from_mat(tmp_path):
    d = make_synthetic_attack_set(num_per_class=1, npoint=16, classes=2)
    src = str(tmp_path / "set.mat")
    sio.savemat(src, d)
    out = save_cli.main(save_cli.build_parser().parse_args(
        ["--is_save_from_mat", "--mat_path", src, "--outdir", str(tmp_path / "p")]))
    jout = jsave_cli.main(jsave_cli.build_parser().parse_args(
        ["--is_save_from_mat", "--mat_path", src, "--outdir", str(tmp_path / "j")]))
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == ["0.xyz", "1.xyz"]
    np.testing.assert_allclose(gio.read_xyz(os.path.join(out, "0.xyz")),
                               d["data"][0].T, atol=1e-5)
    for f in ("0.xyz", "1.xyz"):
        assert open(os.path.join(out, f)).read() == open(os.path.join(jout, f)).read()


def test_save_ori_obj_mesh_mode(tmp_path):
    mesh_root = tmp_path / "meshes" / TEN_LABEL_NAMES[0]
    mesh_root.mkdir(parents=True)
    verts = [[0.0, 0.0, 0.0], [2.0, 0.0, 0.0], [0.0, 2.0, 0.0]]
    gio.write_obj(str(mesh_root / "a.obj"), verts, [[0, 1, 2]])
    out = save_cli.main(save_cli.build_parser().parse_args(
        ["--mesh_dir", str(tmp_path / "meshes"), "--outdir", str(tmp_path / "p")]))
    jout = jsave_cli.main(jsave_cli.build_parser().parse_args(
        ["--mesh_dir", str(tmp_path / "meshes"), "--outdir", str(tmp_path / "j")]))
    files = os.listdir(out)
    assert len(files) == 1 and files[0].endswith("_17.obj")  # airplane's id
    assert os.listdir(jout) == files
    v, _ = gio.read_obj(os.path.join(out, files[0]))
    assert np.linalg.norm(np.asarray(v), axis=1).max() <= 1.0 + 1e-5
    assert open(os.path.join(out, files[0])).read() == open(
        os.path.join(jout, files[0])).read()


def _sphere(n=400, seed=0):
    v = np.random.RandomState(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_sample_points_from_mesh_matches_jax_numpy_path(monkeypatch):
    monkeypatch.setattr(geoa3_tpu.native, "available", lambda: False)
    verts, faces = alpha_shape_mesh(_sphere())
    want = jsample_mesh(verts, faces, 300, rng=np.random.RandomState(4))
    got = sample_points_from_mesh(verts, faces, 300, rng=np.random.RandomState(4))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_resample_reconstruct_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setattr(geoa3_tpu.native, "available", lambda: False)
    pc = _sphere()
    pts, nrm = resample_reconstruct_from_pc(
        str(tmp_path / "p"), "sphere", pc, normal=pc, npoint=256,
        rng=np.random.RandomState(1))
    assert pts.shape == (256, 3) and nrm.shape == (256, 3)
    r = np.linalg.norm(pts, axis=1)
    assert abs(float(r.mean()) - 1.0) < 0.05
    assert float(np.abs(r - 1).max()) < 0.25
    verts, _ = read_ply_ascii(str(tmp_path / "p" / "sphere.ply"))
    assert verts.shape == (len(pc), 3)
    # the JAX package's numpy path gives the same mesh file and samples
    jpts, jnrm = jreconstruct(str(tmp_path / "j"), "sphere", pc, normal=pc,
                              npoint=256, rng=np.random.RandomState(1))
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(nrm, jnrm)
    assert (tmp_path / "p" / "sphere.ply").read_text() == (
        tmp_path / "j" / "sphere.ply").read_text()


# ------------------------------------------------- the numpy data copies ----

_AUGMENTS = {
    "normalize_data": lambda m, x, x6, r: m.normalize_data(x),
    "shuffle_data": lambda m, x, x6, r: m.shuffle_data(x, np.arange(len(x)), r),
    "shuffle_points": lambda m, x, x6, r: m.shuffle_points(x, r),
    "rotate_point_cloud": lambda m, x, x6, r: m.rotate_point_cloud(x, r),
    "rotate_point_cloud_z": lambda m, x, x6, r: m.rotate_point_cloud_z(x, r),
    "rotate_point_cloud_with_normal":
        lambda m, x, x6, r: m.rotate_point_cloud_with_normal(x6, r),
    "rotate_perturbation_point_cloud":
        lambda m, x, x6, r: m.rotate_perturbation_point_cloud(x, rng=r),
    "rotate_perturbation_point_cloud_with_normal":
        lambda m, x, x6, r: m.rotate_perturbation_point_cloud_with_normal(x6, rng=r),
    "rotate_point_cloud_by_angle": lambda m, x, x6, r: m.rotate_point_cloud_by_angle(x, 0.7),
    "rotate_point_cloud_by_angle_with_normal":
        lambda m, x, x6, r: m.rotate_point_cloud_by_angle_with_normal(x6, 0.7),
    "jitter_point_cloud": lambda m, x, x6, r: m.jitter_point_cloud(x, rng=r),
    "shift_point_cloud": lambda m, x, x6, r: m.shift_point_cloud(x, rng=r),
    "random_scale_point_cloud": lambda m, x, x6, r: m.random_scale_point_cloud(x, rng=r),
    "random_point_dropout": lambda m, x, x6, r: m.random_point_dropout(x, rng=r),
}


@pytest.mark.parametrize("name", sorted(_AUGMENTS))
def test_augment_matches_jax(name):
    import geoa3_tpu.data.augment as jaug
    from geoa3_tpu_torch.data import augment

    x6 = np.random.RandomState(0).randn(3, 32, 6).astype(np.float32)
    got = _AUGMENTS[name](augment, x6[..., :3].copy(), x6.copy(), np.random.RandomState(3))
    want = _AUGMENTS[name](jaug, x6[..., :3].copy(), x6.copy(), np.random.RandomState(3))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def _modelnet_dir(root):
    """A two-class ModelNet40_normal_resampled layout of comma-separated
    x,y,z,nx,ny,nz rows."""
    rng = np.random.RandomState(1)
    names = ["airplane", "bed"]
    (root / "modelnet40_shape_names.txt").write_text("\n".join(names) + "\n")
    ids = []
    for c in names:
        (root / c).mkdir()
        for k in range(3):
            ids.append(f"{c}_{k:04d}")
            np.savetxt(root / c / f"{ids[-1]}.txt", rng.randn(40, 6), delimiter=",",
                       fmt="%.6f")
    for split in ("train", "test"):
        (root / f"modelnet40_{split}.txt").write_text("\n".join(ids) + "\n")
    return str(root)


@pytest.mark.parametrize("split,normal", [("train", False), ("test", True)])
def test_modelnet_train_dataset_matches_jax(tmp_path, monkeypatch, split, normal):
    from geoa3_tpu.data.modelnet_train import ModelNetTrainDataset as JDataset
    from geoa3_tpu_torch.data.modelnet_train import ModelNetTrainDataset

    monkeypatch.setattr(geoa3_tpu.native, "available", lambda: False)
    root = _modelnet_dir(tmp_path)
    kw = dict(root=root, batch_size=4, npoints=32, split=split, normal_channel=normal)
    got, want = ModelNetTrainDataset(**kw), JDataset(**kw)
    assert len(got) == len(want) == 6
    while want.has_next_batch():
        assert got.has_next_batch()
        for g, w in zip(got.next_batch(), want.next_batch()):
            np.testing.assert_array_equal(g, w)
    assert not got.has_next_batch()


def test_synthetic_train_dataset_matches_jax():
    from geoa3_tpu.data.modelnet_train import SyntheticTrainDataset as JSynth
    from geoa3_tpu_torch.data.modelnet_train import SyntheticTrainDataset

    kw = dict(num_per_class=2, classes=3, batch_size=4, npoints=32,
              normal_channel=True, modelnet_labels=True)
    got, want = SyntheticTrainDataset(**kw), JSynth(**kw)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.labels, want.labels)
    for g, w in zip(got.next_batch(do_augment=False), want.next_batch(do_augment=False)):
        np.testing.assert_array_equal(g, w)


def test_distill_virscan_set_matches_jax(tmp_path):
    from geoa3_tpu.data.gen_data_mat import distill_virscan_set as jdistill
    from geoa3_tpu_torch.data.gen_data_mat import distill_virscan_set

    rng = np.random.RandomState(2)
    for i, lab in enumerate([TEN_LABEL_INDEXES[0]] * 3 + [TEN_LABEL_INDEXES[1]] * 2 + [5]):
        pts, nrm = rng.randn(80, 3), rng.randn(80, 3)
        rows = "\n".join(" ".join(f"{v:.6f}" for v in np.r_[p, q]) for p, q in zip(pts, nrm))
        (tmp_path / f"scan{i}_{lab}.ply").write_text(
            "ply\nformat ascii 1.0\nelement vertex 80\nproperty float x\n"
            "property float y\nproperty float z\nproperty float nx\n"
            "property float ny\nproperty float nz\nend_header\n" + rows + "\n")

    def logits_fn(pc):  # predicts the first attacked class for every scan
        out = np.zeros((len(pc), 40), np.float32)
        out[:, TEN_LABEL_INDEXES[0]] = 1.0
        return out

    kw = dict(npoint=32, dense_npoints=48, max_out_num=2, seed=0, log=lambda s: None)
    got, gdense = distill_virscan_set(str(tmp_path), logits_fn, **kw)
    want, wdense = jdistill(str(tmp_path), logits_fn, **kw)
    assert got["data"].shape == (2, 3, 32) and gdense["data"].shape == (2, 3, 48)
    for g, w in ((got, want), (gdense, wdense)):
        for key in ("data", "normal", "label"):
            np.testing.assert_array_equal(g[key], w[key])
