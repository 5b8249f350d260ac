"""Attack-set distillation (the port's own copy of geoa3_tpu/data/gen_data_mat.py,
with the numpy mesh sampler only; library part of reference
Provider/gen_data_mat.py).

Builds the `modelnet10_250instances{npoint}_{arch}.mat` attack set: filter a
test split to the 10 attacked classes, keep only instances the victim
classifies correctly, cap `max_out_num` per class, store {data [N, 3, n],
normal, label}. Also provides the mesh-side helpers (area-weighted triangle
sampling, FPS + normalisation) used by the virtual-scan path.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES


def sample_points_from_mesh(
    vertices: np.ndarray,
    faces: np.ndarray,
    num_points: int,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Area-weighted uniform sampling on a triangle mesh.

    Reference Provider/gen_data_mat.py:88-119 (`sample_points`): triangles are
    picked proportionally to area, barycentric coordinates uniform. Returns
    (points [num_points, 3], face normals per sample [num_points, 3]).
    """
    rng = rng or np.random.RandomState(0)
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    cross = np.cross(b - a, c - a)
    area = 0.5 * np.linalg.norm(cross, axis=1)
    prob = area / area.sum()
    fidx = rng.choice(len(f), size=num_points, p=prob)
    u = rng.uniform(size=(num_points, 2))
    flip = u.sum(-1) > 1
    u[flip] = 1 - u[flip]
    pts = (
        a[fidx]
        + u[:, :1] * (b[fidx] - a[fidx])
        + u[:, 1:] * (c[fidx] - a[fidx])
    )
    nrm = cross[fidx]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return pts.astype(np.float32), nrm.astype(np.float32)


def farthest_points_normalized(
    obj_points: np.ndarray,
    num_points: int,
    rng: Optional[np.random.RandomState] = None,
    extras: Sequence[np.ndarray] = (),
) -> Tuple[np.ndarray, ...]:
    """Random-start FPS + unit-sphere normalisation (reference :121-159).

    `extras` (e.g. normals) are subsampled with the same indices.
    """
    rng = rng or np.random.RandomState(0)
    first = rng.randint(len(obj_points))
    selected = [first]
    dists = np.full(len(obj_points), np.inf)
    for _ in range(num_points - 1):
        dists = np.minimum(
            dists,
            np.linalg.norm(obj_points - obj_points[selected[-1]][None, :], axis=1),
        )
        selected.append(int(np.argmax(dists)))
    res = np.asarray(obj_points[selected])
    avg = res.mean(axis=0)
    res = res - avg[None, :]
    res = res / np.linalg.norm(res, axis=1).max()
    out = [res.astype(np.float32)]
    for e in extras:
        out.append(np.asarray(e)[selected].astype(np.float32))
    return tuple(out)


def distill_virscan_set(
    scan_dir: str,
    logits_fn: Callable[[np.ndarray], np.ndarray],
    npoint: int,
    dense_npoints: int = 0,
    max_out_num: int = 25,
    label_whitelist: Optional[Sequence[int]] = None,
    seed: int = 0,
    log: Callable[[str], None] = print,
) -> Tuple[Dict[str, np.ndarray], Optional[Dict[str, np.ndarray]]]:
    """Virtual-scan attack-set assembly (reference gen_data_mat.py:186-226).

    Reads ascii-PLY scans named `*_<label>.<ext>` from `scan_dir` (skipping
    .obj files), FPS-normalises each to `npoint` (and, when dense_npoints>0,
    a PAIRED dense variant from the same source points with the same
    per-class cap indices), classifies with the victim after the reference's
    [0,2,1] y/z swap, keeps correctly-classified whitelisted instances, and
    caps `max_out_num` per class by random permutation (:289).

    Returns (attack_set, dense_set|None), each {data [N,3,n], normal, label}.
    """
    import os

    from geoa3_tpu_torch.data.io import read_ply_ascii

    whitelist = set(
        TEN_LABEL_INDEXES if label_whitelist is None else label_whitelist
    )
    rng = np.random.RandomState(seed)
    per_class: Dict[int, list] = {c: [] for c in whitelist}

    file_names = sorted(os.listdir(scan_dir))
    for i, file_name in enumerate(file_names):
        if ".obj" in file_name:
            continue
        label = int(file_name.split("_")[1].split(".")[0])
        if label not in whitelist:
            log(f"[{i}/{len(file_names)}] label {label}: pass!")
            continue
        ori_points, ori_normal = read_ply_ascii(
            os.path.join(scan_dir, file_name)
        )
        assert ori_normal is not None, f"scan {file_name} has no normals"
        points, normal = farthest_points_normalized(
            ori_points, npoint, rng=rng, extras=[ori_normal]
        )
        entry = {"pc": points, "normal": normal}
        if dense_npoints > 0:
            dense_points, dense_normal = farthest_points_normalized(
                ori_points, dense_npoints, rng=rng, extras=[ori_normal]
            )
            entry["dense_pc"] = dense_points
            entry["dense_normal"] = dense_normal
        # reference classifies pc[:, [0,2,1], :] and stores the swapped pc
        pred = int(np.argmax(logits_fn(points[None, :, [0, 2, 1]]), -1)[0])
        if pred == label:
            log(f"[{i}/{len(file_names)}] label {label}: pred successed!")
            per_class[label].append(entry)
        else:
            log(f"[{i}/{len(file_names)}] label {label}: pred failed!")

    data, normals, labels = [], [], []
    dense_data, dense_normals = [], []
    for c in sorted(whitelist, key=TEN_LABEL_INDEXES.index):
        items = per_class[c]
        if not items:
            continue
        # one shared randperm caps BOTH the attack-res and dense arrays so
        # the pairs stay aligned (reference :289-296 reuses `index`)
        pick = rng.permutation(len(items))[:max_out_num]
        for k in pick:
            e = items[k]
            data.append(e["pc"][:, [0, 2, 1]].T)
            normals.append(e["normal"][:, [0, 2, 1]].T)
            labels.append(c)
            if dense_npoints > 0:
                dense_data.append(e["dense_pc"][:, [0, 2, 1]].T)
                dense_normals.append(e["dense_normal"][:, [0, 2, 1]].T)

    label_arr = np.asarray(labels, np.int64).reshape(-1, 1)
    out = {
        "data": np.stack(data).astype(np.float32),
        "normal": np.stack(normals).astype(np.float32),
        "label": label_arr,
    }
    dense_out = None
    if dense_npoints > 0:
        dense_out = {
            "data": np.stack(dense_data).astype(np.float32),
            "normal": np.stack(dense_normals).astype(np.float32),
            "label": label_arr,
        }
    return out, dense_out


def distill_attack_set(
    iter_instances,
    logits_fn: Callable[[np.ndarray], np.ndarray],
    max_out_num: int = 25,
    label_whitelist: Optional[Sequence[int]] = None,
    axis_swap: bool = True,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Filter instances into the attack set (reference gen_data_mat.py:230-306).

    iter_instances yields (pc [n, 3], normal [n, 3], label:int). Keeps
    instances whose label is whitelisted AND that the victim classifies
    correctly; caps max_out_num per class by random permutation (reference
    :276-295). `axis_swap` applies the reference's [0, 2, 1] y/z swap before
    classification and storage (:216-220,247-248).
    """
    whitelist = set(
        TEN_LABEL_INDEXES if label_whitelist is None else label_whitelist
    )
    rng = np.random.RandomState(seed)
    per_class: Dict[int, list] = {c: [] for c in whitelist}

    # collect whitelisted candidates, classify in fixed-size batches (one
    # shape for the victim; per-instance device calls would pay the host
    # round trip 500x)
    cand: list = []
    for pc, normal, label in iter_instances:
        if label not in whitelist:
            continue
        pc = np.asarray(pc, np.float32)
        normal = np.asarray(normal, np.float32)
        if axis_swap:
            pc = pc[:, [0, 2, 1]]
            normal = normal[:, [0, 2, 1]]
        cand.append((pc, normal, label))

    bs = 64
    for start in range(0, len(cand), bs):
        chunk = cand[start : start + bs]
        pcs = np.stack([c[0] for c in chunk])
        if len(chunk) < bs:  # pad to the batch's fixed shape
            pcs = np.concatenate(
                [pcs, np.repeat(pcs[:1], bs - len(chunk), 0)], 0
            )
        preds = np.argmax(logits_fn(pcs), axis=-1)[: len(chunk)]
        for (pc, normal, label), pred in zip(chunk, preds):
            if int(pred) == label:
                per_class[label].append((pc, normal))

    data, normals, labels = [], [], []
    for c in sorted(whitelist, key=TEN_LABEL_INDEXES.index):
        items = per_class[c]
        if len(items) > max_out_num:
            pick = rng.permutation(len(items))[:max_out_num]
            items = [items[i] for i in pick]
        for pc, nrm in items:
            data.append(pc.T)  # stored channel-first (reference .mat layout)
            normals.append(nrm.T)
            labels.append(c)

    return {
        "data": np.stack(data).astype(np.float32),
        "normal": np.stack(normals).astype(np.float32),
        "label": np.asarray(labels, np.int64).reshape(-1, 1),
    }
