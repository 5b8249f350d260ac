"""Point-cloud / mesh file IO (the port's own copy of geoa3_tpu/data/io.py;
reference Lib/utility.py:218-464 and the output-writer contracts of
main_attack.py / defense.py).

Formats:
  * adversarial .mat per instance: {adversary_point_clouds [3, n], gt_label,
    attack_label[, est_normal]} (reference main_attack.py:270-274);
  * .obj point dumps: "v x y z 0 0 0" lines (reference main_attack.py:276-279);
  * .xyz dumps with normals (reference geoA3_attack.py:334-339);
  * OBJ/OFF triangle meshes (reference utility.py:229-452).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.io as sio


# ---------------------------------------------------------------- attack outputs


def adversarial_mat_name(
    instance_idx: int, gt_label: int, attack_label: int, expect_label: int
) -> str:
    """Per-instance output stem (reference main_attack.py:267)."""
    return (
        f"adv_{instance_idx}_gt{gt_label}_attack{attack_label}"
        f"_expect{expect_label}"
    )


def save_adversarial_mat(
    path: str,
    pc: np.ndarray,
    gt_label: int,
    attack_label: int,
    est_normal: Optional[np.ndarray] = None,
) -> None:
    """Save one adversarial instance. pc channel-last [n, 3] -> stored [3, n].

    Bit-compatible .mat structure with reference main_attack.py:270-274.
    """
    payload = {
        "adversary_point_clouds": np.asarray(pc, np.float32).T,
        "gt_label": gt_label,
        "attack_label": attack_label,
    }
    if est_normal is not None:
        payload["est_normal"] = np.asarray(est_normal, np.float32).T
    sio.savemat(path, payload)


def save_point_obj(path: str, pc: np.ndarray) -> None:
    """'v x y z 0 0 0' dump (reference main_attack.py:276-279). pc [n, 3]."""
    with open(path, "w") as f:
        for p in np.asarray(pc):
            f.write("v %f %f %f 0 0 0\n" % (p[0], p[1], p[2]))


def save_xyz(path: str, pc: np.ndarray, normal: Optional[np.ndarray] = None) -> None:
    """'x y z nx ny nz' dump (reference geoA3_attack.py:334-339). pc [n, 3]."""
    pc = np.asarray(pc)
    normal = np.zeros_like(pc) if normal is None else np.asarray(normal)
    with open(path, "w") as f:
        for p, m in zip(pc, normal):
            f.write("%f %f %f %f %f %f\n" % (p[0], p[1], p[2], m[0], m[1], m[2]))


def read_xyz(path: str, num_points: int = -1) -> np.ndarray:
    """Read xyz coordinates (reference utility.py:218-227). -> [n, 3]."""
    with open(path) as f:
        lines = f.readlines()
    if num_points != -1:
        lines = lines[:num_points]
    return np.asarray(
        [[float(x) for x in ln.split()[0:3]] for ln in lines if ln.strip()],
        np.float32,
    )


# ---------------------------------------------------------------- OBJ meshes


def write_obj(
    path: str, vertices: Sequence[Sequence[float]], faces: Sequence[Sequence[int]]
) -> None:
    """Triangle-mesh OBJ writer (reference utility.py:229-265, 1-based faces)."""
    assert len(vertices) > 0 and len(faces) > 0
    with open(path, "w") as f:
        for v in vertices:
            assert len(v) == 3
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            assert len(face) == 3, "only triangular faces supported"
            for i in face:
                assert 0 <= i < len(vertices)
            f.write("f " + " ".join(str(i + 1) for i in face) + "\n")
        f.write("\n")


def read_obj(path: str) -> Tuple[List[List[float]], List[List[int]]]:
    """Triangle-mesh OBJ reader (reference utility.py:267-333).

    Skips degenerate faces with an info message, like the reference (:322-326).
    """
    assert os.path.exists(path), f"file {path} not found"
    vertices: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path) as f:
        for line in f:
            parts = [p for p in line.strip().split(" ") if p]
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f":
                ids = [int(p.split("/")[0]) for p in parts[1:4]]
                v1, v2, v3 = ids
                if v1 == v2 or v2 == v3 or v1 == v3:
                    print(f"[Info] skipping degenerate face in {path}")
                else:
                    faces.append([v1 - 1, v2 - 1, v3 - 1])
    return vertices, faces


# ---------------------------------------------------------------- OFF meshes


def write_off(
    path: str, vertices: Sequence[Sequence[float]], faces: Sequence[Sequence[int]]
) -> None:
    """OFF writer; faces stored as '3 a b c' rows (reference utility.py:335-373)."""
    assert len(vertices) > 0 and len(faces) > 0
    with open(path, "w") as f:
        f.write("OFF\n")
        f.write(f"{len(vertices)} {len(faces)} 0\n")
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            assert len(face) == 3
            f.write("3 " + " ".join(str(i) for i in face) + "\n")
        f.write("\n")


def read_off(path: str) -> Tuple[List[List[float]], List[List[int]]]:
    """OFF reader incl. the ModelNet 'OFF123 456 0' header bug fix
    (reference utility.py:375-452). Returns faces WITH the leading count,
    matching the reference's return convention."""
    assert os.path.exists(path), f"file {path} not found"
    with open(path) as f:
        lines = [ln.strip() for ln in f.readlines()]
    if len(lines[0]) > 3 and lines[0][:4] != "COFF":
        assert lines[0][:3].upper() == "OFF", f"invalid OFF file {path}"
        parts = lines[0][3:].split(" ")
        num_vertices, num_faces = int(parts[0]), int(parts[1])
        start = 1
    else:
        assert lines[0].upper() == "OFF" or lines[0][:4] == "COFF"
        parts = lines[1].split(" ")
        num_vertices, num_faces = int(parts[0]), int(parts[1])
        start = 2
    vertices = []
    for i in range(num_vertices):
        vals = [float(x) for x in lines[start + i].split() if x]
        vertices.append(vals[0:3])
    faces = []
    for i in range(num_faces):
        face = [int(x) for x in lines[start + num_vertices + i].split() if x]
        assert face[0] == len(face) - 1 and face[0] == 3, (
            "only triangular meshes supported"
        )
        faces.append(face)
    return vertices, faces


# ---------------------------------------------------------------- PLY


def read_ply_ascii(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Minimal ascii-PLY vertex reader -> (points [n, 3], normals [n, 3]|None).

    Covers the virtual-scan inputs the reference parses with its
    `read_off_lines` helper (reference Provider/gen_data_mat.py:69-86, which
    is actually a PLY-header skipper). Only ascii PLY with x/y/z (+ optional
    nx/ny/nz) vertex properties is supported.
    """
    with open(path) as f:
        line = f.readline().strip()
        assert line == "ply", f"not a PLY file: {path}"
        n_verts = 0
        props: List[str] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"unterminated PLY header: {path}")
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "format":
                assert parts[1] == "ascii", "only ascii PLY supported"
            elif parts[0] == "element":
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n_verts = int(parts[2])
            elif parts[0] == "property" and in_vertex:
                props.append(parts[-1])
            elif parts[0] == "end_header":
                break
        xi = [props.index(c) for c in ("x", "y", "z")]
        has_n = all(c in props for c in ("nx", "ny", "nz"))
        ni = [props.index(c) for c in ("nx", "ny", "nz")] if has_n else None
        pts = np.empty((n_verts, 3), np.float32)
        nrm = np.empty((n_verts, 3), np.float32) if has_n else None
        for i in range(n_verts):
            vals = f.readline().split()
            pts[i] = [float(vals[j]) for j in xi]
            if has_n:
                nrm[i] = [float(vals[j]) for j in ni]
        return pts, nrm


# ---------------------------------------------------------------- normalisation


def pc_normalize(point: np.ndarray) -> np.ndarray:
    """Centre + max-norm scale a single [n, 3] cloud.

    Reference Lib/utility.py:454-464 / Provider/modelnet_trn_test.py:13-19.
    """
    point = np.asarray(point, np.float32)
    avg = point.mean(axis=0)
    out = point - avg[None, :]
    scale = np.linalg.norm(out, axis=1).max()
    return out / scale
