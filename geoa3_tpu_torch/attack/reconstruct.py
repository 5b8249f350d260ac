"""Surface reconstruction + uniform resampling from a point cloud.

Capability equivalent of the reference's open3d helper
`resample_reconstruct_from_pc` (reference Attacker/geoA3_attack.py:28-57):
build a triangle mesh from an (adversarial) point cloud, persist it, and
uniformly resample `npoint` points from the surface. The reference offers
ball-pivoting ('BPA') and Poisson ('PRS') via open3d (dead code in its main
paths — kept here for full library parity, exercised by tests).

The port's own copy of geoa3_tpu/attack/reconstruct.py. Reconstruction is a
host-side data-prep utility (open3d runs on the CPU in the reference too);
here it is a scipy Delaunay alpha-complex, with no native dependency, and
the resampling reuses the attack-set distillation's area-weighted triangle
sampler (`data.gen_data_mat.sample_points_from_mesh`, numpy). The radius
scale mirrors the reference's BPA heuristic (radius = 3 x mean 1-NN
distance, geoA3_attack.py:39-41).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def alpha_shape_mesh(
    pc: np.ndarray,
    alpha: Optional[float] = None,
    normal: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Alpha-complex surface mesh of a point cloud.

    pc [n, 3] -> (vertices [n, 3], faces [f, 3] int32). Keeps Delaunay
    tetrahedra whose longest edge is <= alpha (the max-edge variant: the
    classic circumradius criterion degenerates on SURFACE samplings — any
    sliver of four nearby points on a sphere has circumradius ~R, so no
    tetrahedron survives alpha < R); the surface is the set of triangles
    owned by exactly ONE kept tetrahedron.

    The kept complex is a thin shell, so its boundary has an outer and an
    inner side. When per-point `normal`s are given (every attack-set cloud
    carries them) the inner-side faces are dropped and the rest oriented
    along the normals; otherwise faces are oriented away from the shape
    centroid and both sides are kept (still a uniform resampling surface).

    alpha defaults to 3 x mean nearest-neighbour distance — the same
    neighbourhood scale the reference feeds ball-pivoting
    (geoA3_attack.py:39-41).
    """
    from scipy.spatial import Delaunay, cKDTree

    pc = np.asarray(pc, np.float64)
    assert pc.ndim == 2 and pc.shape[1] == 3
    if alpha is None:
        d, _ = cKDTree(pc).query(pc, k=2)
        alpha = 3.0 * float(d[:, 1].mean())

    tets = Delaunay(pc).simplices
    edges = tets[:, [0, 0, 0, 1, 1, 2]], tets[:, [1, 2, 3, 2, 3, 3]]
    elen = np.linalg.norm(pc[edges[0]] - pc[edges[1]], axis=-1)
    keep = tets[elen.max(axis=1) <= alpha]

    # boundary faces: sorted triple owned by exactly ONE kept tet; remember
    # the owning tet's opposite vertex — it orients the face geometrically
    # (a sorted triple's winding is arbitrary)
    face_opp: dict = {}
    for t in keep:
        for omit in range(4):
            f = tuple(sorted(np.delete(t, omit)))
            face_opp[f] = None if f in face_opp else int(t[omit])
    boundary = [(f, o) for f, o in face_opp.items() if o is not None]
    if not boundary:
        return pc.astype(np.float32), np.zeros((0, 3), np.int32)
    tri = np.asarray([f for f, _ in boundary], np.int32)
    opp = np.asarray([o for _, o in boundary], np.int64)

    # orient every face AWAY from its owning tet (away from the solid):
    # outward on the outer skin, into the cavity on the inner skin
    a, b, c = pc[tri[:, 0]], pc[tri[:, 1]], pc[tri[:, 2]]
    geo_n = np.cross(b - a, c - a)
    toward_opp = np.sum(geo_n * (pc[opp] - a), axis=1) > 0
    tri[toward_opp] = tri[toward_opp][:, [0, 2, 1]]
    geo_n[toward_opp] *= -1.0

    if normal is not None:
        # the kept complex is a thin shell with two skins; the inner skin's
        # away-from-solid normal points INTO the cavity, i.e. against the
        # cloud's outward normals — drop it
        normal = np.asarray(normal, np.float64)
        ref = normal[tri].mean(axis=1)  # mean vertex normal per face
        tri = tri[np.sum(geo_n * ref, axis=1) >= 0]
    else:
        # no reference normals: keep both skins (resampling stays uniform
        # over the surface) but flip everything outward from the centroid
        # so downstream normals are consistent for star-shaped clouds
        centroid = pc.mean(axis=0)
        ctr = (a + b + c) / 3 - centroid
        flip = np.sum(geo_n * ctr, axis=1) < 0
        tri[flip] = tri[flip][:, [0, 2, 1]]
    return pc.astype(np.float32), tri


def save_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Ascii-PLY triangle-mesh writer (reference writes via o3d.io, :53)."""
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        for v in vertices:
            f.write(f"{v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def resample_reconstruct_from_pc(
    output_path: str,
    output_file_name: str,
    pc: np.ndarray,
    normal: Optional[np.ndarray] = None,
    npoint: int = 1024,
    reconstruct_type: str = "alpha",
    alpha: Optional[float] = None,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct a mesh from `pc`, save it as .ply, resample npoint points.

    Mirrors reference geoA3_attack.py:28-57: returns (points [npoint, 3],
    per-sample face normals [npoint, 3]) — the reference returns an o3d
    cloud sampled with sample_points_uniformly; the normals here come from
    the sampled triangle (the caller may ignore them, as upstream does).
    `reconstruct_type` accepts 'alpha' (and the reference names 'BPA'/'PRS'
    as aliases — both map to the alpha complex in this build).
    """
    from geoa3_tpu_torch.data.gen_data_mat import sample_points_from_mesh

    assert reconstruct_type in ("alpha", "BPA", "PRS")
    vertices, faces = alpha_shape_mesh(pc, alpha=alpha, normal=normal)
    if len(faces) == 0:
        raise ValueError(
            "alpha-shape produced an empty surface; increase alpha"
        )
    if output_path:
        os.makedirs(output_path, exist_ok=True)
        save_ply_mesh(
            os.path.join(output_path, output_file_name + ".ply"),
            vertices,
            faces,
        )
    return sample_points_from_mesh(vertices, faces, npoint, rng=rng)
