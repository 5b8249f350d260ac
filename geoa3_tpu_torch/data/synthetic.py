"""Synthetic point-cloud shape dataset (numpy only; the port's own copy of
geoa3_tpu/data/synthetic.py, so that geoa3_tpu_torch never imports the JAX
package).

The reference repo ships no data (.mat attack sets must be distilled from the
user's ModelNet40 download, reference Provider/gen_data_mat.py). For
self-contained tests, training smoke runs, and the throughput benchmark this
module generates 10 parametric shape classes with analytic normals, normalised
to the unit sphere like the reference attack set
(gen_data_mat.py:121-159 normalisation).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# ModelNet40 ids of the ten attacked classes (geoa3_tpu/data/modelnet.py)
TEN_LABEL_INDEXES = [17, 9, 36, 20, 3, 16, 34, 38, 23, 15]

SYNTHETIC_CLASS_NAMES = [
    "sphere",
    "cube",
    "cylinder",
    "cone",
    "torus",
    "plane",
    "helix",
    "saddle",
    "two_spheres",
    "pyramid",
]


def _unit(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _sphere(rng, n):
    p = _unit(rng.randn(n, 3))
    return p, p.copy()


def _cube(rng, n):
    # sample faces uniformly
    face = rng.randint(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.zeros((n, 3))
    nrm = np.zeros((n, 3))
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    others = np.stack([(a + 1) % 3 for a in axis]), np.stack([(a + 2) % 3 for a in axis])
    for i in range(n):
        pts[i, axis[i]] = sign[i]
        pts[i, others[0][i]] = uv[i, 0]
        pts[i, others[1][i]] = uv[i, 1]
        nrm[i, axis[i]] = sign[i]
    return pts, nrm


def _cylinder(rng, n):
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    pts = np.stack([np.cos(theta), np.sin(theta), z], -1)
    nrm = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], -1)
    return pts, nrm


def _cone(rng, n):
    theta = rng.uniform(0, 2 * np.pi, n)
    h = np.sqrt(rng.uniform(0, 1, n))  # area-uniform along the slant
    r = 1 - h
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), 2 * h - 1], -1)
    # cone slope 2 -> normal direction (2cos, 2sin, 1)/sqrt5
    nrm = _unit(np.stack([2 * np.cos(theta), 2 * np.sin(theta), np.ones(n)], -1))
    return pts, nrm


def _torus(rng, n, R=0.7, r=0.3):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    cx, cy = R * np.cos(u), R * np.sin(u)
    pts = np.stack(
        [
            (R + r * np.cos(v)) * np.cos(u),
            (R + r * np.cos(v)) * np.sin(u),
            r * np.sin(v),
        ],
        -1,
    )
    centers = np.stack([cx, cy, np.zeros(n)], -1)
    nrm = _unit(pts - centers)
    return pts, nrm


def _plane(rng, n):
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.stack([uv[:, 0], uv[:, 1], 0.05 * np.sin(3 * uv[:, 0])], -1)
    dz = 0.15 * np.cos(3 * uv[:, 0])
    nrm = _unit(np.stack([-dz, np.zeros(n), np.ones(n)], -1))
    return pts, nrm


def _helix(rng, n):
    t = rng.uniform(0, 4 * np.pi, n)
    jitter = 0.05 * rng.randn(n, 3)
    pts = np.stack([np.cos(t), np.sin(t), t / (2 * np.pi) - 1], -1) + jitter
    nrm = _unit(np.stack([np.cos(t), np.sin(t), np.zeros(n)], -1))
    return pts, nrm


def _saddle(rng, n):
    uv = rng.uniform(-1, 1, (n, 2))
    x, y = uv[:, 0], uv[:, 1]
    pts = np.stack([x, y, 0.5 * (x**2 - y**2)], -1)
    nrm = _unit(np.stack([-x, y, np.ones(n)], -1))
    return pts, nrm


def _two_spheres(rng, n):
    p, m = _sphere(rng, n)
    side = rng.randint(0, 2, n) * 2 - 1
    pts = 0.5 * p + np.stack([0.6 * side, np.zeros(n), np.zeros(n)], -1)
    return pts, m


def _pyramid(rng, n):
    # four triangular faces of a tetrahedron
    verts = np.array(
        [[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], float
    )
    faces = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    fidx = rng.randint(0, 4, n)
    u = rng.uniform(0, 1, (n, 2))
    flip = u.sum(-1) > 1
    u[flip] = 1 - u[flip]
    pts = np.zeros((n, 3))
    nrm = np.zeros((n, 3))
    for i in range(n):
        a, b, c = (verts[j] for j in faces[fidx[i]])
        pts[i] = a + u[i, 0] * (b - a) + u[i, 1] * (c - a)
        fn = np.cross(b - a, c - a)
        fn *= np.sign(fn @ (a + b + c))  # outward
        nrm[i] = fn
    return pts, _unit(nrm)


_GENERATORS = [
    _sphere,
    _cube,
    _cylinder,
    _cone,
    _torus,
    _plane,
    _helix,
    _saddle,
    _two_spheres,
    _pyramid,
]

# per-instance deformation budget: sum_j |a_j|*|w_j| <= _DEFORM_LIPSCHITZ
# keeps the field's Jacobian I + sum_j a_j cos(.) d_j w_j^T strictly
# invertible (operator norm of the perturbation < 1) and the shapes
# recognisably their class
_DEFORM_WAVES = 3
_DEFORM_LIPSCHITZ = 0.45


def _deform_instance(
    pts: np.ndarray, nrm: np.ndarray, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-instance smooth deformation with EXACT normal transport.

    Why: every instance of a class used to be the same perfect geometric
    primitive up to sampling noise — the trained victim could classify the
    sphere class by a globally-robust shell feature that no pointwise C&W
    gradient can assemble (round-3 MSG recert failures; real ModelNet has
    no perfect-primitive class, so this was a self-inflicted ceiling).
    Each instance now gets its own low-frequency displacement field

        p' = p + sum_j a_j sin(w_j . p + phi_j) d_j

    whose Jacobian J = I + sum_j a_j cos(w_j . p + phi_j) d_j w_j^T is
    analytic, so surface normals transport exactly as n' = unit(J^{-T} n)
    (covariant normal rule), followed by a per-instance anisotropic scale
    and a z-rotation. No class remains a perfect primitive, while classes
    stay trivially separable (amplitude budget above).
    """
    n = len(pts)
    d = _unit(rng.randn(_DEFORM_WAVES, 3))  # displacement directions
    w = rng.randn(_DEFORM_WAVES, 3)  # frequency vectors
    w = _unit(w) * rng.uniform(0.8, 2.5, (_DEFORM_WAVES, 1))
    phi = rng.uniform(0, 2 * np.pi, _DEFORM_WAVES)
    a = rng.uniform(0.05, 0.15, _DEFORM_WAVES) * rng.choice(
        [-1.0, 1.0], _DEFORM_WAVES
    )
    # rescale amplitudes into the invertibility/recognisability budget
    lip = np.sum(np.abs(a) * np.linalg.norm(w, axis=1))
    if lip > _DEFORM_LIPSCHITZ:
        a *= _DEFORM_LIPSCHITZ / lip

    phase = pts @ w.T + phi  # [n, J]
    out = pts + np.sin(phase) @ (a[:, None] * d)
    jac = np.eye(3)[None] + np.einsum(
        "nj,ja,jb->nab", np.cos(phase) * a, d, w
    )  # [n, 3, 3]
    new_nrm = _unit(
        np.linalg.solve(np.transpose(jac, (0, 2, 1)), nrm[:, :, None])[..., 0]
    )

    # anisotropic scale (normals via inverse scale) + z-rotation
    s = rng.uniform(0.85, 1.15, 3)
    out = out * s
    new_nrm = _unit(new_nrm / s)
    theta = rng.uniform(0, 2 * np.pi)
    c, si = np.cos(theta), np.sin(theta)
    rot = np.array([[c, -si, 0.0], [si, c, 0.0], [0.0, 0.0, 1.0]])
    return out @ rot.T, new_nrm @ rot.T


def sample_shape(
    class_id: int,
    n: int,
    rng: np.random.RandomState,
    deform: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample one cloud of class `class_id` -> (points [n, 3], normals [n, 3]).

    Points are centred and scaled to the unit sphere (matching the reference
    attack-set normalisation, gen_data_mat.py:151-158); normals are unit.
    `deform` (default) applies the per-instance smooth deformation — pass
    False only for tests that need the analytic primitive itself.
    """
    pts, nrm = _GENERATORS[class_id % len(_GENERATORS)](rng, n)
    if deform:
        pts, nrm = _deform_instance(pts, nrm, rng)
    pts = pts - pts.mean(axis=0, keepdims=True)
    pts = pts / np.linalg.norm(pts, axis=1).max()
    return pts.astype(np.float32), nrm.astype(np.float32)


def make_synthetic_attack_set(
    num_per_class: int = 25,
    npoint: int = 1024,
    classes: int = 10,
    seed: int = 0,
    modelnet_labels: bool = True,
) -> dict:
    """Build an attack-set dict {data [N,3,n], normal [N,3,n], label [N,1]}.

    Same .mat structure as the distilled ModelNet set
    (reference Provider/gen_data_mat.py:304-306), so AttackSetDataset and the
    CLIs consume it unchanged. With `modelnet_labels` (default) the 10 shape
    classes carry the ModelNet40 ids of the attacked classes
    (TEN_LABEL_INDEXES) so the All/Random target machinery behaves exactly as
    on the real set; otherwise labels are 0..classes-1.
    """
    rng = np.random.RandomState(seed)
    data, normal, label = [], [], []
    for c in range(classes):
        if modelnet_labels and classes <= len(TEN_LABEL_INDEXES):
            lab = TEN_LABEL_INDEXES[c]
        else:
            lab = c
        for _ in range(num_per_class):
            p, m = sample_shape(c, npoint, rng)
            data.append(p.T)  # store channel-first like the reference .mat
            normal.append(m.T)
            label.append(lab)
    return {
        "data": np.stack(data).astype(np.float32),
        "normal": np.stack(normal).astype(np.float32),
        "label": np.asarray(label, np.int64).reshape(-1, 1),
    }
