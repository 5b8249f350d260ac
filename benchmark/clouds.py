"""Synthetic point clouds with normals, made from a seed.

A copy of the port's synthetic shape generator (ten parametric classes,
each instance deformed by its own smooth field with exact normal transport,
scaled anisotropically, rotated about z, centred and scaled to the unit
sphere), written with whole-array numpy and a `numpy.random.Generator`, so
that any seed up to and past 2**32 is taken and a pool of hundreds of clouds
is made in well under a second.
"""

from __future__ import annotations

import numpy as np

# ModelNet40 ids of the ten attacked classes (the reference's attack set)
TEN_LABEL_INDEXES = (17, 9, 36, 20, 3, 16, 34, 38, 23, 15)
_WAVES = 3
_LIPSCHITZ = 0.45


def _unit(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-12)


def _sphere(rng, n):
    p = _unit(rng.standard_normal((n, 3)))
    return p, p.copy()


def _cube(rng, n):
    face = rng.integers(0, 6, n)
    uv = rng.uniform(-1, 1, (n, 2))
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    rows = np.arange(n)
    pts = np.zeros((n, 3))
    nrm = np.zeros((n, 3))
    pts[rows, axis] = sign
    pts[rows, (axis + 1) % 3] = uv[:, 0]
    pts[rows, (axis + 2) % 3] = uv[:, 1]
    nrm[rows, axis] = sign
    return pts, nrm


def _cylinder(rng, n):
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    return (np.stack([np.cos(th), np.sin(th), z], -1),
            np.stack([np.cos(th), np.sin(th), np.zeros(n)], -1))


def _cone(rng, n):
    th = rng.uniform(0, 2 * np.pi, n)
    h = np.sqrt(rng.uniform(0, 1, n))
    r = 1 - h
    pts = np.stack([r * np.cos(th), r * np.sin(th), 2 * h - 1], -1)
    return pts, _unit(np.stack([2 * np.cos(th), 2 * np.sin(th), np.ones(n)], -1))


def _torus(rng, n, R=0.7, r=0.3):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack([(R + r * np.cos(v)) * np.cos(u), (R + r * np.cos(v)) * np.sin(u),
                    r * np.sin(v)], -1)
    centres = np.stack([R * np.cos(u), R * np.sin(u), np.zeros(n)], -1)
    return pts, _unit(pts - centres)


def _plane(rng, n):
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.stack([uv[:, 0], uv[:, 1], 0.05 * np.sin(3 * uv[:, 0])], -1)
    dz = 0.15 * np.cos(3 * uv[:, 0])
    return pts, _unit(np.stack([-dz, np.zeros(n), np.ones(n)], -1))


def _helix(rng, n):
    t = rng.uniform(0, 4 * np.pi, n)
    pts = (np.stack([np.cos(t), np.sin(t), t / (2 * np.pi) - 1], -1)
           + 0.05 * rng.standard_normal((n, 3)))
    return pts, _unit(np.stack([np.cos(t), np.sin(t), np.zeros(n)], -1))


def _saddle(rng, n):
    uv = rng.uniform(-1, 1, (n, 2))
    x, y = uv[:, 0], uv[:, 1]
    return (np.stack([x, y, 0.5 * (x ** 2 - y ** 2)], -1),
            _unit(np.stack([-x, y, np.ones(n)], -1)))


def _two_spheres(rng, n):
    p, m = _sphere(rng, n)
    side = rng.integers(0, 2, n) * 2 - 1
    return 0.5 * p + np.stack([0.6 * side, np.zeros(n), np.zeros(n)], -1), m


_VERTS = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], float)
_FACES = np.array([(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)])


def _pyramid(rng, n):
    f = _FACES[rng.integers(0, 4, n)]
    u = rng.uniform(0, 1, (n, 2))
    flip = u.sum(-1) > 1
    u[flip] = 1 - u[flip]
    a, b, c = _VERTS[f[:, 0]], _VERTS[f[:, 1]], _VERTS[f[:, 2]]
    pts = a + u[:, :1] * (b - a) + u[:, 1:] * (c - a)
    fn = np.cross(b - a, c - a)
    fn *= np.sign((fn * (a + b + c)).sum(-1, keepdims=True))
    return pts, _unit(fn)


_SHAPES = (_sphere, _cube, _cylinder, _cone, _torus, _plane, _helix, _saddle,
           _two_spheres, _pyramid)


def _deform(pts, nrm, rng):
    d = _unit(rng.standard_normal((_WAVES, 3)))
    w = _unit(rng.standard_normal((_WAVES, 3))) * rng.uniform(0.8, 2.5, (_WAVES, 1))
    phi = rng.uniform(0, 2 * np.pi, _WAVES)
    a = rng.uniform(0.05, 0.15, _WAVES) * rng.choice([-1.0, 1.0], _WAVES)
    lip = np.sum(np.abs(a) * np.linalg.norm(w, axis=1))
    if lip > _LIPSCHITZ:
        a *= _LIPSCHITZ / lip
    phase = pts @ w.T + phi
    out = pts + np.sin(phase) @ (a[:, None] * d)
    jac = np.eye(3)[None] + np.einsum("nj,ja,jb->nab", np.cos(phase) * a, d, w)
    nrm = _unit(np.linalg.solve(np.transpose(jac, (0, 2, 1)), nrm[:, :, None])[..., 0])
    s = rng.uniform(0.85, 1.15, 3)
    out, nrm = out * s, _unit(nrm / s)
    th = rng.uniform(0, 2 * np.pi)
    rot = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0],
                    [0.0, 0.0, 1.0]])
    return out @ rot.T, nrm @ rot.T


def shape(class_id: int, n: int, rng: np.random.Generator):
    """One cloud of shape class `class_id` -> (points, normals) [n, 3]
    float32, centred and scaled to the unit sphere."""
    pts, nrm = _SHAPES[class_id % 10](rng, n)
    pts, nrm = _deform(pts, nrm, rng)
    pts = pts - pts.mean(axis=0, keepdims=True)
    pts = pts / np.linalg.norm(pts, axis=1).max()
    return pts.astype(np.float32), nrm.astype(np.float32)


def pool(count: int, n: int, rng: np.random.Generator):
    """`count` clouds, the ten classes in turn in an order drawn from `rng`
    -> (points [count, n, 3], normals, class ids [count] in 0..9)."""
    ids = rng.permutation(np.arange(count) % 10)
    pts, nrm = zip(*(shape(int(c), n, rng) for c in ids))
    return np.stack(pts), np.stack(nrm), ids
