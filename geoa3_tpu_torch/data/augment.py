"""Numpy train-time augmentations (the port's own copy of
geoa3_tpu/data/augment.py; reference Provider/provider.py).

All functions take channel-last batches [B, N, 3] (the reference layout too)
and return new arrays. Randomness uses an explicit numpy Generator/RandomState
when given, else the global numpy RNG (matching reference behaviour).
"""

from __future__ import annotations

import numpy as np


def _rng(rng):
    return np.random if rng is None else rng


def normalize_data(batch_data: np.ndarray) -> np.ndarray:
    """Centre + unit-sphere scale each cloud (reference provider.py:3-19)."""
    out = np.empty_like(batch_data)
    for b in range(batch_data.shape[0]):
        pc = batch_data[b]
        pc = pc - pc.mean(axis=0)
        scale = np.max(np.sqrt(np.sum(pc**2, axis=1)))
        out[b] = pc / scale
    return out


def shuffle_data(data: np.ndarray, labels: np.ndarray, rng=None):
    """Shuffle instances (reference provider.py:22-31)."""
    idx = np.arange(len(labels))
    _rng(rng).shuffle(idx)
    return data[idx], labels[idx], idx


def shuffle_points(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Shuffle point order per batch (same permutation, reference :34-43)."""
    idx = np.arange(batch_data.shape[1])
    _rng(rng).shuffle(idx)
    return batch_data[:, idx, :]


def _rotate(batch_data: np.ndarray, mats: np.ndarray) -> np.ndarray:
    return np.einsum("bnd,bde->bne", batch_data, mats)


def _y_rotation(angles: np.ndarray) -> np.ndarray:
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([c, zeros, s], -1),
            np.stack([zeros, ones, zeros], -1),
            np.stack([-s, zeros, c], -1),
        ],
        -2,
    )


def _z_rotation(angles: np.ndarray) -> np.ndarray:
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    return np.stack(
        [
            np.stack([c, s, zeros], -1),
            np.stack([-s, c, zeros], -1),
            np.stack([zeros, zeros, ones], -1),
        ],
        -2,
    )


def rotate_point_cloud(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Random rotation about Y (up) axis (reference provider.py:46-66)."""
    angles = _rng(rng).uniform(size=batch_data.shape[0]) * 2 * np.pi
    return _rotate(batch_data, _y_rotation(angles))


def rotate_point_cloud_z(batch_data: np.ndarray, rng=None) -> np.ndarray:
    """Random rotation about Z axis (reference provider.py:68-88)."""
    angles = _rng(rng).uniform(size=batch_data.shape[0]) * 2 * np.pi
    return _rotate(batch_data, _z_rotation(angles))


def rotate_point_cloud_with_normal(
    batch_xyz_normal: np.ndarray, rng=None
) -> np.ndarray:
    """Y-rotation of [B, N, 6] xyz+normal clouds (reference provider.py:90-104)."""
    angles = _rng(rng).uniform(size=batch_xyz_normal.shape[0]) * 2 * np.pi
    mats = _y_rotation(angles)
    out = batch_xyz_normal.copy()
    out[..., 0:3] = _rotate(batch_xyz_normal[..., 0:3], mats)
    out[..., 3:6] = _rotate(batch_xyz_normal[..., 3:6], mats)
    return out


def _perturbation_mats(b: int, angle_sigma: float, angle_clip: float, rng=None):
    angles = np.clip(
        angle_sigma * _rng(rng).randn(b, 3), -angle_clip, angle_clip
    )
    c, s = np.cos(angles), np.sin(angles)
    out = np.empty((b, 3, 3))
    for i in range(b):
        Rx = np.array(
            [[1, 0, 0], [0, c[i, 0], -s[i, 0]], [0, s[i, 0], c[i, 0]]]
        )
        Ry = np.array(
            [[c[i, 1], 0, s[i, 1]], [0, 1, 0], [-s[i, 1], 0, c[i, 1]]]
        )
        Rz = np.array(
            [[c[i, 2], -s[i, 2], 0], [s[i, 2], c[i, 2], 0], [0, 0, 1]]
        )
        out[i] = Rz @ Ry @ Rx
    return out


def rotate_perturbation_point_cloud(
    batch_data: np.ndarray, angle_sigma=0.06, angle_clip=0.18, rng=None
) -> np.ndarray:
    """Small random 3-axis rotations (reference provider.py:106-130)."""
    mats = _perturbation_mats(batch_data.shape[0], angle_sigma, angle_clip, rng)
    return _rotate(batch_data, mats)


def rotate_perturbation_point_cloud_with_normal(
    batch_xyz_normal: np.ndarray, angle_sigma=0.06, angle_clip=0.18, rng=None
) -> np.ndarray:
    """Perturbation rotation of xyz+normal (reference provider.py:176-198)."""
    mats = _perturbation_mats(
        batch_xyz_normal.shape[0], angle_sigma, angle_clip, rng
    )
    out = batch_xyz_normal.copy()
    out[..., 0:3] = _rotate(batch_xyz_normal[..., 0:3], mats)
    out[..., 3:6] = _rotate(batch_xyz_normal[..., 3:6], mats)
    return out


def rotate_point_cloud_by_angle(
    batch_data: np.ndarray, rotation_angle: float
) -> np.ndarray:
    """Fixed-angle Y rotation (reference provider.py:133-151)."""
    angles = np.full(batch_data.shape[0], rotation_angle)
    return _rotate(batch_data, _y_rotation(angles))


def rotate_point_cloud_by_angle_with_normal(
    batch_data: np.ndarray, rotation_angle: float
) -> np.ndarray:
    """Fixed-angle Y rotation of [B, N, 6] xyz+normal (reference :152-174)."""
    angles = np.full(batch_data.shape[0], rotation_angle)
    mats = _y_rotation(angles)
    out = batch_data.copy()
    out[..., 0:3] = _rotate(batch_data[..., 0:3], mats)
    out[..., 3:6] = _rotate(batch_data[..., 3:6], mats)
    return out


def jitter_point_cloud(
    batch_data: np.ndarray, sigma=0.01, clip=0.05, rng=None
) -> np.ndarray:
    """Clamped gaussian point jitter (reference provider.py:201-212)."""
    assert clip > 0
    noise = np.clip(
        sigma * _rng(rng).randn(*batch_data.shape), -clip, clip
    )
    return batch_data + noise


def shift_point_cloud(
    batch_data: np.ndarray, shift_range=0.1, rng=None
) -> np.ndarray:
    """Per-cloud random translation (reference provider.py:214-225)."""
    shifts = _rng(rng).uniform(
        -shift_range, shift_range, (batch_data.shape[0], 3)
    )
    return batch_data + shifts[:, None, :]


def random_scale_point_cloud(
    batch_data: np.ndarray, scale_low=0.8, scale_high=1.25, rng=None
) -> np.ndarray:
    """Per-cloud random scale (reference provider.py:228-239)."""
    scales = _rng(rng).uniform(scale_low, scale_high, batch_data.shape[0])
    return batch_data * scales[:, None, None]


def random_point_dropout(
    batch_pc: np.ndarray, max_dropout_ratio=0.875, rng=None
) -> np.ndarray:
    """Drop random points, replacing them with the first point (reference :241-248)."""
    out = batch_pc.copy()
    r = _rng(rng)
    for b in range(batch_pc.shape[0]):
        dropout_ratio = r.random_sample() * max_dropout_ratio
        drop_idx = np.where(r.random_sample(batch_pc.shape[1]) <= dropout_ratio)[0]
        if len(drop_idx) > 0:
            out[b, drop_idx, :] = out[b, 0, :]
    return out
