"""Training datasets: raw ModelNet40 txt loader + synthetic stand-in (the
port's own copy of geoa3_tpu/data/modelnet_train.py, with the numpy txt
parser only).

Rebuild of reference Provider/modelnet_trn_test.py:21-125 (same batch-iterator
protocol: has_next_batch/next_batch/reset, short final batch kept, train split
shuffled) plus a synthetic-shape dataset with the same protocol for
self-contained training runs.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from geoa3_tpu_torch.data import augment
from geoa3_tpu_torch.data.io import pc_normalize
from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES, sample_shape


class _BatchIterMixin:
    """has_next_batch/next_batch/reset protocol (reference :102-125)."""

    def reset(self):
        self.idxs = np.arange(0, len(self))
        if self.shuffle:
            self._rng.shuffle(self.idxs)
        self.num_batches = (len(self) + self.batch_size - 1) // self.batch_size
        self.batch_idx = 0

    def has_next_batch(self) -> bool:
        return self.batch_idx < self.num_batches

    def _augment_batch_data(self, batch_data: np.ndarray) -> np.ndarray:
        """The reference augmentation stack (reference :58-70)."""
        if self.normal_channel:
            rotated = augment.rotate_point_cloud_with_normal(batch_data)
            rotated = augment.rotate_perturbation_point_cloud_with_normal(rotated)
        else:
            rotated = augment.rotate_point_cloud(batch_data)
            rotated = augment.rotate_perturbation_point_cloud(rotated)
        jittered = augment.random_scale_point_cloud(rotated[:, :, 0:3])
        jittered = augment.shift_point_cloud(jittered)
        jittered = augment.jitter_point_cloud(jittered)
        rotated[:, :, 0:3] = jittered
        return augment.shuffle_points(rotated)

    def next_batch(self, do_augment: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        start = self.batch_idx * self.batch_size
        end = min((self.batch_idx + 1) * self.batch_size, len(self))
        bsize = end - start
        nch = 6 if self.normal_channel else 3
        batch_data = np.zeros((bsize, self.npoints, nch), np.float32)
        batch_label = np.zeros(bsize, np.int32)
        for i in range(bsize):
            ps, cls = self[self.idxs[start + i]]
            batch_data[i] = ps
            batch_label[i] = cls
        self.batch_idx += 1
        if do_augment:
            batch_data = self._augment_batch_data(batch_data)
        return batch_data, batch_label


class ModelNetTrainDataset(_BatchIterMixin):
    """Raw ModelNet40_normal_resampled txt reader (reference :21-100).

    Directory layout: {root}/modelnet40_shape_names.txt,
    {root}/modelnet40_{split}.txt, {root}/{shape}/{shape}_XXXX.txt with
    comma-separated x,y,z,nx,ny,nz rows.
    """

    def __init__(
        self,
        root: str,
        batch_size: int = 32,
        npoints: int = 1024,
        split: str = "train",
        normalize: bool = True,
        normal_channel: bool = False,
        modelnet10: bool = False,
        cache_size: int = 15000,
        shuffle: Optional[bool] = None,
        seed: int = 0,
    ):
        assert split in ("train", "test")
        self.root = root
        self.batch_size = batch_size
        self.npoints = npoints
        self.normalize = normalize
        self.normal_channel = normal_channel
        self._rng = np.random.RandomState(seed)

        prefix = "modelnet10" if modelnet10 else "modelnet40"
        catfile = os.path.join(root, f"{prefix}_shape_names.txt")
        self.cat = [ln.rstrip() for ln in open(catfile)]
        self.classes = dict(zip(self.cat, range(len(self.cat))))
        shape_ids = [
            ln.rstrip() for ln in open(os.path.join(root, f"{prefix}_{split}.txt"))
        ]
        shape_names = ["_".join(x.split("_")[0:-1]) for x in shape_ids]
        self.datapath = [
            (shape_names[i], os.path.join(root, shape_names[i], shape_ids[i]) + ".txt")
            for i in range(len(shape_ids))
        ]
        self.cache_size = cache_size
        self.cache: dict = {}
        self.shuffle = (split == "train") if shuffle is None else shuffle
        self.reset()

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index: int):
        if index in self.cache:
            return self.cache[index]
        name, path = self.datapath[index]
        cls = self.classes[name]
        point_set = self._read_points(path)
        if self.normalize:
            point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        if not self.normal_channel:
            point_set = point_set[:, 0:3]
        if len(self.cache) < self.cache_size:
            self.cache[index] = (point_set, cls)
        return point_set, cls

    def _read_points(self, path: str) -> np.ndarray:
        """Read the first npoints rows of a comma-separated txt file."""
        point_set = np.loadtxt(path, delimiter=",").astype(np.float32)
        return point_set[0 : self.npoints, :]


class SyntheticTrainDataset(_BatchIterMixin):
    """Synthetic-shape dataset with the same iterator protocol.

    Lets the trainer, tests and benchmarks run without the (non-shipped)
    ModelNet40 download. `classes` > 10 cycles through the shape generators
    with different scale factors to stay separable.
    """

    def __init__(
        self,
        num_per_class: int = 32,
        classes: int = 10,
        batch_size: int = 32,
        npoints: int = 1024,
        split: str = "train",
        normal_channel: bool = False,
        shuffle: Optional[bool] = None,
        seed: int = 0,
        modelnet_labels: bool = False,
    ):
        self.batch_size = batch_size
        self.npoints = npoints
        self.normal_channel = normal_channel
        self.num_classes = classes
        self._rng = np.random.RandomState(seed + (0 if split == "train" else 10_000))
        self.shuffle = (split == "train") if shuffle is None else shuffle
        if modelnet_labels:
            # carry the ModelNet40 ids of the attacked classes so a 40-way
            # victim + the attack-set distillation line up with the real setup
            assert classes <= len(TEN_LABEL_INDEXES)
            label_map = TEN_LABEL_INDEXES
        else:
            label_map = list(range(classes))
        data, labels = [], []
        for c in range(classes):
            for _ in range(num_per_class):
                p, m = sample_shape(c, npoints, self._rng)
                data.append(np.concatenate([p, m], -1) if normal_channel else p)
                labels.append(label_map[c])
        self.data = np.stack(data)
        self.labels = np.asarray(labels, np.int32)
        self.reset()

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, index: int):
        return self.data[index], int(self.labels[index])
