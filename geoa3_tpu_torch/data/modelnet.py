"""ModelNet .mat dataset providers (the port's own copy of
geoa3_tpu/data/modelnet.py).

Rebuild of reference Provider/modelnet10_instance250.py,
Provider/defense_modelnet10_instance250.py and Provider/modelnet_pure.py.
All providers are plain numpy (host side); batching yields channel-last
[b, n, 3] arrays that the CLI moves to the device. No DataLoader is needed:
host IO is far off the critical path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import scipy.io as sio

from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES  # noqa: F401

# the 10 attacked ModelNet40 classes (reference modelnet10_instance250.py:10-11)
TEN_LABEL_NAMES = [
    "airplane",
    "bed",
    "bookshelf",
    "bottle",
    "chair",
    "monitor",
    "sofa",
    "table",
    "toilet",
    "vase",
]


def _farthest_points_normalized(
    points: np.ndarray, num_points: int, normal: np.ndarray, rng: np.random.RandomState
) -> Tuple[np.ndarray, np.ndarray]:
    """Random-start numpy FPS + unit-sphere normalisation.

    Reference modelnet10_instance250.py:109-126. points/normal: [n, 3].
    """
    first = rng.randint(len(points))
    selected = [first]
    dists = np.full(len(points), np.inf)
    for _ in range(num_points - 1):
        dists = np.minimum(
            dists, np.linalg.norm(points - points[selected[-1]][None, :], axis=1)
        )
        selected.append(int(np.argmax(dists)))
    res_points = points[selected]
    res_normal = normal[selected]
    avg = res_points.mean(axis=0)
    res_points = res_points - avg[None, :]
    scale = np.linalg.norm(res_points, axis=1).max()
    return res_points / scale, res_normal


@dataclass
class AttackItem:
    """One dataset item: the (instances-per-item x) point clouds + labels."""

    pc: np.ndarray  # [l, n, 3] channel-last
    normal: np.ndarray  # [l, n, 3]
    gt_label: np.ndarray  # [l]
    target_label: Optional[np.ndarray]  # [l] or None (Untarget)


class AttackSetDataset:
    """The distilled attack set (.mat of {data, normal, label}).

    Reference Provider/modelnet10_instance250.py:14-126. Modes:
      * 'All'      -> 9 targeted copies per instance (each other class of the 10)
      * '<name>'   -> the 25-instance slice of that class, 9 targets each
      * 'Untarget' -> single untargeted instance
      * 'Random'   -> single random target in [0, 40) \\ {gt}
    The .mat stores channel-first [N, 3, n]; items are returned channel-last.
    """

    def __init__(
        self,
        data_mat_file: str,
        attack_label: str = "All",
        resample_num: int = -1,
        is_half_forward: bool = False,
        seed: int = 0,
    ):
        if not os.path.isfile(data_mat_file):
            raise FileNotFoundError(f"No exists .mat file! ({data_mat_file})")
        self.attack_label = attack_label
        self.is_half_forward = is_half_forward
        self._rng = np.random.RandomState(seed)

        dataset = sio.loadmat(data_mat_file)
        data = np.asarray(dataset["data"], np.float32)  # [N, 3, n]
        normal = np.asarray(dataset["normal"], np.float32)
        label = np.asarray(dataset["label"]).reshape(-1).astype(np.int64)

        # channel-last
        data = data.transpose(0, 2, 1)
        normal = normal.transpose(0, 2, 1)

        if resample_num > 0:
            pcs, nrms = [], []
            for j in range(data.shape[0]):
                p, m = _farthest_points_normalized(
                    data[j], resample_num, normal[j], self._rng
                )
                pcs.append(p.astype(np.float32))
                nrms.append(m.astype(np.float32))
            data = np.stack(pcs)
            normal = np.stack(nrms)

        if attack_label in TEN_LABEL_NAMES:
            k = TEN_LABEL_NAMES.index(attack_label)
            self.start_index = k * 25
            sl = slice(k * 25, (k + 1) * 25)
            self.data, self.normal, self.label = data[sl], normal[sl], label[sl]
        elif attack_label in ("All", "Untarget", "Random"):
            self.start_index = 0
            self.data, self.normal, self.label = data, normal, label
        else:
            raise AssertionError(f"unknown attack_label {attack_label}")

    def __len__(self) -> int:
        return self.data.shape[0]

    @property
    def num_attack_classes(self) -> int:
        """Copies per instance (reference main_attack.py:164-172)."""
        return 1 if self.attack_label in ("Untarget", "Random") else 9

    def __getitem__(self, index: int) -> AttackItem:
        pc = self.data[index]
        normal = self.normal[index]
        label = int(self.label[index])

        if self.attack_label in TEN_LABEL_NAMES or self.attack_label == "All":
            targets = np.asarray(
                [i for i in TEN_LABEL_INDEXES if i != label], np.int64
            )
            assert targets.shape[0] == 9
            l = 9
            item = AttackItem(
                pc=np.broadcast_to(pc, (l,) + pc.shape).copy(),
                normal=np.broadcast_to(normal, (l,) + normal.shape).copy(),
                gt_label=np.full(l, label, np.int64),
                target_label=targets,
            )
            if self.is_half_forward:
                # split the 9 targets into 4 + 5 chunks so memory-constrained
                # victims run two half batches (reference
                # modelnet10_instance250.py:79-80)
                return [
                    AttackItem(
                        item.pc[:4], item.normal[:4],
                        item.gt_label[:4], item.target_label[:4],
                    ),
                    AttackItem(
                        item.pc[4:], item.normal[4:],
                        item.gt_label[4:], item.target_label[4:],
                    ),
                ]
            return item
        if self.attack_label == "Untarget":
            return AttackItem(
                pc=pc[None],
                normal=normal[None],
                gt_label=np.asarray([label], np.int64),
                target_label=None,
            )
        if self.attack_label == "Random":
            choices = [i for i in range(40) if i != label]
            t = int(self._rng.choice(choices))
            return AttackItem(
                pc=pc[None],
                normal=normal[None],
                gt_label=np.asarray([label], np.int64),
                target_label=np.asarray([t], np.int64),
            )
        raise AssertionError


def batched(
    dataset: AttackSetDataset, batch_size: int
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Yield flattened (pc [b*l, n, 3], normal, gt [b*l], target) batches.

    Collates like the reference DataLoader + view(b*l, ...) reshape
    (reference main_attack.py:174-194). The final short batch is kept
    (drop_last=False).
    """
    for start in range(0, len(dataset), batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, len(dataset)))]
        pc = np.concatenate([it.pc for it in items], 0)
        normal = np.concatenate([it.normal for it in items], 0)
        gt = np.concatenate([it.gt_label for it in items], 0)
        if items[0].target_label is None:
            target = None
        else:
            target = np.concatenate([it.target_label for it in items], 0)
        yield pc, normal, gt, target


def size_batches(sizes, batch_size: int) -> Iterator[List[int]]:
    """Indices of clouds of `sizes` points, grouped by size (smallest size
    first, file order within a size) into batches of at most `batch_size`,
    so that each batch stacks into one shape (the defense and smoothness
    CLIs; pad a short batch with `pad_batch`)."""
    by_n: dict = {}
    for i, n in enumerate(sizes):
        by_n.setdefault(n, []).append(i)
    for _, idxs in sorted(by_n.items()):
        for start in range(0, len(idxs), batch_size):
            yield idxs[start : start + batch_size]


def pad_batch(pcs: List[np.ndarray], batch_size: int) -> np.ndarray:
    """Stack clouds of one size into [batch_size, n, c], repeating the first
    in the rows past the last cloud."""
    return np.stack(list(pcs) + [pcs[0]] * (batch_size - len(pcs)))


class PureMatDataset:
    """Plain .mat loader for dense clouds (reference Provider/modelnet_pure.py)."""

    def __init__(self, data_mat_file: str):
        if not os.path.isfile(data_mat_file):
            raise FileNotFoundError(f"No exists .mat file! ({data_mat_file})")
        dataset = sio.loadmat(data_mat_file)
        self.data = np.asarray(dataset["data"], np.float32).transpose(0, 2, 1)
        self.normal = np.asarray(dataset["normal"], np.float32).transpose(0, 2, 1)
        self.label = np.asarray(dataset["label"]).reshape(-1).astype(np.int64)

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, index: int):
        return self.data[index], self.normal[index], int(self.label[index])


class DefenseMatDataset:
    """A directory of per-instance adversarial .mat outputs.

    Reference Provider/defense_modelnet10_instance250.py:16-31: each file has
    {adversary_point_clouds [3, n], gt_label, attack_label}; items are
    returned channel-last [n, 3].
    """

    def __init__(self, mat_dir: str):
        if not os.path.isdir(mat_dir):
            raise FileNotFoundError(f"No exists Mat dir! ({mat_dir})")
        self.files: List[str] = sorted(
            os.path.join(mat_dir, f)
            for f in os.listdir(mat_dir)
            if f.endswith(".mat")
        )

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int):
        d = sio.loadmat(self.files[index])
        pc = np.asarray(d["adversary_point_clouds"], np.float32)
        if pc.shape[0] == 3:
            pc = pc.T  # [n, 3]
        gt = int(np.asarray(d["gt_label"]).reshape(-1)[0])
        atk = int(np.asarray(d["attack_label"]).reshape(-1)[0])
        return pc, gt, atk
