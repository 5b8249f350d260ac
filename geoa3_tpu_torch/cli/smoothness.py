"""Smoothness-metric CLI of the port (counterpart of
geoa3_tpu/cli/smoothness.py; reference
Measurement/compute_data_smoothness.py:10-86).

    python -m geoa3_tpu_torch.cli.smoothness --datadir Exps/<run> --k 16

Reads a Mat directory of adversarial outputs (or a directory of .xyz files
with --is_not_mat), computes each cloud's smoothness (measurement.py) in
batches of 32 grouped by point count, and writes metric/k{k}.mat and
metric/result.txt in the reference formats. Runs on the card (`--device
cuda`, the default) unless `--device cpu` is given; without a CUDA device
the default fails.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as sio
import torch

from geoa3_tpu_torch.data.io import read_xyz
from geoa3_tpu_torch.data.modelnet import pad_batch, size_batches
from geoa3_tpu_torch.device import entry_device
from geoa3_tpu_torch.measurement import smoothness

BS = 32  # clouds a batch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Smoothness Computing")
    parser.add_argument(
        "--datadir", default="Data/modelnet40_1024_processed", type=str,
        metavar="DIR",
    )
    parser.add_argument("--k", type=int, default=16)
    parser.add_argument("--k2", type=int, default=16)
    parser.add_argument("--print_freq", default=50, type=int)
    parser.add_argument("--is_not_mat", action="store_true", default=False)
    parser.add_argument(
        "--device", default="cuda", type=str,
        help="where the metric runs: cuda (default) or cpu",
    )
    return parser


def load_clouds(cfg) -> list:
    """The clouds of `--datadir` in file-name order, each [n, 3]."""
    src_dir = cfg.datadir if cfg.is_not_mat else os.path.join(cfg.datadir, "Mat")
    clouds = []
    for filename in sorted(os.listdir(src_dir)):
        if cfg.is_not_mat:
            pc = read_xyz(os.path.join(src_dir, filename))
        else:
            pc = np.asarray(
                sio.loadmat(os.path.join(src_dir, filename))[
                    "adversary_point_clouds"
                ],
                np.float32,
            )
            if pc.shape[0] == 3:
                pc = pc.T
        clouds.append(pc)
    return clouds


def main(cfg) -> float:
    device = entry_device(cfg.device)
    clouds = load_clouds(cfg)

    values = [0.0] * len(clouds)
    for chunk in size_batches([pc.shape[0] for pc in clouds], BS):
        pcs = pad_batch([clouds[i] for i in chunk], BS)
        pc = torch.from_numpy(np.ascontiguousarray(pcs, np.float32)).to(device)
        s_batch = smoothness(pc, k=cfg.k, k2=cfg.k2).cpu().numpy()
        for j, i in enumerate(chunk):
            values[i] = float(s_batch[j])
    for i in range(0, len(values), cfg.print_freq):
        print(
            "[{0}/{1}]: {2:.4f}({3:.4f})".format(
                i + 1, len(values), values[i], float(np.mean(values[: i + 1]))
            )
        )

    values = np.asarray(values, np.float32)
    metric_dir = os.path.join(cfg.datadir, "metric")
    os.makedirs(metric_dir, exist_ok=True)
    sio.savemat(
        os.path.join(metric_dir, f"k{cfg.k}.mat"), {"smoothness": values}
    )
    info = "k: {0}, avg: {1:.4f}, min: {2:.4f}, max: {3:.4f}\n".format(
        cfg.k, values.mean(), values.min(), values.max()
    )
    with open(os.path.join(metric_dir, "result.txt"), "at") as f:
        print(info)
        f.write(info)
    return float(values.mean())


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    main(args)
