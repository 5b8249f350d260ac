"""Dense-cloud resampler CLI of the port (counterpart of
geoa3_tpu/cli/resample_mat.py; reference
Provider/gen_data_mat_sample_from10000.py:7-47).

FPS-resamples + renormalises every instance of a dense attack-set .mat (e.g.
10000 points) down to a target point count, writing a new .mat with the same
{data, normal, label} structure.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as sio

from geoa3_tpu_torch.data.gen_data_mat import farthest_points_normalized


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Dense mat resampler")
    parser.add_argument("--input", required=True, type=str, help="source .mat")
    parser.add_argument("--output", default=None, type=str)
    parser.add_argument("--npoint", default=5000, type=int)
    parser.add_argument("--random_seed", default=0, type=int)
    return parser


def main(cfg) -> str:
    src = sio.loadmat(cfg.input)
    data = np.asarray(src["data"], np.float32)  # [N, 3, n]
    normal = np.asarray(src["normal"], np.float32)
    label = np.asarray(src["label"])
    rng = np.random.RandomState(cfg.random_seed)

    out_pc, out_nrm = [], []
    for j in range(data.shape[0]):
        pc, nrm = farthest_points_normalized(
            data[j].T, cfg.npoint, rng=rng, extras=[normal[j].T]
        )
        out_pc.append(pc.T)
        out_nrm.append(nrm.T)

    out_path = cfg.output or os.path.splitext(cfg.input)[0] + f"_{cfg.npoint}.mat"
    sio.savemat(
        out_path,
        {
            "data": np.stack(out_pc).astype(np.float32),
            "normal": np.stack(out_nrm).astype(np.float32),
            "label": label,
        },
    )
    print(f"resampled {data.shape[0]} instances -> {out_path}")
    return out_path


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    main(args)
