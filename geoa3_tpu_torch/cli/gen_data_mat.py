"""Attack-set distillation CLI of the port (counterpart of
geoa3_tpu/cli/gen_data_mat.py; reference Provider/gen_data_mat.py).

    python -m geoa3_tpu_torch.cli.gen_data_mat --datadir synthetic \\
        --checkpoint victim.pt --outdir Data

Builds `{outdir}/modelnet10_{N}instances{npoint}_{arch}.mat` from a
ModelNet40 test split (`--datadir` a modelnet40_normal_resampled directory),
from the synthetic shape generator (`--datadir synthetic`), or from ascii-PLY
virtual scans (`--is_using_virscan`), keeping only instances the victim
classifies correctly. The victim runs on the card (`--device cuda`, the
default) unless `--device cpu` is given, in eval mode in batches of 64;
without a CUDA device the default fails.

The JAX CLI pins the victim's composed path so that the selection cannot
move between runs. The port has one path: its contract is that two eval
forwards on the card are bit-equal, which chip_smoke.py checks for each
victim.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as sio
import torch

from geoa3_tpu_torch.data.gen_data_mat import (
    distill_attack_set,
    distill_virscan_set,
)
from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES, sample_shape
from geoa3_tpu_torch.device import entry_device
from geoa3_tpu_torch.utils.checkpoint import load_victim


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Attack-set distillation")
    parser.add_argument(
        "--datadir", default="/data/modelnet40_normal_resampled/", type=str
    )
    parser.add_argument("--arch", default="PointNet", type=str)
    parser.add_argument("-c", "--classes", default=40, type=int)
    parser.add_argument("--npoint", default=1024, type=int)
    parser.add_argument("--max_out_num", default=25, type=int)
    parser.add_argument("--outdir", default="Data", type=str)
    parser.add_argument("--checkpoint", default=None, type=str)
    parser.add_argument(
        "--no_axis_swap", action="store_true", default=False,
        help="skip the reference's [0,2,1] y/z swap",
    )
    parser.add_argument("--random_seed", default=0, type=int)
    # ---- virtual-scan path (reference gen_data_mat.py:186-226) ----
    parser.add_argument(
        "--is_using_virscan", action="store_true", default=False,
        help="assemble from ascii-PLY virtual scans instead of a test split",
    )
    parser.add_argument(
        "--virscan_dir", default="Data/Ten_class_pc_normal", type=str,
        help="directory of *_<label>.ply scans (reference hardcodes "
        "Data/Ten_class_pc_normal)",
    )
    parser.add_argument(
        "--dense_npoints", default=10000, type=int,
        help="paired dense variant size; 0 disables (reference default 10000)",
    )
    parser.add_argument(
        "--device", default="cuda", type=str,
        help="where the victim runs: cuda (default) or cpu",
    )
    return parser


def make_logits_fn(cfg, device):
    """logits_fn(pc numpy [b, n, 3]) -> numpy [b, classes]: the victim in
    eval mode on `device`, its weights loaded."""
    model, _ = load_victim(cfg.arch, cfg.classes, cfg.npoint, cfg.checkpoint,
                           device)

    def logits_fn(pc):
        x = torch.from_numpy(np.ascontiguousarray(pc, np.float32)).to(device)
        with torch.no_grad():
            return model(x).cpu().numpy()

    return logits_fn


def _save(cfg, out: dict, n_inst: int, npoint: int) -> str:
    """Write `out` as the attack set of n_inst instances of npoint points."""
    path = os.path.join(
        cfg.outdir, f"modelnet10_{n_inst}instances{npoint}_{cfg.arch}.mat"
    )
    sio.savemat(path, out)
    return path


def main(cfg) -> str:
    device = entry_device(cfg.device)
    logits_fn = make_logits_fn(cfg, device)

    if cfg.is_using_virscan:
        out, dense_out = distill_virscan_set(
            cfg.virscan_dir,
            logits_fn,
            npoint=cfg.npoint,
            dense_npoints=cfg.dense_npoints,
            max_out_num=cfg.max_out_num,
            seed=cfg.random_seed,
        )
        os.makedirs(cfg.outdir, exist_ok=True)
        n_inst = out["data"].shape[0]
        path = _save(cfg, out, n_inst, cfg.npoint)
        print(f"saved {n_inst} instances -> {path}")
        if dense_out is not None:
            dense_path = _save(cfg, dense_out, n_inst, cfg.dense_npoints)
            print(f"saved dense variant -> {dense_path}")
        return path

    if cfg.datadir.startswith("synthetic"):
        rng = np.random.RandomState(cfg.random_seed)

        def instances():
            for c, lab in enumerate(TEN_LABEL_INDEXES):
                for _ in range(cfg.max_out_num * 2):
                    p, m = sample_shape(c, cfg.npoint, rng)
                    yield p, m, lab

        axis_swap = False  # synthetic shapes carry no ModelNet axis convention
    else:
        from geoa3_tpu_torch.data.modelnet_train import ModelNetTrainDataset

        ds = ModelNetTrainDataset(
            root=cfg.datadir,
            batch_size=1,
            npoints=cfg.npoint,
            split="test",
            normal_channel=True,
            shuffle=False,
        )

        def instances():
            for i in range(len(ds)):
                ps, lab = ds[i]
                yield ps[:, 0:3], ps[:, 3:6], int(lab)

        axis_swap = not cfg.no_axis_swap

    out = distill_attack_set(
        instances(),
        logits_fn,
        max_out_num=cfg.max_out_num,
        axis_swap=axis_swap,
        seed=cfg.random_seed,
    )
    os.makedirs(cfg.outdir, exist_ok=True)
    n_inst = out["data"].shape[0]
    path = _save(cfg, out, n_inst, cfg.npoint)
    print(f"saved {n_inst} instances -> {path}")
    return path


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    main(args)
