"""Victim training CLI of the port (counterpart of geoa3_tpu/cli/main_train.py;
reference main_train.py:33-57).

    python -m geoa3_tpu_torch.cli.main_train --arch PointNet \\
        --datadir synthetic:64 --epochs 250

`--datadir synthetic[:per_class[:classes]]` trains on the built-in
synthetic shape dataset; otherwise it expects a ModelNet40_normal_resampled
directory. Writes `checkpoint.pth.tar` every epoch, `model_best.pth.tar` on
a new best and one `result.txt` line an epoch into `--modeldir` (default
Pretrained/{arch}/{npoint}), the files the attack and defense CLIs read.
Trains on the card (`--device cuda`, the default) unless `--device cpu` is
given; without a CUDA device the default fails. TF32 is off
(device.float32_exact). `--max_epoch_retries` (the port's own flag) sets
how many times a failed epoch is retried from the last good state.
"""

from __future__ import annotations

import argparse
import os

from geoa3_tpu_torch.device import entry_device
from geoa3_tpu_torch.train import TrainConfig, train


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Point Cloud Training")
    # ========================= Random seed ==========================
    parser.add_argument("--id", default=0, type=int)
    parser.add_argument("--random_seed", default=0, type=int)
    # ========================= Data loader ==========================
    parser.add_argument(
        "--datadir", default="/data/modelnet40_normal_resampled/", type=str,
        metavar="DIR",
    )
    parser.add_argument("-c", "--classes", default=40, type=int, metavar="N")
    parser.add_argument("--npoint", default=1024, type=int)
    parser.add_argument("--is_aug_data", action="store_true", default=False)
    # ========================= Model ==========================
    parser.add_argument("--arch", default="PointNet", type=str, metavar="ARCH")
    # ========================= Training ==========================
    parser.add_argument("-g", "--mGPU", default=1, type=int, metavar="N",
                        help="kept for flag parity; one device")
    parser.add_argument("-j", "--num_workers", default=8, type=int, metavar="N")
    parser.add_argument("-b", "--batch_size", default=32, type=int, metavar="N")
    parser.add_argument("--epochs", default=250, type=int, metavar="N")
    parser.add_argument("--lr", default=0.001, type=float, metavar="LR")
    parser.add_argument("--decay-epochs", dest="decay_epochs", default=20,
                        type=int, metavar="N")
    parser.add_argument("--bn_momentum", default=0.5, type=float, metavar="BN")
    parser.add_argument("--wd", default=0.0001, type=float, metavar="W")
    parser.add_argument("--max_epoch_retries", default=3, type=int, metavar="N",
                        help="retries of a failed epoch from the last good state")
    # ========================= Runtime ==========================
    parser.add_argument("--resume", default="", type=str, metavar="PATH")
    parser.add_argument("--device", default="cuda", type=str,
                        help="where training runs: cuda (default) or cpu")
    # ========================= Monitor ==========================
    parser.add_argument("--is_use_tb", action="store_true", default=False)
    parser.add_argument("--modeldir", default=None, type=str,
                        help="override Pretrained/{arch}/{npoint}")
    return parser


def datasets(cfg_args, tcfg: TrainConfig):
    """(train, test) datasets of `--datadir`."""
    if cfg_args.datadir.startswith("synthetic"):
        from geoa3_tpu_torch.data.modelnet_train import SyntheticTrainDataset

        # synthetic:per_class:shape_classes — shape_classes is how many of the
        # 10 generators to use; the model head keeps -c classes
        parts = cfg_args.datadir.split(":")
        per_class = int(parts[1]) if len(parts) > 1 else 64
        shape_classes = int(parts[2]) if len(parts) > 2 else min(tcfg.classes, 10)
        use_mn_labels = tcfg.classes >= 40 and shape_classes <= 10
        kw = dict(classes=shape_classes, batch_size=tcfg.batch_size,
                  npoints=tcfg.npoint, seed=tcfg.seed,
                  modelnet_labels=use_mn_labels)
        return (SyntheticTrainDataset(num_per_class=per_class, split="train", **kw),
                SyntheticTrainDataset(num_per_class=max(per_class // 4, 4),
                                      split="test", **kw))
    from geoa3_tpu_torch.data.modelnet_train import ModelNetTrainDataset

    kw = dict(root=cfg_args.datadir, batch_size=tcfg.batch_size,
              npoints=tcfg.npoint, normal_channel=False)
    return (ModelNetTrainDataset(split="train", **kw),
            ModelNetTrainDataset(split="test", **kw))


def run(cfg_args):
    """Train as the CLI does -> (TrainState, {"best_prec", "class_prec"})."""
    device = entry_device(cfg_args.device)
    modeldir = cfg_args.modeldir or os.path.join(
        "Pretrained", cfg_args.arch, str(cfg_args.npoint)
    )
    os.makedirs(modeldir, exist_ok=True)
    tcfg = TrainConfig(
        arch=cfg_args.arch,
        classes=cfg_args.classes,
        npoint=cfg_args.npoint,
        batch_size=cfg_args.batch_size,
        epochs=cfg_args.epochs,
        lr=cfg_args.lr,
        decay_epochs=cfg_args.decay_epochs,
        bn_momentum=cfg_args.bn_momentum,
        wd=cfg_args.wd,
        is_aug_data=cfg_args.is_aug_data,
        seed=cfg_args.random_seed,
        use_tensorboard=cfg_args.is_use_tb,
        # the [0,2,1] swap is a ModelNet convention (reference :211); synthetic
        # shapes carry none, and gen_data_mat's synthetic mode skips it too
        axis_swap=not cfg_args.datadir.startswith("synthetic"),
        max_epoch_retries=cfg_args.max_epoch_retries,
        device=str(device),
    )
    train_ds, test_ds = datasets(cfg_args, tcfg)
    return train(tcfg, train_ds, test_ds, modeldir=modeldir,
                 resume=cfg_args.resume or None)


def main(cfg_args) -> dict:
    return run(cfg_args)[1]


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    main(args)
