"""Defense evaluation CLI of the port (counterpart of geoa3_tpu/cli/defense.py;
reference defense.py:52-191).

    python -m geoa3_tpu_torch.cli.defense --datadir Exps/<run>/Mat \\
        --defense_type outliers_fixNum --checkpoint victim.pt

Loads a Mat directory of adversarial outputs, applies a point-removal
defense, re-classifies, and reports attack success after the defense, the
attacks that still succeed and the average number of dropped points,
appended to defense_result.txt with the reference's line formats. The
clouds run in batches of 32 grouped by point count (the last batch of a
group padded with its first cloud); clouds larger than `--npoint` are first
resampled by random-start farthest-point sampling. PointNet classifies the
variance defense's padded clouds with their keep mask; PointNet++ takes the
padded cloud as it is (the padding is neutral there, defense.py).

Runs on the card (`--device cuda`, the default) unless `--device cpu` is
given; without a CUDA device the default fails. The victim checkpoint is a
PyTorch file, as for the attack CLI (utils/checkpoint.py).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from geoa3_tpu_torch import defense as gdef
from geoa3_tpu_torch.data import io as gio
from geoa3_tpu_torch.data.modelnet import DefenseMatDataset, pad_batch, size_batches
from geoa3_tpu_torch.device import entry_device
from geoa3_tpu_torch.ops import farthest_points_sample
from geoa3_tpu_torch.utils.checkpoint import load_victim

BS = 32  # clouds a batch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Point Cloud Defense")
    # ------------Dataset-----------------------
    parser.add_argument(
        "--datadir", default="Data/modelnet40_1024_processed", type=str,
        metavar="DIR",
    )
    parser.add_argument("--npoint", default=1024, type=int)
    parser.add_argument("-c", "--classes", default=40, type=int, metavar="N")
    # ------------Model-----------------------
    parser.add_argument("--arch", default="PointNet", type=str, metavar="ARCH")
    parser.add_argument(
        "--defense_type",
        default="outliers_fixNum",
        type=str,
        help="[rand_drop, outliers_variance, outliers_fixNum]",
    )
    # ------------Defense-----------------------
    parser.add_argument("--outlier_knn", type=int, default=2)
    parser.add_argument("--alpha", type=float, default=1.1)
    parser.add_argument("--drop_num", type=int, default=128)
    parser.add_argument("--is_record_all", action="store_true", default=False)
    parser.add_argument("--is_record_wrong", action="store_true", default=False)
    # ------------OS-----------------------
    parser.add_argument("-j", "--num_workers", default=8, type=int, metavar="N")
    parser.add_argument("--random_seed", default=0, type=int)
    parser.add_argument("--print_freq", default=50, type=int)
    parser.add_argument(
        "--checkpoint", default=None, type=str,
        help="victim checkpoint (.pth.tar, a torch.save'd state_dict, or a "
        "directory holding one); defaults to Pretrained/{arch}/{npoint}/",
    )
    parser.add_argument(
        "--device", default="cuda", type=str,
        help="where the defense runs: cuda (default) or cpu",
    )
    return parser


def classify(model, arch: str, res: gdef.DefenseResult) -> torch.Tensor:
    """Logits of the defended clouds. PointNet takes the keep mask; the
    PointNet++ victims take the padded cloud as it is, whose padding is
    neutral through FPS and the ball query (defense.py)."""
    with torch.no_grad():
        if arch == "PointNet":
            return model(res.pc, point_mask=res.keep_mask)
        return model(res.pc)


def main(cfg) -> dict:
    assert cfg.datadir[-1] != "/"
    device = entry_device(cfg.device)
    # the reference's rule: seed 0 is kept, any other seed means the clock
    seed = cfg.random_seed if cfg.random_seed == 0 else int(time.time())
    generator = torch.Generator(device=device).manual_seed(seed)

    dataset = DefenseMatDataset(cfg.datadir)
    model, ckpt = load_victim(cfg.arch, cfg.classes, cfg.npoint,
                              cfg.checkpoint, device)
    print(f"\nSuccessfully load pretrained-model from {ckpt}\n")

    defensed_dir = os.path.join(os.path.split(cfg.datadir)[0], "Defensed")
    record = cfg.is_record_all or cfg.is_record_wrong
    if record:
        os.makedirs(defensed_dir, exist_ok=True)

    # batches of one point count; the clouds are loaded again a batch at a
    # time, and the defended clouds are kept only where an .obj dump needs
    # them
    labels, sizes = [], []
    for i in range(len(dataset)):
        adv_pc, gt_label, attack_label = dataset[i]
        labels.append((gt_label, attack_label))
        sizes.append(adv_pc.shape[0])

    results = {}
    for chunk in size_batches(sizes, BS):
        pcs = pad_batch([dataset[i][0] for i in chunk], BS)
        pc = torch.from_numpy(pcs).to(device)
        if pc.shape[1] > cfg.npoint:
            pc = farthest_points_sample(pc, cfg.npoint, generator)
        res = gdef.point_removal(
            pc, cfg.defense_type, cfg.drop_num, cfg.alpha,
            cfg.outlier_knn, generator=generator,
        )
        preds = classify(model, cfg.arch, res).argmax(-1).cpu().numpy()
        drops = res.num_dropped.cpu().numpy()
        defended = res.pc.cpu().numpy() if record else None
        keep_masks = (res.keep_mask.cpu().numpy()
                      if record and res.keep_mask is not None else None)
        for j, i in enumerate(chunk):
            results[i] = (
                int(preds[j]),
                int(drops[j]),
                defended[j] if record else None,
                keep_masks[j] if keep_masks is not None else None,
                *labels[i],
            )

    cnt = 0
    num_defense_success = 0
    num_attack_still_success = 0
    num_drop_point = 0
    for i in sorted(results):
        pred, num, saved_pc, keep_mask, gt_label, attack_label = results[i]
        cnt += 1
        if gt_label == attack_label:
            defense_success, attack_still_success = 1, 0
        else:
            defense_success = int(pred == gt_label)
            attack_still_success = int(pred == attack_label)
        num_defense_success += defense_success
        num_attack_still_success += attack_still_success
        num_drop_point += num

        if cfg.is_record_all or (cfg.is_record_wrong and pred != gt_label):
            out_pc = saved_pc if keep_mask is None else saved_pc[keep_mask]
            gio.save_point_obj(
                os.path.join(
                    defensed_dir,
                    f"Gt{gt_label}_record_{i}_attack{attack_label}"
                    f"_defensedGT{pred}.obj",
                ),
                out_pc,
            )

        if (i + 1) % cfg.print_freq == 0:
            print(
                "[{0}/{1}]  attack success: {2:.2f} still attack success: "
                "{3:.2f} avg drop num: {4:.2f}".format(
                    i + 1,
                    len(dataset),
                    (1 - num_defense_success / float(cnt)) * 100,
                    num_attack_still_success / float(cnt) * 100,
                    num_drop_point / float(cnt),
                )
            )

    n = float(len(dataset))
    final_acc = num_defense_success / n * 100
    final_attack_acc = num_attack_still_success / n * 100
    avg_drop_point = num_drop_point / n
    # the reference's sanity invariant (defense.py:135); the two sides can be
    # equal and differ by one float ULP
    assert 100 - final_acc >= final_attack_acc - 1e-9, (
        "Attack success must > or >= attack still success!"
    )
    print(
        "\nfinal attack success: {0:.2f}\n still attack success: {1:.2f}\n "
        "avg drop point: {2:.2f}".format(
            100 - final_acc, final_attack_acc, avg_drop_point
        )
    )

    result_path = os.path.join(os.path.split(cfg.datadir)[0], "defense_result.txt")
    with open(result_path, "at") as f:
        if cfg.defense_type == "rand_drop":
            f.write(
                "[{0:.2f}%, {1:.2f}%, {2:.2f}n] random drop: drop_num {3}\n".format(
                    final_acc, final_attack_acc, avg_drop_point, cfg.drop_num
                )
            )
        elif cfg.defense_type == "outliers_variance":
            f.write(
                "[{0:.2f}%, {1:.2f}%, {2:.2f}n] outlier alpha removal: "
                "k{3}, alpha{4}\n".format(
                    final_acc, final_attack_acc, avg_drop_point,
                    cfg.outlier_knn, cfg.alpha,
                )
            )
        elif cfg.defense_type == "outliers_fixNum":
            f.write(
                "[{0:.2f}%, {1:.2f}%, {2:.2f}n] outlier ramdom drop: "
                "drop_num {3}\n".format(
                    final_acc, final_attack_acc, avg_drop_point, cfg.drop_num
                )
            )
        else:
            raise AssertionError

    print("\n Finished!")
    return {
        "final_acc": final_acc,
        "final_attack_acc": final_attack_acc,
        "avg_drop_point": avg_drop_point,
    }


if __name__ == "__main__":
    cfg = build_parser().parse_args()
    print(cfg)
    main(cfg)
