"""Experiment-directory naming contract (the port's own copy of
geoa3_tpu/utils/naming.py).

The reference serialises the attack config into the experiment dir name and
the defense CLI consumes those paths, so the scheme is public API
(reference main_attack.py:36-96). Reproduced byte-for-byte, e.g.

  Exps/PointNet_npoint1024/All/GeoA3_0_BiStep10_IterStep500_Optadam_Lr0.01_
  Initcons10.0_CE_CDLoss1.0_HDLoss0.1_CurLoss1.0_k16/{PC,Mat,Records}
"""

from __future__ import annotations

import os

from geoa3_tpu_torch.attack.config import AttackConfig


def attack_exp_dirname(
    cfg: AttackConfig,
    attack: str = "GeoA3",
    run_id: int = 0,
    exps_root: str = "Exps",
) -> str:
    """Build the saved_dir path (reference main_attack.py:36-83)."""
    saved_root = os.path.join(exps_root, f"{cfg.arch}_npoint{cfg.npoint}")

    if attack in ("GeoA3", "GeoA3_mesh"):
        name = (
            f"{attack}_{run_id}_BiStep{cfg.binary_max_steps}"
            f"_IterStep{cfg.iter_max_steps}_Opt{cfg.optim}_Lr{cfg.lr}"
            f"_Initcons{cfg.initial_const}_{cfg.cls_loss_type}"
            f"_{cfg.dis_loss_type}Loss{cfg.dis_loss_weight}"
        )
        if cfg.hd_loss_weight != 0:
            name += f"_HDLoss{cfg.hd_loss_weight}"
        if cfg.curv_loss_weight != 0:
            name += f"_CurLoss{cfg.curv_loss_weight}_k{cfg.curv_loss_knn}"
        if cfg.uniform_loss_weight != 0:
            name += f"_UniLoss{cfg.uniform_loss_weight}"
        if cfg.is_partial_var:
            name += f"_PartOpt_k{cfg.knn_range}"
        if cfg.is_use_lr_scheduler:
            name += "_LRExp"
        if cfg.is_pro_grad:
            name += "_ProGrad"
            if cfg.is_real_offset:
                name += "RO"
        if cfg.cc_linf != 0:
            name += f"_cclinf{cfg.cc_linf}"
        if cfg.is_pre_jitter_input:
            name += f"_PreJitter{cfg.jitter_sigma}_{cfg.jitter_clip}"
            if cfg.is_previous_jitter_input:
                name += "_PreviousMethod"
            else:
                name += f"_estNormalVery{cfg.calculate_project_jitter_noise_iter}"
    else:
        assert attack is None
        name = f"Evaluating_{run_id}"

    return os.path.join(saved_root, cfg.attack_label, name)


def make_output_dirs(saved_dir: str, mesh: bool = False) -> None:
    """Create the PC/Mat/Records layout (reference main_attack.py:85-96)."""
    for sub in (("Mesh" if mesh else "PC"), "Mat", "Records", "Obj"):
        os.makedirs(os.path.join(saved_dir, sub), exist_ok=True)
