"""geoa3_tpu_torch — the PyTorch/CUDA port of geoa3_tpu for an NVIDIA H100.

Geometry-Aware Generation of Adversarial Point Clouds (Wen et al., TPAMI
2020). The JAX package geoa3_tpu stays the reference; this package mirrors
its layout, imports no JAX and nothing of geoa3_tpu, and replaces each TPU
kernel on its path with a hand-written CUDA kernel (csrc/, built on first
use into build/kernels/).

Layout:
  ops/       point-cloud ops; ops/kernels/ holds the kernel wrappers, each
             with its plain PyTorch version (taken for CPU tensors)
  models/    the PointNet victim and weight converters
  losses.py  geometric losses
  defense.py point-removal defenses; measurement.py the smoothness metric
  attack/    the GeoA3 attack engine, projection, tangent jitter and the
             alpha-shape reconstruction
  data/      synthetic point clouds, .mat datasets, file writers,
             augmentations, the training-set reader, attack-set distillation
             (numpy)
  parallel/  data and tensor parallel over torch.distributed (one process
             per GPU): the sharded attack and the dp x tp train step
  utils/     experiment naming, meters, records, victim checkpoints, the
             FLOP model, profiling and the NaN guard
  cli/       the command lines (python -m geoa3_tpu_torch.cli.<name>):
             main_attack, main_train, readiness, defense, smoothness,
             gen_data_mat, resample_mat, save_ori_obj

Entry points run on the card (device="cuda") unless the caller passes
device="cpu".
"""

__version__ = "0.1.0"

from geoa3_tpu_torch.attack import AttackConfig, attack, make_attack_fn  # noqa: E402
from geoa3_tpu_torch.models import build_model, make_eval_fn  # noqa: E402
from geoa3_tpu_torch import defense, measurement  # noqa: E402

__all__ = [
    "AttackConfig",
    "attack",
    "make_attack_fn",
    "build_model",
    "make_eval_fn",
    "defense",
    "measurement",
]
