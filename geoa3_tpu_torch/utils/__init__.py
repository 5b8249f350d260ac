"""Shared utilities of the port: meters, experiment naming, records, victim
checkpoints."""

from geoa3_tpu_torch.utils.checkpoint import load_victim, load_victim_state
from geoa3_tpu_torch.utils.meters import AverageMeter, StepTimer, format_time, natural_sort
from geoa3_tpu_torch.utils.naming import attack_exp_dirname, make_output_dirs
from geoa3_tpu_torch.utils.records import ConvergeIterRecorder, LossIterRecorder

__all__ = [
    "AverageMeter",
    "StepTimer",
    "format_time",
    "natural_sort",
    "attack_exp_dirname",
    "make_output_dirs",
    "ConvergeIterRecorder",
    "LossIterRecorder",
    "load_victim",
    "load_victim_state",
]
