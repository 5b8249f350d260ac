"""Numpy-only data providers of the port (counterpart of geoa3_tpu/data)."""

from geoa3_tpu_torch.data import augment, io
from geoa3_tpu_torch.data.modelnet import (
    TEN_LABEL_INDEXES,
    TEN_LABEL_NAMES,
    AttackSetDataset,
    DefenseMatDataset,
    PureMatDataset,
    batched,
)
from geoa3_tpu_torch.data.synthetic import (
    SYNTHETIC_CLASS_NAMES,
    make_synthetic_attack_set,
    sample_shape,
)

__all__ = [
    "TEN_LABEL_INDEXES",
    "TEN_LABEL_NAMES",
    "AttackSetDataset",
    "DefenseMatDataset",
    "PureMatDataset",
    "batched",
    "SYNTHETIC_CLASS_NAMES",
    "make_synthetic_attack_set",
    "sample_shape",
    "augment",
    "io",
]
