"""The GeoA3 attack engine of the port."""

from geoa3_tpu_torch.attack.config import AttackConfig
from geoa3_tpu_torch.attack.engine import (
    AttackResult,
    attack,
    forward_losses,
    make_attack_fn,
)

__all__ = [
    "AttackConfig",
    "AttackResult",
    "attack",
    "forward_losses",
    "make_attack_fn",
]
