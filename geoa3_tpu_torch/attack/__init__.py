"""The GeoA3 attack engine of the port."""

from geoa3_tpu_torch.attack.config import AttackConfig
from geoa3_tpu_torch.attack.engine import (
    AttackResult,
    attack,
    forward_losses,
    make_attack_fn,
)
from geoa3_tpu_torch.attack.reconstruct import (
    alpha_shape_mesh,
    resample_reconstruct_from_pc,
)
from geoa3_tpu_torch.attack.project import (
    estimate_normal,
    estimate_normal_via_ori_normal,
    estimate_perpendicular,
    find_offset,
    get_perpendicular_jitter,
    jitter_input,
    lp_clip,
    offset_proj,
)

__all__ = [
    "AttackConfig",
    "AttackResult",
    "attack",
    "forward_losses",
    "make_attack_fn",
    "offset_proj",
    "find_offset",
    "lp_clip",
    "estimate_perpendicular",
    "estimate_normal",
    "estimate_normal_via_ori_normal",
    "get_perpendicular_jitter",
    "jitter_input",
    "alpha_shape_mesh",
    "resample_reconstruct_from_pc",
]
