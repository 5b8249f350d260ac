"""Attack configuration — the reference's argparse surface as a frozen dataclass.

A copy of geoa3_tpu/attack/config.py (the port imports nothing of the JAX
package). Field names and defaults mirror the public flags of reference
main_attack.py:317-385.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    # ---- model / data ----
    arch: str = "PointNet"
    classes: int = 40
    npoint: int = 1024
    # ---- attack schedule ----
    attack_label: str = "All"  # All | <class name> | Untarget | Random
    initial_const: float = 10.0
    lr: float = 0.01
    optim: str = "adam"  # adam | sgd
    binary_max_steps: int = 10
    iter_max_steps: int = 500
    eval_num: int = 1
    # ---- classification loss ----
    cls_loss_type: str = "CE"  # Margin | CE | None
    confidence: float = 0.0
    # ---- distance loss ----
    dis_loss_type: str = "CD"  # CD | L2 | None
    dis_loss_weight: float = 1.0
    is_cd_single_side: bool = False
    # ---- hausdorff / curvature / uniform ----
    hd_loss_weight: float = 0.1
    curv_loss_weight: float = 1.0
    curv_loss_knn: int = 16
    # perf option (1 = exact reference semantics): recompute the adv
    # self-kNN indices every N steps instead of every step. Points move
    # ~lr per step, so neighbourhoods are stable over a few steps; neighbour
    # COORDS are always gathered from the CURRENT cloud — only the index set
    # may be up to N-1 steps stale.
    curv_knn_refresh_every: int = 1
    uniform_loss_weight: float = 0.0
    # ---- optimisation variants ----
    is_use_lr_scheduler: bool = False
    lr_gamma: float = 0.9990  # ExponentialLR gamma (reference geoA3_attack.py:275)
    is_partial_var: bool = False
    knn_range: int = 3
    partial_reinit_every: int = 50  # reference geoA3_attack.py:240 (step%50)
    is_subsample_opt: bool = False
    # ---- projection / clipping ----
    is_pro_grad: bool = False
    is_real_offset: bool = False
    cc_linf: float = 0.0
    # ---- tangent-plane jitter ----
    is_pre_jitter_input: bool = False
    # naming-only in the reference: switches the dirname suffix to
    # _PreviousMethod (main_attack.py:73-74); the engine never reads it
    # (get_perpendicular_jitter is dead code upstream too)
    is_previous_jitter_input: bool = False
    calculate_project_jitter_noise_iter: int = 50
    jitter_k: int = 16
    jitter_sigma: float = 0.01
    jitter_clip: float = 0.05

    @property
    def targeted(self) -> bool:
        """Untarget is the only untargeted mode (reference geoA3_attack.py:189-192)."""
        return self.attack_label != "Untarget"

    def validate(self) -> "AttackConfig":
        assert self.cls_loss_type in ("Margin", "CE", "None"), (
            "Not support such clssification loss"
        )
        assert self.dis_loss_type in ("CD", "L2", "None"), (
            "Not support such distance loss"
        )
        if self.dis_loss_type == "L2":
            assert self.hd_loss_weight == 0
        assert self.optim in ("adam", "sgd"), "Not support such optimizer."
        if self.curv_knn_refresh_every > 1:
            assert self.iter_max_steps % self.curv_knn_refresh_every == 0, (
                "iter_max_steps must be a multiple of curv_knn_refresh_every "
                "(the refresh is a nested scan over blocks of that length)"
            )
        return self
