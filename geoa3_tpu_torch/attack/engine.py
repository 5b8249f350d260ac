"""The GeoA3 attack engine (port of geoa3_tpu/attack/engine.py).

The reference (Attacker/geoA3_attack.py:100-386) runs a binary search over
the C&W loss constant around an inner loop of Adam steps. This port keeps the
JAX engine's semantics, including its documented deviations
(geoa3_tpu/attack/engine.py:16-64):

  1. best-tracking uses the current step's constrain loss;
  2. the binary-search success test is per instance ("succeeded at least
     once in this search step");
  3. randomness is explicit: the initial offsets come from a caller's
     torch.Generator (or an `init_offset` hook);
  7. with curv_knn_refresh_every = K, the curvature loss's self-kNN mask is
     rebuilt from the current cloud at the start of every block of K steps
     and held inside the block. K = 1 rebuilds it every step, which is the
     reference's exact semantics: the selection carries no gradient, so
     "select then evaluate from the mask" equals the fused kappa of the JAX
     exact mode.

The loop runs eagerly on the device: best-tracking is torch.where and nothing
inside the loop reads a value back to the host. Adam is written in optax's
form (bias-corrected, eps outside the square root) so that trajectories track
the JAX engine's.

Modes outside the ported main path raise NotImplementedError (see
ROADMAP.md): projection (is_pro_grad), L-inf clipping (cc_linf), tangent
jitter, subsampling, partial-variable mode, the uniform loss, SGD, the LR
schedule, and the JAX engine's host_binary_loop / debug_callback
arguments.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from geoa3_tpu_torch import losses as L
from geoa3_tpu_torch import ops
from geoa3_tpu_torch.attack.config import AttackConfig

_INF = 1e10
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (JAX engine :281)


class AttackResult(NamedTuple):
    best_attack: torch.Tensor  # [b, n, 3]
    target: torch.Tensor  # [b]
    success: torch.Tensor  # [b] bool (best_loss < 1e10, reference :386)
    best_attack_step: torch.Tensor  # [b] int32
    best_attack_bs_idx: torch.Tensor  # [b] int32
    best_loss: torch.Tensor  # [b]
    all_loss: torch.Tensor  # [iter_max_steps, b]: last binary step's losses


class Aux(NamedTuple):
    logits: torch.Tensor
    loss_n: torch.Tensor
    cls_loss: torch.Tensor
    dis_loss: torch.Tensor
    hd_loss: torch.Tensor
    curv_loss: torch.Tensor
    constrain_loss: torch.Tensor


def _compare(output, target, gt, targeted: bool):
    """Success predicate (reference Lib/utility.py:151-155)."""
    return (output == target) if targeted else (output != gt)


def _cls_loss(logits: torch.Tensor, target: torch.Tensor, cfg: AttackConfig):
    """Margin / CE / None classification loss (reference geoA3_attack.py:105-127)."""
    targeted = cfg.targeted
    if cfg.cls_loss_type == "Margin":
        onehot = torch.nn.functional.one_hot(target.long(), cfg.classes).to(logits.dtype)
        fake = (onehot * logits).sum(dim=1)
        other = ((1.0 - onehot) * logits - onehot * 10000.0).amax(dim=1)
        if targeted:
            return torch.clamp_min(other - fake + cfg.confidence, 0.0)
        return torch.clamp_min(fake - other + cfg.confidence, 0.0)
    if cfg.cls_loss_type == "CE":
        ce = torch.logsumexp(logits, dim=1) - logits.gather(
            1, target.long()[:, None]
        )[:, 0]
        return ce if targeted else -ce
    if cfg.cls_loss_type == "None":
        return logits.new_zeros(logits.shape[0])
    raise ValueError("Not support such clssification loss")


def forward_losses(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    pc_ori: torch.Tensor,
    input_curr: torch.Tensor,
    normal_ori: torch.Tensor,
    kappa_ori: Optional[torch.Tensor],
    target: torch.Tensor,
    scale_const: torch.Tensor,
    cfg: AttackConfig,
    kappa_mask: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Aux]:
    """One loss evaluation (reference `_forward_step`, geoA3_attack.py:100-180).

    One dual 1-NN pass feeds Chamfer, Hausdorff and the curvature term's
    borrowed normals and ori kappa (payload copies). The curvature term reads
    the self-kNN selection `kappa_mask`; without one it is selected here from
    the current cloud (exact semantics).
    """
    if cfg.uniform_loss_weight != 0:
        raise NotImplementedError("uniform loss is not ported yet (ROADMAP.md)")
    b = input_curr.shape[0]
    logits = logits_fn(input_curr)
    cls_loss = _cls_loss(logits, target, cfg)

    zeros = input_curr.new_zeros(b)
    need_a2o = (
        cfg.dis_loss_type == "CD" or cfg.hd_loss_weight != 0
        or cfg.curv_loss_weight != 0
    )
    if need_a2o:
        rows = [pc_ori.detach().transpose(1, 2)]
        if cfg.curv_loss_weight != 0:
            rows += [normal_ori.detach().transpose(1, 2), kappa_ori.detach()[:, None]]
        pay = torch.cat(rows, dim=1)
        pay = torch.cat(
            [pay, pay.new_zeros(b, 8 - pay.shape[1], pay.shape[2])], dim=1
        ).contiguous()
        _, o2a_idx, gp, op = ops.nn1_dual_payload(input_curr, pc_ori, pay)
        d_a2o = (
            (input_curr[..., 0] - gp[:, 0]) ** 2
            + (input_curr[..., 1] - gp[:, 1]) ** 2
            + (input_curr[..., 2] - gp[:, 2]) ** 2
        )  # [b, n_adv]

    if cfg.dis_loss_type == "CD":
        if cfg.is_cd_single_side:
            dis_loss = d_a2o.mean(dim=-1)
        else:
            opg = ops.o2a_coord_planes(input_curr, o2a_idx, op)
            d_o2a = (
                (pc_ori[..., 0] - opg[:, 0]) ** 2
                + (pc_ori[..., 1] - opg[:, 1]) ** 2
                + (pc_ori[..., 2] - opg[:, 2]) ** 2
            )  # [b, n_ori]
            dis_loss = d_a2o.mean(dim=-1) + d_o2a.mean(dim=-1)
        constrain = cfg.dis_loss_weight * dis_loss
    elif cfg.dis_loss_type == "L2":
        if cfg.hd_loss_weight != 0:
            raise ValueError("L2 distance loss requires hd_loss_weight == 0")
        dis_loss = L.norm_l2_loss(input_curr, pc_ori)
        constrain = cfg.dis_loss_weight * dis_loss
    elif cfg.dis_loss_type == "None":
        dis_loss = zeros
        constrain = zeros
    else:
        raise ValueError("Not support such distance loss")

    if cfg.hd_loss_weight != 0:
        hd_loss = d_a2o.amax(dim=-1)
        constrain = constrain + cfg.hd_loss_weight * hd_loss
    else:
        hd_loss = zeros

    if cfg.curv_loss_weight != 0:
        k = cfg.curv_loss_knn
        if kappa_mask is None:
            kappa_mask = ops.kappa_select_mask(input_curr, k)
        normal = gp[:, 3:6].transpose(1, 2)  # borrowed from the nearest ori point
        curv_loss = ops.curv_term_from_mask(input_curr, normal, gp[:, 6], kappa_mask, k)
        constrain = constrain + cfg.curv_loss_weight * curv_loss
    else:
        curv_loss = zeros

    loss_n = cls_loss + scale_const * constrain
    aux = Aux(logits, loss_n, cls_loss, dis_loss, hd_loss, curv_loss, constrain)
    return loss_n.mean(), aux


def _check_supported(cfg: AttackConfig) -> None:
    unsupported = {
        "is_pro_grad": cfg.is_pro_grad,
        "cc_linf": cfg.cc_linf != 0,
        "is_pre_jitter_input": cfg.is_pre_jitter_input,
        "is_subsample_opt": cfg.is_subsample_opt,
        "is_partial_var": cfg.is_partial_var,
        "uniform_loss_weight": cfg.uniform_loss_weight != 0,
        "is_use_lr_scheduler": cfg.is_use_lr_scheduler,
        "optim=sgd": cfg.optim != "adam",
    }
    on = [name for name, flag in unsupported.items() if flag]
    if on:
        raise NotImplementedError(
            f"attack modes not ported yet: {', '.join(on)} (see ROADMAP.md)"
        )


def make_attack_fn(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: AttackConfig,
    init_offset: Optional[Callable[[int], torch.Tensor]] = None,
    host_binary_loop: bool = False,
    debug_callback: Optional[Callable] = None,
) -> Callable[..., AttackResult]:
    """Build the whole attack for a fixed config.

    `logits_fn(pc [b, n, 3]) -> [b, classes]` is the victim in eval mode. The
    returned function is

        attack_fn(pc_ori [b,n,3], normal_ori [b,n,3], gt_target [b],
                  target [b], generator) -> AttackResult

    and draws each binary step's initial offset 1e-3 * N(0, 1) from
    `generator` (a torch.Generator on the cloud's device), unless
    `init_offset(bs_idx) -> [b, n, 3]` is given, which then supplies them.
    """
    cfg = cfg.validate()
    _check_supported(cfg)
    if host_binary_loop or debug_callback is not None:
        raise NotImplementedError(
            "host_binary_loop and debug_callback are not ported yet "
            "(see ROADMAP.md)"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    targeted = cfg.targeted
    lr = cfg.lr
    curv = cfg.curv_loss_weight != 0
    K = cfg.curv_knn_refresh_every

    def run_inner(pc_ori, normal_ori, gt_target, target, kappa_ori, const,
                  bs_idx, offset, best):
        b = pc_ori.shape[0]
        best_loss, best_attack, best_step, best_bs = best
        mu = torch.zeros_like(offset)
        nu = torch.zeros_like(offset)
        it_loss = pc_ori.new_full((b,), _INF)
        it_score = torch.full((b,), -1, dtype=torch.int32, device=pc_ori.device)
        loss_ys = pc_ori.new_empty(cfg.iter_max_steps, b)
        mask = None
        for step in range(cfg.iter_max_steps):
            if curv and step % K == 0:
                # deviation #7: rebuilt from the stop-gradient cloud per block
                mask = ops.kappa_select_mask(pc_ori + offset, cfg.curv_loss_knn)
            off = offset.requires_grad_(True)
            input_all = pc_ori + off
            loss, aux = forward_losses(
                logits_fn, pc_ori, input_all, normal_ori, kappa_ori, target,
                const, cfg, kappa_mask=mask,
            )
            (grad,) = torch.autograd.grad(loss, off)
            input_all = input_all.detach()
            offset = off.detach()

            # best tracking (reference :288-310, deviation #1)
            output_label = aux.logits.detach().argmax(dim=-1)
            success = _compare(output_label, target, gt_target, targeted)
            metric = aux.constrain_loss.detach()
            better = success & (metric < best_loss)
            best_loss = torch.where(better, metric, best_loss)
            best_attack = torch.where(better[:, None, None], input_all, best_attack)
            best_step = torch.where(better, step, best_step)
            best_bs = torch.where(better, bs_idx, best_bs)
            it_better = success & (metric < it_loss)
            it_loss = torch.where(it_better, metric, it_loss)
            it_score = torch.where(it_better, output_label.to(torch.int32), it_score)

            # Adam, optax form
            count = step + 1
            mu = (1 - _B1) * grad + _B1 * mu
            nu = (1 - _B2) * (grad * grad) + _B2 * nu
            bc1 = float(1 - np.float32(_B1) ** np.float32(count))
            bc2 = float(1 - np.float32(_B2) ** np.float32(count))
            upd = (mu / bc1) / ((nu / bc2).sqrt() + _EPS)
            offset = offset + (-lr) * upd
            loss_ys[step] = aux.loss_n.detach()
        return (best_loss, best_attack, best_step, best_bs), it_score, loss_ys

    def attack_fn(pc_ori, normal_ori, gt_target, target, generator=None):
        b, n, _ = pc_ori.shape
        dev = pc_ori.device
        with torch.no_grad():
            kappa_ori = (
                L.get_kappa_ori(pc_ori, normal_ori, cfg.curv_loss_knn)
                if curv else pc_ori.new_zeros(b, n)
            )
        lower = pc_ori.new_zeros(b)
        upper = pc_ori.new_full((b,), _INF)
        const = pc_ori.new_full((b,), cfg.initial_const)
        best = (
            pc_ori.new_full((b,), _INF),
            torch.ones_like(pc_ori),  # reference :226
            torch.full((b,), -1, dtype=torch.int32, device=dev),
            torch.full((b,), -1, dtype=torch.int32, device=dev),
        )
        loss_ys = None
        for bs_idx in range(cfg.binary_max_steps):
            if init_offset is not None:
                offset0 = init_offset(bs_idx).to(device=dev, dtype=pc_ori.dtype)
                offset0 = offset0.detach().clone()
            else:
                offset0 = 1e-3 * torch.randn(
                    b, n, 3, generator=generator, device=dev, dtype=pc_ori.dtype
                )
            best, it_score, loss_ys = run_inner(
                pc_ori, normal_ori, gt_target, target, kappa_ori, const,
                bs_idx, offset0, best,
            )
            # C&W constant update (reference :374-384; deviation #2)
            success = it_score != -1
            new_lower = torch.where(success, torch.maximum(lower, const), lower)
            new_upper = torch.where(success, upper, torch.minimum(upper, const))
            mid = (new_lower + new_upper) * 0.5
            const_success = torch.where(new_upper < 1e9, mid, const * 2)
            const_fail = torch.where(new_upper < 1e9, mid, const)
            const = torch.where(success, const_success, const_fail)
            lower, upper = new_lower, new_upper
        best_loss, best_attack, best_step, best_bs = best
        return AttackResult(
            best_attack=best_attack,
            target=target,
            success=best_loss < _INF,
            best_attack_step=best_step,
            best_attack_bs_idx=best_bs,
            best_loss=best_loss,
            all_loss=loss_ys,
        )

    return attack_fn


def attack(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    pc_ori,
    normal_ori,
    gt_target,
    target,
    cfg: AttackConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> AttackResult:
    """One-shot entry (reference `attack`, geoA3_attack.py:182-386).

    pc_ori/normal_ori are channel-last [b, n, 3] (tensors or numpy arrays);
    gt_target/target are [b] int labels. For `Untarget`, pass
    target == gt_target. Runs on `device`.
    """

    def dev(x, dtype):
        return torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()

    fn = make_attack_fn(logits_fn, cfg)
    return fn(
        dev(pc_ori, torch.float32),
        dev(normal_ori, torch.float32),
        dev(gt_target, torch.int64),
        dev(target, torch.int64),
        generator,
    )
