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
inside the loop reads a value back to the host. The optimisers are written in
optax's form (Adam bias-corrected with eps outside the square root, SGD with
a trace, the exponential schedule counted from 0) so that trajectories track
the JAX engine's.

Side modes (reference geoA3_attack.py:239-352), all on the same loop:
projection onto the original normals and per-point clipping after the update;
the tangent jitter, refreshed every `calculate_project_jitter_noise_iter`
steps and added without gradient, with a second clean forward for the success
test; `eval_logits_fn`; partial-variable mode (`run_partial`); the
debug callback after each search step; the uniform loss.

Subsample mode (`is_subsample_opt`, for clouds of more than `npoint` points;
reference :283-295): every step the moved cloud is resampled to `npoint`
points by random-start farthest-point sampling, the loss sees the resampled
cloud (the gradient reaches the whole cloud through the gather), the tangent
jitter is estimated from the same resampling, and success is an
`eval_num`-fold resampling vote (`_ensemble_eval`). The point set changes
every step, so no selection mask is held: the curvature term selects on the
step's own cloud (`ops.knn_kappa`), whatever `curv_knn_refresh_every` says.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from geoa3_tpu_torch import losses as L
from geoa3_tpu_torch import ops
from geoa3_tpu_torch.attack.config import AttackConfig
from geoa3_tpu_torch.attack.project import (
    estimate_perpendicular,
    find_offset,
    lp_clip,
    offset_proj,
    perpendicular_gauss,
)
from geoa3_tpu_torch.device import float32_exact
from geoa3_tpu_torch.ops.sampling import random_start

_INF = 1e10
_B1, _B2, _EPS = 0.9, 0.999, 1e-8  # optax.adam defaults (JAX engine :281)
_MOMENTUM = 0.9  # SGD in partial-variable mode (reference :252-253)


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
    loss_batch: Optional[int] = None,
) -> tuple[torch.Tensor, Aux]:
    """One loss evaluation (reference `_forward_step`, geoA3_attack.py:100-180).

    The loss is the mean of `loss_n` over the batch, or, with `loss_batch`,
    its sum over these rows divided by `loss_batch`: a data-parallel rank's
    share of the global batch's mean (parallel/mesh.py).

    One dual 1-NN pass feeds Chamfer, Hausdorff and the curvature term's
    borrowed normals and ori kappa (payload copies). With a self-kNN
    selection `kappa_mask` the curvature term and its gradient come from the
    mask in one kernel; without one, kappa is selected and computed from the
    current cloud by the differentiable `ops.knn_kappa` (the JAX engine's
    no-mask branch, :251-258).
    """
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
        normal = gp[:, 3:6].transpose(1, 2)  # borrowed from the nearest ori point
        if kappa_mask is not None:
            curv_loss = ops.curv_term_from_mask(
                input_curr, normal, gp[:, 6], kappa_mask, k
            )
        else:
            adv_kappa = ops.knn_kappa(input_curr, normal, k)
            curv_loss = ((adv_kappa - gp[:, 6]) ** 2).mean(dim=-1)
        constrain = constrain + cfg.curv_loss_weight * curv_loss
    else:
        curv_loss = zeros

    if cfg.uniform_loss_weight != 0:
        constrain = constrain + cfg.uniform_loss_weight * L.uniform_loss(input_curr)

    loss_n = cls_loss + scale_const * constrain
    aux = Aux(logits, loss_n, cls_loss, dis_loss, hd_loss, curv_loss, constrain)
    loss = loss_n.mean() if loss_batch is None else loss_n.sum() / loss_batch
    return loss, aux


def _ensemble_eval(logits_fn, input_all, target, gt_target, cfg: AttackConfig,
                   starts: torch.Tensor):
    """Resampling vote for oversized clouds (reference :290-295): `eval_num`
    random-start FPS resamplings of each cloud, from `starts` [eval_num, b],
    go through the victim in one batch -> (success [b]: more than half of the
    votes succeed; output_label [b]: the modal prediction, lowest class on
    ties)."""
    e, b = starts.shape
    with torch.no_grad():
        pcs = ops.farthest_points_sample(
            input_all.repeat(e, 1, 1), cfg.npoint, start=starts.reshape(-1)
        )  # [e * b, npoint, 3]
        preds = logits_fn(pcs).reshape(e, b, -1).argmax(dim=-1)  # [e, b]
    succ = _compare(preds, target[None], gt_target[None], cfg.targeted)
    success = succ.sum(dim=0) > 0.5 * e
    counts = torch.nn.functional.one_hot(preds, cfg.classes).sum(dim=0)
    return success, counts.argmax(dim=-1)


class _Optimizer:
    """Adam or SGD with an optional exponential LR decay (reference
    :264-277), in optax's form: the schedule lr * gamma^count counts from 0,
    Adam is bias-corrected with eps outside the root, SGD keeps a trace
    (momentum 0.9) only in partial-variable mode."""

    def __init__(self, cfg: AttackConfig):
        self.cfg = cfg
        self.momentum = _MOMENTUM if cfg.is_partial_var else None

    def init(self, x: torch.Tensor) -> dict:
        state = {"count": 0}
        if self.cfg.optim == "adam":
            state["mu"] = torch.zeros_like(x)
            state["nu"] = torch.zeros_like(x)
        elif self.momentum is not None:
            state["trace"] = torch.zeros_like(x)
        return state

    def update(self, grad: torch.Tensor, state: dict) -> torch.Tensor:
        """The update to add to the variable; advances `state` in place."""
        cfg = self.cfg
        count = state["count"]
        lr = cfg.lr
        if cfg.is_use_lr_scheduler:
            lr = float(np.float32(cfg.lr)
                       * np.float32(cfg.lr_gamma) ** np.float32(count))
        if cfg.optim == "adam":
            state["mu"] = (1 - _B1) * grad + _B1 * state["mu"]
            state["nu"] = (1 - _B2) * (grad * grad) + _B2 * state["nu"]
            bc1 = float(1 - np.float32(_B1) ** np.float32(count + 1))
            bc2 = float(1 - np.float32(_B2) ** np.float32(count + 1))
            direction = (state["mu"] / bc1) / ((state["nu"] / bc2).sqrt() + _EPS)
        elif self.momentum is not None:
            state["trace"] = grad + self.momentum * state["trace"]
            direction = state["trace"]
        else:
            direction = grad
        state["count"] = count + 1
        return (-lr) * direction


class _Best:
    """Best-tracking state across the whole attack (reference :288-310,
    deviation #1) and, per search step, the "succeeded at least once"
    record that drives the C&W constant (deviation #2)."""

    def __init__(self, pc_ori: torch.Tensor):
        b, dev = pc_ori.shape[0], pc_ori.device
        self.loss = pc_ori.new_full((b,), _INF)
        self.attack = torch.ones_like(pc_ori)  # reference :226
        self.step = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.bs_idx = torch.full((b,), -1, dtype=torch.int32, device=dev)
        self.start_search_step()

    def start_search_step(self) -> None:
        self.it_loss = torch.full_like(self.loss, _INF)
        self.it_score = torch.full_like(self.step, -1)

    def track(self, success, metric, output_label, input_all, step, bs_idx):
        better = success & (metric < self.loss)
        self.loss = torch.where(better, metric, self.loss)
        self.attack = torch.where(better[:, None, None], input_all, self.attack)
        self.step = torch.where(better, step, self.step)
        self.bs_idx = torch.where(better, bs_idx, self.bs_idx)
        it_better = success & (metric < self.it_loss)
        self.it_loss = torch.where(it_better, metric, self.it_loss)
        self.it_score = torch.where(
            it_better, output_label.to(torch.int32), self.it_score
        )


class _Search:
    """The C&W binary search over the loss constant (reference :374-384)."""

    def __init__(self, pc_ori: torch.Tensor, cfg: AttackConfig):
        b = pc_ori.shape[0]
        self.lower = pc_ori.new_zeros(b)
        self.upper = pc_ori.new_full((b,), _INF)
        self.const = pc_ori.new_full((b,), cfg.initial_const)

    def update(self, it_score: torch.Tensor) -> None:
        success = it_score != -1
        const = self.const
        lower = torch.where(success, torch.maximum(self.lower, const), self.lower)
        upper = torch.where(success, self.upper, torch.minimum(self.upper, const))
        mid = (lower + upper) * 0.5
        const_success = torch.where(upper < 1e9, mid, const * 2)
        const_fail = torch.where(upper < 1e9, mid, const)
        self.const = torch.where(success, const_success, const_fail)
        self.lower, self.upper = lower, upper


def make_attack_fn(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    cfg: AttackConfig,
    init_offset: Optional[Callable[[int], torch.Tensor]] = None,
    host_binary_loop: bool = False,
    eval_logits_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    debug_callback: Optional[Callable] = None,
    draws=None,
    shard: Optional[tuple[int, int]] = None,
) -> Callable[..., AttackResult]:
    """Build the whole attack for a fixed config.

    `logits_fn(pc [b, n, 3]) -> [b, classes]` is the victim in eval mode. The
    returned function is

        attack_fn(pc_ori [b,n,3], normal_ori [b,n,3], gt_target [b],
                  target [b], generator) -> AttackResult

    and draws its random numbers from `generator` (a torch.Generator on the
    cloud's device): each search step's initial offset 1e-3 * N(0, 1), the
    tangent jitter's gaussians, and in partial-variable mode each phase's
    seed point and initial patch offset, and in subsample mode each step's
    FPS start indices (one set for the loss and the jitter, `eval_num` sets
    for the vote).

    `init_offset(bs_idx) -> [b, n, 3]` supplies the initial offsets instead.
    `draws` supplies the side modes' numbers instead (tests replay another
    engine's): an object with `jitter_gauss(bs_idx, step, cloud) -> two
    [b, n, 1] standard normal draws` (the cloud is the one whose tangent
    planes they will scale), `patch_seed(bs_idx, phase) -> int` and
    `patch_offset(bs_idx, phase) -> [b, knn_range, 3]`; in subsample mode
    also `fps_start(bs_idx, step) -> [b]` and `eval_starts(bs_idx, step) ->
    [eval_num, b]` start indices.

    `eval_logits_fn` replaces `logits_fn` for the success test and
    best-tracking only; the gradient pass keeps `logits_fn`.

    `shard=(index, size)` makes this one of `size` data-parallel ranks
    (parallel.make_sharded_attack_fn): it is given rank `index`'s b rows of a
    global batch of size * b. It draws every random number above at the
    global shape, at the same sites and in the same order, and keeps its
    rows; its loss is its rows' sum over the global batch. Its result is
    then its rows of the one-process attack's at the same seed. `init_offset`
    and `draws` give this rank's rows.

    The binary search is always driven from the host here, so
    `host_binary_loop=True` changes nothing; `debug_callback(bs_idx,
    best_attack, loss_ys)` is called after each search step and, as in the
    JAX engine, needs `host_binary_loop=True` and is refused in
    partial-variable mode.
    """
    cfg = cfg.validate()
    if debug_callback is not None and (not host_binary_loop or cfg.is_partial_var):
        raise ValueError(
            "debug_callback (--is_debug) requires host_binary_loop=True "
            "and is not supported in partial-var mode"
        )
    if cfg.is_partial_var and cfg.iter_max_steps % cfg.partial_reinit_every:
        raise ValueError(
            "iter_max_steps must be a multiple of partial_reinit_every in "
            "partial-var mode"
        )
    float32_exact()
    targeted = cfg.targeted
    curv = cfg.curv_loss_weight != 0
    K = cfg.curv_knn_refresh_every
    # the jitter belongs to the main loop; partial-variable mode has none
    jitter_on = cfg.is_pre_jitter_input and not cfg.is_partial_var
    separate_eval = eval_logits_fn is not None
    tx = _Optimizer(cfg)
    index, size = shard or (0, 1)

    def own(x: torch.Tensor, b: int, dim: int = 0) -> torch.Tensor:
        """This rank's b rows of a draw at the global batch's shape."""
        return x if shard is None else x.narrow(dim, index * b, b)

    def judge(aux, input_all, gt_target, target, eval_starts=None):
        """(success [b], predicted label [b]) for best-tracking: from the
        gradient pass's logits; from a clean forward through the eval victim
        where that pass saw jitter or another victim; from the resampling
        vote in subsample mode (`eval_starts` given)."""
        if eval_starts is not None:
            return _ensemble_eval(eval_logits_fn or logits_fn, input_all,
                                  target, gt_target, cfg, eval_starts)
        if jitter_on or separate_eval:
            with torch.no_grad():
                logits = (eval_logits_fn or logits_fn)(input_all)
        else:
            logits = aux.logits.detach()
        label = logits.argmax(dim=-1)
        return _compare(label, target, gt_target, targeted), label

    def run_inner(pc_ori, normal_ori, gt_target, target, kappa_ori, const,
                  bs_idx, offset, best, generator):
        b, n, _ = pc_ori.shape
        B = b * size
        loss_batch = None if shard is None else B
        dev = pc_ori.device
        subsample = cfg.is_subsample_opt and n > cfg.npoint
        opt_state = tx.init(offset)
        loss_ys = pc_ori.new_empty(cfg.iter_max_steps, b)
        mask = None
        jitter = None
        fps_start = eval_starts = None
        for step in range(cfg.iter_max_steps):
            if subsample:
                # one draw for the jitter's source and the loss, so that both
                # see the same point set (JAX engine :424-429)
                if draws is not None:
                    fps_start = torch.as_tensor(
                        draws.fps_start(bs_idx, step)).to(dev, torch.int32)
                    eval_starts = torch.as_tensor(
                        draws.eval_starts(bs_idx, step)).to(dev, torch.int32)
                else:
                    fps_start = own(random_start(B, n, generator, dev), b)
                    eval_starts = own(random_start(
                        cfg.eval_num * B, n, generator, dev
                    ).reshape(cfg.eval_num, B), b, dim=1)
            if jitter_on and step % cfg.calculate_project_jitter_noise_iter == 0:
                # from the current cloud, held until the next refresh
                # (reference :312-317)
                cloud = pc_ori + offset
                if subsample:
                    cloud = ops.farthest_points_sample(
                        cloud, cfg.npoint, start=fps_start)
                jitter = estimate_perpendicular(
                    generator, cloud, cfg.jitter_k, cfg.jitter_sigma,
                    cfg.jitter_clip,
                    gauss=draws.jitter_gauss(bs_idx, step, cloud) if draws else
                    tuple(own(g, b) for g in perpendicular_gauss(
                        generator, B, cloud.shape[1], cloud)),
                )
            if curv and not subsample and step % K == 0:
                # deviation #7: rebuilt from the stop-gradient cloud per
                # block; in exact mode (K = 1) from the cloud the loss sees
                seen = pc_ori + offset
                if jitter_on and K == 1:
                    seen = seen + jitter
                mask = ops.kappa_select_mask(seen, cfg.curv_loss_knn)
            off = offset.requires_grad_(True)
            input_all = pc_ori + off
            input_curr = input_all
            if subsample:
                input_curr = ops.farthest_points_sample(
                    input_all, cfg.npoint, start=fps_start)
            if jitter_on:
                input_curr = input_curr + jitter
            loss, aux = forward_losses(
                logits_fn, pc_ori, input_curr, normal_ori, kappa_ori, target,
                const, cfg, kappa_mask=mask, loss_batch=loss_batch,
            )
            (grad,) = torch.autograd.grad(loss, off)
            input_all = input_all.detach()
            offset = off.detach()

            success, output_label = judge(aux, input_all, gt_target, target,
                                          eval_starts)
            best.track(success, aux.constrain_loss.detach(), output_label,
                       input_all, step, bs_idx)

            offset = offset + tx.update(grad, opt_state)
            # projections (reference :341-352)
            if cfg.is_pro_grad:
                if cfg.is_real_offset:
                    offset = find_offset(pc_ori, pc_ori + offset)
                offset = offset_proj(offset, pc_ori, normal_ori)
            if cfg.cc_linf != 0:
                offset = lp_clip(offset, cfg.cc_linf)
            loss_ys[step] = aux.loss_n.detach()
        return loss_ys

    def run_partial(pc_ori, normal_ori, gt_target, target, kappa_ori, const,
                    bs_idx, best, generator):
        """One search step of partial-variable mode (reference :239-262,
        :279-281): the variables are the offsets of a kNN patch around one
        random seed point (the same index for the whole batch, :243), re-picked
        every `partial_reinit_every` steps; each phase starts from the last
        pre-update cloud of the one before (:259-262). The reference's
        projection and clip writes are dead in this mode, so they are not
        applied."""
        b, n, _ = pc_ori.shape
        B = b * size
        loss_batch = None if shard is None else B
        dev = pc_ori.device
        kr, reinit = cfg.knn_range, cfg.partial_reinit_every
        loss_ys = pc_ori.new_empty(cfg.iter_max_steps, b)
        periodical_pc = pc_ori
        for phase in range(cfg.iter_max_steps // reinit):
            if draws is not None:
                seed_idx = torch.tensor([int(draws.patch_seed(bs_idx, phase))],
                                        device=dev)
            else:
                seed_idx = torch.randint(n, (1,), generator=generator,
                                         device=dev)
            q = pc_ori.index_select(1, seed_idx)  # [b, 1, 3]
            nbr_idx = ops.knn_points(q, pc_ori, kr + 1).idx[:, 0, 1:]  # [b, kr]
            rows = nbr_idx.long()[..., None].expand(-1, -1, 3)
            if draws is not None:
                part = draws.patch_offset(bs_idx, phase).to(
                    device=dev, dtype=pc_ori.dtype).detach().clone()
            else:
                part = own(1e-3 * torch.randn(B, kr, 3, generator=generator,
                                               device=dev, dtype=pc_ori.dtype), b)
            opt_state = tx.init(part)
            for i in range(reinit):
                step = phase * reinit + i
                part = part.requires_grad_(True)
                input_all = periodical_pc + torch.zeros_like(pc_ori).scatter(
                    1, rows, part)
                loss, aux = forward_losses(
                    logits_fn, pc_ori, input_all, normal_ori, kappa_ori,
                    target, const, cfg, loss_batch=loss_batch,
                )
                (grad,) = torch.autograd.grad(loss, part)
                input_all = input_all.detach()
                part = part.detach()
                success, output_label = judge(aux, input_all, gt_target, target)
                best.track(success, aux.constrain_loss.detach(), output_label,
                           input_all, step, bs_idx)
                part = part + tx.update(grad, opt_state)
                loss_ys[step] = aux.loss_n.detach()
            periodical_pc = input_all
        return loss_ys

    def attack_fn(pc_ori, normal_ori, gt_target, target, generator=None):
        b, n, _ = pc_ori.shape
        dev = pc_ori.device
        with torch.no_grad():
            kappa_ori = (
                L.get_kappa_ori(pc_ori, normal_ori, cfg.curv_loss_knn)
                if curv else pc_ori.new_zeros(b, n)
            )
        search = _Search(pc_ori, cfg)
        best = _Best(pc_ori)
        loss_ys = None
        for bs_idx in range(cfg.binary_max_steps):
            best.start_search_step()
            if cfg.is_partial_var:
                loss_ys = run_partial(
                    pc_ori, normal_ori, gt_target, target, kappa_ori,
                    search.const, bs_idx, best, generator,
                )
            else:
                if init_offset is not None:
                    offset0 = init_offset(bs_idx).to(device=dev, dtype=pc_ori.dtype)
                    offset0 = offset0.detach().clone()
                else:
                    offset0 = own(1e-3 * torch.randn(
                        b * size, n, 3, generator=generator, device=dev,
                        dtype=pc_ori.dtype,
                    ), b)
                loss_ys = run_inner(
                    pc_ori, normal_ori, gt_target, target, kappa_ori,
                    search.const, bs_idx, offset0, best, generator,
                )
            search.update(best.it_score)
            if debug_callback is not None:
                debug_callback(bs_idx, best.attack, loss_ys)
        return AttackResult(
            best_attack=best.attack,
            target=target,
            success=best.loss < _INF,
            best_attack_step=best.step,
            best_attack_bs_idx=best.bs_idx,
            best_loss=best.loss,
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
