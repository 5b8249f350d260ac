"""Victim training loop (port of geoa3_tpu/train.py; reference main_train.py).

One train step is the victim's train-mode forward, label-smoothing cross
entropy, PointNet's T-Net orthogonality penalty, the backward and one step
of torch-style Adam with L2, on channel-last batches from the reference's
batch-iterator protocol. Parity pieces (reference main_train.py):
  * label smoothing 0.2 (:86-105);
  * PointNet's orthogonality penalty 0.001 * sum((T T^t - I)^2) / 2 over the
    whole batch (:219-223);
  * Adam lr 1e-3 with L2 weight decay 1e-4 on every parameter (:159-164):
    `torch.optim.Adam(weight_decay=wd)` is optax's `add_decayed_weights` +
    `adam` (the decay added to the gradient before the moments, eps outside
    the root); the step count carries across epochs, as optax's state does;
  * lr x0.7 every 20 epochs, floor 1e-5, set at each epoch (:112-116, 245);
  * BatchNorm momentum 0.5 * 0.5^(epoch // 20), floor 0.01 (PointNet.py:
    166-179, PointNetPP_ssg.py:18-44, 126-132), set on every BatchNorm
    module in torch's convention; the train-mode BatchNorm moves the running
    statistics by flax's rule with the biased batch variance
    (models/layers.py);
  * the y/z axis swap [0, 2, 1] on inputs (:211, 279);
  * per-class and instance accuracy, the best-checkpoint rule (:311-339).

Randomness comes from one seeded `torch.Generator` on the training device:
the initial weights (flax's initialisers, as the JAX package's `init_state`
draws them) and every dropout mask. The datasets shuffle with their own
seeded numpy state, as in the JAX package.

The epoch's evaluation runs the eval-mode victim on the device with its
kernels. The JAX package pins its composed path there
(geoa3_tpu/train.py:168-198, ops/dispatch.py); the port has one path, and
its eval forward on the card is deterministic (two forwards are bit-equal,
which chip_smoke.py checks), so the best-checkpoint choice cannot move
between runs.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geoa3_tpu_torch.models.pointnet import TransformNet
from geoa3_tpu_torch.models.registry import build_model
from geoa3_tpu_torch.utils.meters import AverageMeter, format_time


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    arch: str = "PointNet"
    classes: int = 40
    npoint: int = 1024
    batch_size: int = 32
    epochs: int = 250
    lr: float = 1e-3
    decay_epochs: int = 20  # lr x0.7 every N epochs (reference :112-116)
    bn_momentum: float = 0.5  # torch-convention starting momentum (:51)
    wd: float = 1e-4
    label_smoothing: float = 0.2
    is_aug_data: bool = False
    seed: int = 0
    axis_swap: bool = True  # the reference's [0, 2, 1] input convention
    use_tensorboard: bool = False  # reference --is_use_tb (main_train.py:56)
    # retry a failed epoch from the last good host-side copy of the state
    # this many times before giving up (beyond the reference, which only
    # has --resume)
    max_epoch_retries: int = 3
    device: str = "cuda"


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimiser and
    the steps taken (the JAX TrainState's params, batch_stats, opt_state,
    step)."""

    model: nn.Module
    optimizer: torch.optim.Adam
    step: int = 0


def smoothing_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                            classes: int, smoothing: float = 0.2) -> torch.Tensor:
    """Label-smoothing CE (reference main_train.py:86-105): the mean over
    the batch of -sum((onehot (1 - s) + s / classes) log_softmax)."""
    if logits.shape[1] != classes:
        raise ValueError(f"logits have {logits.shape[1]} classes, not {classes}")
    return F.cross_entropy(logits, target.long(), label_smoothing=smoothing)


def lr_for_epoch(base_lr: float, epoch: int, decay_epochs: int = 20) -> float:
    """LR after `epoch` completed epochs (reference :112-116; floor 1e-5)."""
    return max(1e-5, base_lr * (0.7 ** (epoch // decay_epochs)))


def bn_momentum_for_epoch(base: float, epoch: int) -> float:
    """Torch-convention BN momentum for an epoch (reference PointNet.py:166-169,
    PointNetPP_ssg.py:126-131; floors differ: 0.01 both here)."""
    return max(base * (0.5 ** (epoch // 20)), 0.01)


def make_optimizer(cfg: TrainConfig, model: nn.Module, epoch: int = 1):
    """Torch-style Adam + L2 at the lr of the given (1-based) epoch."""
    lr = lr_for_epoch(cfg.lr, epoch - 1, cfg.decay_epochs)
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.wd)


def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initial weights, drawn from `generator`: flax's
    lecun_normal for every conv and dense kernel (a normal truncated at two
    standard deviations, variance 1 / fan_in), zero biases, BatchNorm scale
    1, bias 0, mean 0, variance 1, and the T-Nets' fc3 at the identity."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Conv2d, nn.Linear)):
                std = mod.weight[0].numel() ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.modules.batchnorm._BatchNorm):
                mod.reset_parameters()
        for mod in model.modules():
            if isinstance(mod, TransformNet):
                mod.reset_transform()


def init_state(cfg: TrainConfig, generator: torch.Generator) -> TrainState:
    model = build_model(cfg.arch, cfg.classes, cfg.npoint, device=cfg.device)
    init_parameters(model, generator)
    model.train()
    return TrainState(model, make_optimizer(cfg, model, epoch=1))


def set_epoch(cfg: TrainConfig, state: TrainState, epoch: int) -> None:
    """The epoch's lr on the optimiser and BatchNorm momentum on every
    BatchNorm module (the JAX package rebuilds its step for them)."""
    lr = lr_for_epoch(cfg.lr, epoch - 1, cfg.decay_epochs)
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    momentum = bn_momentum_for_epoch(cfg.bn_momentum, epoch)
    for mod in state.model.modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            mod.momentum = momentum


def train_loss(cfg: TrainConfig, model: nn.Module, pc: torch.Tensor,
               target: torch.Tensor, generator: Optional[torch.Generator] = None,
               keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, logits) of the train-mode forward (geoa3_tpu/train.py:126-150):
    smoothing CE, plus for PointNet 0.001 * sum((T T^t - I)^2) / 2 of its
    feature transform. Updates the running statistics. `keep` is the
    dropout masks (PointNet: a pair; PointNet++: one), else drawn from
    `generator`."""
    model.train()
    out = model(pc, generator=generator, keep=keep)
    logits, transform = out if cfg.arch == "PointNet" else (out, None)
    loss = smoothing_cross_entropy(logits, target, cfg.classes,
                                   cfg.label_smoothing)
    if transform is not None:
        eye = torch.eye(transform.shape[1], dtype=transform.dtype,
                        device=transform.device)
        mat_diff = transform @ transform.transpose(1, 2) - eye
        loss = loss + 0.001 * (mat_diff**2).sum() / 2  # reference :219-223
    return loss, logits


def make_train_step(cfg: TrainConfig, epoch: int = 1) -> Callable:
    """The train step for one epoch's lr and BatchNorm momentum:
    train_step(state, pc [b, n, 3], target [b], generator, keep=None) ->
    (state, {"loss", "acc"}), updating the state in place."""

    def train_step(state: TrainState, pc, target, generator=None, keep=None):
        set_epoch(cfg, state, epoch)
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        loss, logits = train_loss(cfg, state.model, pc, target, generator, keep)
        loss.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:  # optax steps every leaf, on a zero gradient
                    p.grad = torch.zeros_like(p)
        opt.step()
        state.step += 1
        with torch.no_grad():
            acc = (logits.argmax(-1) == target).float().mean() * 100.0
        return state, {"loss": loss.detach(), "acc": acc}

    return train_step


def make_eval_step(cfg: TrainConfig) -> Callable:
    """Test-accuracy step for the best-checkpoint rule (reference :311-339):
    eval_step(state, pc, target) -> (loss, pred), the eval-mode victim with
    its kernels."""

    def eval_step(state: TrainState, pc, target):
        model = state.model
        model.eval()
        with torch.no_grad():
            logits = model(pc)
            loss = smoothing_cross_entropy(logits, target, cfg.classes,
                                           cfg.label_smoothing)
        return loss, logits.argmax(-1)

    return eval_step


def _prep_batch(cfg: TrainConfig, points: np.ndarray) -> np.ndarray:
    """Channel-last + the reference's y/z axis swap (main_train.py:211)."""
    pc = np.asarray(points[..., 0:3], np.float32)
    if cfg.axis_swap:
        pc = pc[..., [0, 2, 1]]
    return np.ascontiguousarray(pc)


def _to_device(cfg: TrainConfig, pc: np.ndarray, target: np.ndarray):
    return (torch.from_numpy(pc).to(cfg.device),
            torch.from_numpy(np.asarray(target, np.int64)).to(cfg.device))


def evaluate(cfg: TrainConfig, state: TrainState, dataset,
             eval_step=None) -> Tuple[float, float]:
    """Class-average + instance accuracy over a dataset (reference :257-307)."""
    if eval_step is None:
        eval_step = make_eval_step(cfg)
    total_seen = np.zeros(cfg.classes)
    total_correct = np.zeros(cfg.classes)
    n_correct, n_total = 0, 0
    dataset.reset()
    while dataset.has_next_batch():
        points, target = dataset.next_batch(False)
        pc = _prep_batch(cfg, points)
        _, pred = eval_step(state, *_to_device(cfg, pc, target))
        pred = pred.cpu().numpy()
        target = np.asarray(target)
        for t, p in zip(target, pred):
            total_seen[t] += 1
            total_correct[t] += int(p == t)
        n_correct += int((pred == target).sum())
        n_total += len(pred)
    seen = total_seen > 0
    class_acc = float(np.mean(total_correct[seen] / total_seen[seen]) * 100.0)
    inst_acc = float(n_correct / max(n_total, 1) * 100.0)
    return class_acc, inst_acc


def _to_host(x):
    """A state_dict (nested dicts, lists, tuples) with its tensors copied to
    the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def train(
    cfg: TrainConfig,
    train_dataset,
    test_dataset,
    modeldir: Optional[str] = None,
    log: Callable[[str], None] = print,
    resume: Optional[str] = None,
) -> Tuple[TrainState, dict]:
    """Full training run (reference main_train.py:135-347).

    `resume` restores the weights, BatchNorm statistics, optimiser, epoch and
    best accuracies from a checkpoint file or directory (reference
    :167-178)."""
    from geoa3_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    if modeldir:
        os.makedirs(modeldir, exist_ok=True)
    generator = torch.Generator(device=cfg.device).manual_seed(cfg.seed)
    state = init_state(cfg, generator)
    eval_step = make_eval_step(cfg)

    tb_writer = None
    if cfg.use_tensorboard and modeldir:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_dir = os.path.join(modeldir, "TB_event")
            os.makedirs(tb_dir, exist_ok=True)
            tb_writer = SummaryWriter(log_dir=tb_dir)
        except Exception as e:  # tensorboard optional (reference gates it too)
            log(f"[warn] tensorboard unavailable: {e}")

    best_prec, class_prec = 0.0, 0.0
    start_epoch = 1
    if resume:
        ckpt = load_checkpoint(resume)
        assert ckpt is not None, "WRONG RESUME PATH!"
        state.model.load_state_dict(ckpt["state_dict"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        start_epoch = int(ckpt["epoch"]) + 1
        best_prec = float(ckpt.get("best_prec", 0.0))
        class_prec = float(ckpt.get("class_prec", 0.0))
        log(f"=> loaded checkpoint '{resume}' (epoch {ckpt['epoch']})")
    cached_step, cached_epoch_cfg = None, None
    # a host-side copy for recovery: a failed epoch restarts from it
    host_state = _to_host((state.model.state_dict(), state.optimizer.state_dict()))
    epoch_attempts = 0
    epoch = start_epoch

    while epoch <= cfg.epochs:
        # a new step only when the lr / BN momentum change
        epoch_cfg = (
            lr_for_epoch(cfg.lr, epoch - 1, cfg.decay_epochs),
            bn_momentum_for_epoch(cfg.bn_momentum, epoch),
        )
        if epoch_cfg != cached_epoch_cfg:
            cached_step = make_train_step(cfg, epoch)
            cached_epoch_cfg = epoch_cfg
        train_step = cached_step

        try:
            losses, accs = AverageMeter(), AverageMeter()
            t0 = time.time()
            train_dataset.reset()
            while train_dataset.has_next_batch():
                points, target = train_dataset.next_batch(cfg.is_aug_data)
                pc, tgt = _to_device(cfg, _prep_batch(cfg, points), target)
                state, metrics = train_step(state, pc, tgt, generator)
                losses.update(float(metrics["loss"]), len(target))
                accs.update(float(metrics["acc"]), len(target))

            class_acc, inst_acc = evaluate(cfg, state, test_dataset, eval_step)
        except Exception as e:
            epoch_attempts += 1
            if epoch_attempts > cfg.max_epoch_retries:
                raise
            log(
                f"[warn] epoch {epoch} failed ({type(e).__name__}: {e}); "
                f"retrying from last good state "
                f"({epoch_attempts}/{cfg.max_epoch_retries})"
            )
            state.model.load_state_dict(host_state[0])
            state.optimizer.load_state_dict(host_state[1])
            cached_step, cached_epoch_cfg = None, None
            continue
        epoch_attempts = 0
        host_state = _to_host((state.model.state_dict(), state.optimizer.state_dict()))
        if tb_writer is not None:
            tb_writer.add_scalar("Train Loss", losses.avg, epoch)
            tb_writer.add_scalar("Train Top1", accs.avg, epoch)
            tb_writer.add_scalar("Test Top1", inst_acc, epoch)
            tb_writer.add_scalar("Test ClassAcc", class_acc, epoch)

        is_best = inst_acc > best_prec or (
            inst_acc == best_prec and class_prec < class_acc
        )
        if is_best:
            best_prec, class_prec = inst_acc, class_acc

        log(
            f"===> epoch [{epoch:3d}] ({format_time(time.time() - t0)}): "
            f"train-acc {accs.avg:.3f} loss {losses.avg:.4f} | "
            f"test C-acc {class_acc:.3f} I-acc {inst_acc:.3f} | "
            f"best C-acc {class_prec:.3f} I-acc {best_prec:.3f}"
        )
        if modeldir:
            save_checkpoint(
                modeldir,
                {
                    "epoch": epoch,
                    "state_dict": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "best_prec": best_prec,
                    "class_prec": class_prec,
                },
                is_best=is_best,
            )
            with open(os.path.join(modeldir, "result.txt"), "at") as f:
                f.write(
                    f"epoch[{epoch:3d}] train-acc: {accs.avg:.3f}"
                    f"\t\ttest: C-acc {class_acc:.3f}  I-acc {inst_acc:.3f}"
                )
                f.write(
                    f"\t\tbest: C-acc {class_prec:.3f}  I-acc {best_prec:.3f}\n"
                    if is_best
                    else "\n"
                )
        epoch += 1

    if tb_writer is not None:
        tb_writer.close()
    state.model.eval()
    return state, {"best_prec": best_prec, "class_prec": class_prec}
