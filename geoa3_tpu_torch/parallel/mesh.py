"""Process groups and sharding for the attack and training (port of
geoa3_tpu/parallel/mesh.py).

The JAX package runs one program over a `jax.sharding.Mesh` and lets GSPMD
place the collectives. The port runs one process per GPU (`torchrun
--nproc_per_node N`), on `torch.distributed`, over a DeviceMesh with the
same two axes:

  * `data`: the attack batch (instances x targets) or the train batch is
    split over it; each rank keeps its rows of the global batch;
  * `model`: tensor parallelism for the wide victim layers (>= 512 output
    features: torch keeps them on dim 0), each rank holding its rows of the
    weight and of its Adam moments; everything else is replicated.

Both the sharded attack and the sharded train step compute what one device
computes on the global batch: every random number is drawn at the global
shape on every rank from the one seeded generator, and each rank keeps its
rows; the losses are the global batch's (each rank's share of it, with the
gradients summed over `data`), and BatchNorm's train-mode statistics are
the global batch's (parallel/collectives.py).
"""

from __future__ import annotations

import copy
import datetime
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from geoa3_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    broadcast_,
    data_shard,
    rows_of,
)

MIN_TP_DIM = 512


def init_distributed(backend: Optional[str] = None, device: str = "cuda",
                     init_method: Optional[str] = None,
                     timeout: Optional[float] = None) -> torch.device:
    """Join (or start) the process group and return this rank's device.

    The rank, the world size and the card come from torchrun's environment
    (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`; `MASTER_ADDR` / `MASTER_PORT` for
    the default `env://` rendezvous, or `init_method`, say a `file://`
    path); without it the world is this process alone. The backend is
    `nccl` on CUDA and `gloo` on the CPU; `gloo` on CUDA tensors only when
    named (ranks that share one card, which NCCL refuses). On CUDA the card
    `LOCAL_RANK` becomes the current device before anything else runs: the
    kernels launch on the current device's stream. `cuda` without a card
    raises. If a group exists already, it is kept. `timeout` is in
    seconds."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is available "
                               "(pass device='cpu' to run on the CPU)")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"LOCAL_RANK {local} names no card: "
                               f"{torch.cuda.device_count()} visible")
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    elif dev.type != "cpu":
        raise ValueError(f"init_distributed: device {device}")
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {} if timeout is None else {"timeout": datetime.timedelta(seconds=timeout)}
    if "WORLD_SIZE" not in os.environ and init_method is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    else:
        dist.init_process_group(
            backend, init_method=init_method or "env://",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]), **kw)
    return dev


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> DeviceMesh:
    """A ('data', 'model') DeviceMesh over the world: n_data x n_model ranks,
    rank r at (r // n_model, r % n_model). `n_data` defaults to the world
    size over `n_model`; the product must be the world size. Only its
    process groups and coordinates are used, so its device type follows the
    backend (cuda for nccl, else cpu)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} "
                         f"ranks; the world has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def _axis(mesh: DeviceMesh, name: str):
    """(group, this rank's index, size) of one mesh axis."""
    return (mesh.get_group(name), mesh.get_local_rank(name),
            mesh.size(mesh.mesh_dim_names.index(name)))


def shard_batch(mesh: DeviceMesh, *arrays):
    """This rank's rows of each array (tensor or numpy) along its leading
    (batch) axis: the data-axis index times b / n_data. A batch that the
    data axis does not divide raises."""
    _, index, size = _axis(mesh, "data")
    out = tuple(rows_of(a, index, size) for a in arrays)
    return out if len(out) > 1 else out[0]


# the attack-centric name used in the docs
shard_attack_batch = shard_batch


def replicate(mesh: DeviceMesh, tree):
    """Broadcast the tensors of a state dict (or any nesting of dicts,
    lists and tuples) from the mesh's first rank, in place; returns it."""
    src = int(mesh.mesh.flatten()[0])
    if isinstance(tree, torch.Tensor):
        broadcast_(tree, src)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(mesh, v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(mesh, v)
    return tree


def _param_spec(shape, min_tp_dim: int = MIN_TP_DIM) -> Optional[int]:
    """TP rule: split a wide weight's output features (dim 0 in torch; the
    JAX rule's last dim in flax) over 'model'; None replicates."""
    if len(shape) >= 2 and shape[0] >= min_tp_dim:
        return 0
    return None


def param_shardings(mesh: DeviceMesh, model: torch.nn.Module,
                    tensor_parallel: bool = False) -> dict:
    """{parameter name: the dim split over 'model', or None (replicated)}."""
    return {name: _param_spec(p.shape) if tensor_parallel else None
            for name, p in model.named_parameters()}


def _gather_result(res, group):
    """Each rank's AttackResult -> the global one on every rank (rows
    concatenated in data-axis order; all_loss along its batch axis)."""
    def gather(t, dim=0):
        flag = t.dtype == torch.bool
        out = torch.cat(all_gather(t.to(torch.uint8) if flag else t, group),
                        dim=dim)
        return out.bool() if flag else out

    return type(res)(**{name: gather(t, 1 if name == "all_loss" else 0)
                        for name, t in res._asdict().items()})


class _RankDraws:
    """A caller's `draws` (attack/engine.py), given at the global batch's
    shape, this rank's rows kept."""

    def __init__(self, src, cut):
        self.src, self.cut = src, cut

    def fps_start(self, bs_idx, step):
        return self.cut(self.src.fps_start(bs_idx, step))

    def eval_starts(self, bs_idx, step):
        return self.cut(torch.as_tensor(self.src.eval_starts(bs_idx, step)).t()).t()

    def jitter_gauss(self, bs_idx, step, cloud):
        return tuple(self.cut(g) for g in self.src.jitter_gauss(bs_idx, step, cloud))

    def patch_seed(self, bs_idx, phase):
        return self.src.patch_seed(bs_idx, phase)

    def patch_offset(self, bs_idx, phase):
        return self.cut(self.src.patch_offset(bs_idx, phase))


def make_sharded_attack_fn(logits_fn: Callable, cfg, mesh: DeviceMesh,
                           eval_logits_fn: Optional[Callable] = None,
                           init_offset: Optional[Callable] = None,
                           draws=None) -> Callable:
    """The attack with the batch split over the mesh's data axis.

        attack_fn(pc_ori [B,n,3], normal_ori [B,n,3], gt_target [B],
                  target [B], generator) -> AttackResult of the B rows

    Every rank of the data axis passes the same global batch and the same
    seeded generator; it attacks its B / n_data rows, and the results are
    all-gathered, so that every rank returns the global result (the JAX
    function's outputs are global arrays). The attack is independent per
    row but for the loss's mean over the batch, which each rank takes as
    its rows' sum over B (no collective a step). Each rank draws every
    random number at the global shape, at the engine's own draw sites
    (make_attack_fn's `shard`), and keeps its rows, so that the result is
    the one-device attack's at the same seed. `init_offset` and `draws`
    (attack/engine.py) are taken at the global shape. B must divide by the
    data axis's size."""
    from geoa3_tpu_torch.attack.engine import make_attack_fn

    group, index, size = _axis(mesh, "data")

    def attack_fn(pc_ori, normal_ori, gt_target, target, generator=None):
        def cut(x):
            return rows_of(torch.as_tensor(x), index, size).to(pc_ori.device)

        fn = make_attack_fn(
            logits_fn, cfg, eval_logits_fn=eval_logits_fn, shard=(index, size),
            init_offset=None if init_offset is None else (
                lambda bs_idx: cut(init_offset(bs_idx))),
            draws=None if draws is None else _RankDraws(draws, cut))
        res = fn(*(cut(x) for x in (pc_ori, normal_ori, gt_target, target)),
                 generator)
        return _gather_result(res, group)

    return attack_fn


def _train_mode_only(model, args) -> None:
    if not model.training:
        raise RuntimeError("a tensor-parallel model runs in train mode only: "
                           "evaluate the full model")


def make_sharded_train_step(cfg, mesh: DeviceMesh, tensor_parallel: bool = False,
                            epoch: int = 1):
    """The train step with dp (batch over 'data') and optional tp (wide
    layers over 'model') -> (step, place).

    `place(state)` takes a full TrainState (say one that models/convert.py
    made from the JAX parameters, Adam's state included), broadcasts it from
    the mesh's first rank and returns this rank's: with `tensor_parallel`,
    each wide layer (`_param_spec`) keeps its rows of the weight and of its
    Adam moments and is marked with the model group; the rest is
    replicated. The caller's state is left as it was. A split model runs in
    train mode only (its eval forward raises): the eval route of the models
    never looks for a split layer.

    `step(state, pc [B,n,3], target [B], generator, keep=None)` takes the
    global batch (and dropout masks at its shape) and returns (state,
    {"loss", "acc"}) of the global batch, updating the state in place. Its
    numbers are the one-device step's on the global batch: each rank's loss
    is its share (CE summed over its rows over B, plus its rows' T-Net
    penalty, a sum over the batch), the gradients are summed over 'data'
    (not averaged, as DDP does), BatchNorm takes the global statistics and
    dropout the global draw."""
    from geoa3_tpu_torch.train import TrainState, make_train_step

    dgroup, dindex, dsize = _axis(mesh, "data")
    mgroup, mindex, msize = _axis(mesh, "model")

    def reduce_grads(params):
        if dsize == 1:
            return
        grads = [p.grad for p in params]
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), dgroup)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

    def place(state: TrainState) -> TrainState:
        model = copy.deepcopy(state.model)
        replicate(mesh, model.state_dict())
        opt_sd = copy.deepcopy(state.optimizer.state_dict())
        replicate(mesh, opt_sd["state"])
        index_of = {id(p): i for i, p in enumerate(
            p for g in state.optimizer.param_groups for p in g["params"])}
        by_name = dict(state.model.named_parameters())
        specs = param_shardings(mesh, model, tensor_parallel)
        for mod_name, mod in model.named_modules():
            w = getattr(mod, "weight", None)
            name = f"{mod_name}.weight" if mod_name else "weight"
            if not isinstance(w, torch.nn.Parameter) or specs.get(name) is None:
                continue
            if w.shape[0] % msize:
                raise ValueError(f"{name}: {w.shape[0]} rows over {msize} model ranks")
            rows = lambda t: rows_of(t, mindex, msize).clone()  # noqa: E731
            mod.weight = torch.nn.Parameter(rows(w.detach()), w.requires_grad)
            mod.model_group = mgroup
            moments = opt_sd["state"].get(index_of[id(by_name[name])], {})
            for key, t in moments.items():
                if torch.is_tensor(t) and t.shape == w.shape:
                    moments[key] = rows(t)
        if tensor_parallel and msize > 1:
            model.register_forward_pre_hook(_train_mode_only)
        opt = torch.optim.Adam(model.parameters(), **state.optimizer.defaults)
        opt.load_state_dict(opt_sd)
        return TrainState(model, opt, state.step)

    def sharded_step(state, pc, target, generator=None, keep=None):
        dev = next(state.model.parameters()).device
        B = pc.shape[0]
        pc, target = (torch.as_tensor(x).to(dev) for x in
                      shard_batch(mesh, pc, target))
        step = make_train_step(cfg, epoch, global_batch=B,
                               reduce_grads=reduce_grads)
        with data_shard(dgroup, dindex, dsize):
            state, metrics = step(state, pc, target, generator, keep)
        # the loss is each rank's share; acc its rows' mean
        both = torch.stack([metrics["loss"],
                            metrics["acc"].to(metrics["loss"].dtype) * pc.shape[0] / B])
        all_reduce_(both, dgroup)
        return state, {"loss": both[0], "acc": both[1]}

    return sharded_step, place

