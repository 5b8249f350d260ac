"""The attack traffic: whole batches of the GeoA3 attack, back to back.

A traffic file gives the instances a batch holds, the attack label (`All`:
each instance against the nine other classes of the ten attacked ones, so a
batch is 9 x instances clouds), how many distinct batches the pool holds,
and the loss and optimiser settings; the configuration gives the victim and
the depth (binary search steps x Adam steps). Each batch is made in set-up
from the seed: its clouds and normals (benchmark/clouds.py), its labels and
the initial offset of each search step (1e-3 N(0, 1), drawn on the device).

The program's entry is the port's own: `make_attack_fn(make_eval_fn(model),
AttackConfig(...))` and the `attack_fn` it returns, called once a batch. For
the sampled batch the victim's input at every step and each search step's
losses are kept (the logits function the benchmark hands the program holds
a reference to its input; the engine's per-search-step callback hands over
its losses); after the window the plain reference follows that record
(benchmark/reference/attack.py) and benchmark/check.py holds the gaps to
the cell's limits.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from benchmark import arch, clouds, flops, weights
from benchmark.reference import attack as R


@contextlib.contextmanager
def _tf32():
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


class _Recorder:
    """The victim as the program sees it: while `on`, copies each input and
    the gradient that reaches it (the whole loss's: the engine hands the
    victim the cloud its loss terms all read) into buffers made in set-up,
    so that recording allocates nothing inside the window."""

    def __init__(self, fn, steps: int, shape: tuple, device):
        self.fn, self.on, self.at, self.kept = fn, False, 0, 0
        self.inputs = torch.empty((steps,) + shape, device=device)
        self.grads = torch.empty_like(self.inputs)

    def __call__(self, pc):
        if self.on:
            i = self.at
            self.at += 1
            self.inputs[i].copy_(pc.detach())
            if pc.requires_grad:
                pc.register_hook(lambda g: self._keep(i, g))
        return self.fn(pc)

    def _keep(self, i, g):
        self.grads[i].copy_(g)
        self.kept += 1


class Driver:
    def __init__(self, cell: dict, seed: int, device: str):
        from geoa3_tpu_torch import AttackConfig, build_model, make_attack_fn, make_eval_fn

        cfg, tr = cell["config"], cell["traffic"]
        self.cell, self.seed, self.device = cell, seed, device
        self.spec = R.Spec(
            cfg=cfg, binary_max_steps=cfg["binary_max_steps"],
            iter_max_steps=cfg["iter_max_steps"], refresh=tr["curv_knn_refresh_every"],
            knn=tr["curv_loss_knn"], lr=tr["lr"], initial_const=tr["initial_const"],
            dis_w=tr["dis_loss_weight"], hd_w=tr["hd_loss_weight"],
            curv_w=tr["curv_loss_weight"])
        self.n, self.classes = cfg["npoint"], cfg["classes"]
        if (tr["cls_loss_type"], tr["dis_loss_type"]) != ("CE", "CD"):
            raise ValueError("the attack traffic runs the default loss: CE and CD")
        per = 9 if tr["attack_label"] == "All" else 1
        self.offset_std = tr["init_offset_std"]
        self.instances = tr["instances"]
        self.b = self.instances * per
        self.steps_per_batch = self.spec.binary_max_steps * self.spec.iter_max_steps

        model = build_model(cfg["arch"], self.classes, self.n, device=device)
        self.shapes = arch.check_model(model, cfg)
        model.load_state_dict(weights.make(self.shapes, seed, device))
        self.victim = _Recorder(make_eval_fn(model), self.steps_per_batch,
                                (self.b, self.n, 3), device)
        acfg = AttackConfig(
            arch=cfg["arch"], classes=self.classes, npoint=self.n,
            attack_label=tr["attack_label"], initial_const=tr["initial_const"],
            lr=tr["lr"], binary_max_steps=self.spec.binary_max_steps,
            iter_max_steps=self.spec.iter_max_steps, cls_loss_type="CE",
            dis_loss_type="CD", dis_loss_weight=self.spec.dis_w,
            hd_loss_weight=self.spec.hd_w, curv_loss_weight=self.spec.curv_w,
            curv_loss_knn=self.spec.knn,
            curv_knn_refresh_every=self.spec.refresh)
        self._losses = []
        self.attack_fn = make_attack_fn(
            self.victim, acfg, init_offset=lambda bs: self._offsets[bs],
            host_binary_loop=True,
            debug_callback=lambda bs, best, loss_ys: self._losses.append(loss_ys))
        self.batches = self._make_pool(tr["pool_batches"])
        # warm-up: one block of K steps at the batch's shape
        warm = make_attack_fn(self.victim, dataclasses.replace(
            acfg, binary_max_steps=1, iter_max_steps=self.spec.refresh),
            init_offset=lambda bs: self._offsets[bs])
        self._offsets = self.batches[0]["offsets"]
        warm(*(self.batches[0][k] for k in ("pc", "nrm", "gt", "target")))
        self.sync()
        self.record = None

    def _make_pool(self, count):
        rng = np.random.default_rng(self.seed)
        pts, nrm, ids = clouds.pool(count * self.instances, self.n, rng)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        ten = np.asarray(clouds.TEN_LABEL_INDEXES)
        out = []
        for i in range(count):
            sl = slice(i * self.instances, (i + 1) * self.instances)
            gt = ten[ids[sl]]
            if self.b == self.instances:
                tgt = gt
            else:  # each instance against each other class of the ten
                tgt = np.concatenate([[t for t in ten if t != g] for g in gt])
                gt = np.repeat(gt, 9)
            rep = self.b // self.instances
            dev = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(  # noqa: E731
                self.device, dt)
            pc = dev(np.repeat(pts[sl], rep, axis=0), torch.float32)
            out.append(dict(
                pc=pc, nrm=dev(np.repeat(nrm[sl], rep, axis=0), torch.float32),
                gt=dev(gt, torch.int64), target=dev(tgt, torch.int64),
                offsets=[self.offset_std * torch.randn(pc.shape, generator=gen, device=self.device)
                         for _ in range(self.spec.binary_max_steps)]))
        return out

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def run_batch(self, i: int, record: bool = False):
        """Attack batch i (of the pool, in turn) to its end."""
        batch = self.batches[i % len(self.batches)]
        self._offsets = batch["offsets"]
        self.victim.on, self.victim.at, self.victim.kept, self._losses = record, 0, 0, []
        res = self.attack_fn(batch["pc"], batch["nrm"], batch["gt"], batch["target"])
        self.sync()
        if record:
            T = self.spec.iter_max_steps
            xs, gs = self.victim.inputs, self.victim.grads
            per_bs = lambda v: [list(v[j * T:(j + 1) * T])  # noqa: E731
                                for j in range(self.spec.binary_max_steps)]
            self.record = (batch, R.Record(
                clouds=per_bs(xs), grads=per_bs(gs), losses=list(self._losses),
                best_attack=res.best_attack, success=res.success,
                best_step=res.best_attack_step, best_bs=res.best_attack_bs_idx,
                best_loss=res.best_loss))
            if not self.victim.at == self.victim.kept == self.steps_per_batch:
                raise RuntimeError(f"the victim saw {self.victim.at} inputs and "
                                   f"{self.victim.kept} gradients in a batch of "
                                   f"{self.steps_per_batch} steps")
        self.victim.on = False

    def clouds_per_batch(self) -> int:
        return self.b

    def rate(self, steps: int, window_s: float) -> dict:
        """attacks_per_s: clouds fully attacked a second at the published
        depth (10 x 500 Adam steps)."""
        pub = self.cell["config"]["published_steps"]
        return {"attacks_per_s": self.b * steps / (pub * window_s)}

    def step_flops(self) -> float:
        return flops.attack_step(self.cell["config"], self.b)

    def layout(self) -> dict:
        """The shapes a step runs at, for the roofline counts."""
        return dict(kind="attack", arch=self.cell["config"]["arch"], b=self.b, n=self.n,
                    k=self.spec.knn, refresh=self.spec.refresh,
                    batch_steps=self.steps_per_batch, classes=self.classes,
                    config=self.cell["config"])

    def free(self):
        """Drop the program's state, keeping the sampled record."""
        self.attack_fn = self.victim = None
        self.batches = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def control(self, batch_index: int):
        """The control in the program's place: the plain reference's own
        attack of the batch, computed in float32 with TF32 on (the
        precision below the configuration's float32 with TF32 off)."""
        batch = self.batches[batch_index]
        p32 = weights.make(self.shapes, self.seed, self.device)
        with _tf32():
            rec = R.run(self.spec, p32, batch["pc"], batch["nrm"], batch["target"],
                        batch["offsets"])
        self.record = (batch, rec)

    def check(self, settings: dict) -> dict:
        """The gaps of `check_clouds` clouds of the sampled batch, drawn from
        the seed (benchmark/reference/attack.py)."""
        batch, rec = self.record
        params = {k: v.double() if v.is_floating_point() else v
                  for k, v in weights.make(self.shapes, self.seed, self.device).items()}
        gen = torch.Generator().manual_seed(self.seed + 2)
        k = min(self.b, settings["check_clouds"])
        rows = torch.randperm(self.b, generator=gen)[:k].sort().values.to(self.device)
        return R.judge(self.spec, params, batch["pc"][rows], batch["nrm"][rows],
                       batch["target"][rows], [o[rows] for o in batch["offsets"]],
                       R.sample(rec, rows), step_chunk=settings["step_chunk"],
                       batch=self.b)
