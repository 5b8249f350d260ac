"""The train traffic: the victim's train steps back to back.

A traffic file gives the batch, how many distinct batches the pool holds
and the steps a timed call runs before it waits for the card; the
configuration gives the victim. Each batch is made in set-up from the seed:
its clouds (benchmark/clouds.py, one of the ten classes in turn, labelled
by the ModelNet40 id of the class) and the head's dropout keep masks. No
input pipeline runs: the clouds are on the card before the window.

The program's entry is the port's own: `train.make_train_step(cfg)` and the
`TrainState` of `train.init_state`, whose weights the benchmark replaces
with its own from the seed. Set-up drives that state through its first
three steps on three distinct batches by the window's own call, keeping the
loss of each, the gradients as the optimiser took them at the first step
(from Adam's first moment after it) and the parameters and running
statistics after the third; the same state then goes on into the window.
After the window the plain reference (benchmark/reference/train.py) makes
the same three steps in float64 from the same weights, batches and masks.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import arch, clouds, flops, weights
from benchmark.reference import train as RT

FIRST_STEPS = 3
ADAM_EPS = 1e-8
# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding: it moves under Adam by round-off alone, and is left
# out of the change
STILL_LEAF = 1e-3


class Driver:
    def __init__(self, cell: dict, seed: int, device: str):
        from geoa3_tpu_torch import train as T

        cfg, tr = cell["config"], cell["traffic"]
        self.cell, self.seed, self.device = cell, seed, device
        self.arch, self.n, self.classes = cfg["arch"], cfg["npoint"], cfg["classes"]
        if self.arch != "PointNetPP_MSG":
            raise ValueError("the train traffic's reference is PointNet++ MSG's")
        self.b = tr["batch"]
        self.steps_per_batch = tr["steps_per_call"]
        self.tcfg = T.TrainConfig(arch=self.arch, classes=self.classes, npoint=self.n,
                                  batch_size=self.b, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.state = T.init_state(self.tcfg, gen)
        self.shapes = arch.check_model(self.state.model, cfg)
        self.state.model.load_state_dict(weights.make(self.shapes, seed, device))
        self.step = T.make_train_step(self.tcfg)
        self.lr, self.wd = self.tcfg.lr, self.tcfg.wd
        self.momentum = T.bn_momentum_for_epoch(self.tcfg.bn_momentum, 1)
        self.pool = self._make_pool(tr["pool_batches"])
        self.at = 0
        model = self.state.model
        p0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
        losses = []
        for i in range(FIRST_STEPS):
            _, m = self._one(i)
            losses.append(m["loss"])
            if i == 0:
                p1 = {k: v.detach().clone() for k, v in model.state_dict().items()}
                opt = self.state.optimizer
                g1 = {}
                names = {id(p): k for k, p in model.named_parameters()}
                for group in opt.param_groups:
                    for p in group["params"]:
                        g1[names[id(p)]] = opt.state[p]["exp_avg"] / (1 - 0.9)
        self.sync()
        self.first = dict(p0=p0, loss=[float(x) for x in losses], grad=g1, p1=p1,
                          p3={k: v.detach().clone() for k, v in model.state_dict().items()})
        self.at = FIRST_STEPS

    def _make_pool(self, count):
        rng = np.random.default_rng(self.seed)
        pts, _, ids = clouds.pool(count * self.b, self.n, rng)
        ten = np.asarray(clouds.TEN_LABEL_INDEXES)
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        out = []
        for i in range(count):
            sl = slice(i * self.b, (i + 1) * self.b)
            out.append(dict(
                pc=torch.from_numpy(pts[sl]).to(self.device),
                target=torch.from_numpy(ten[ids[sl]].astype(np.int64)).to(self.device),
                keep=torch.rand(self.b, 256, generator=gen, device=self.device) < 0.5))
        return out

    def _one(self, i):
        bt = self.pool[i % len(self.pool)]
        return self.step(self.state, bt["pc"], bt["target"], None, keep=bt["keep"])

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    def run_batch(self, i: int, record: bool = False):
        """`steps_per_call` train steps on the next batches of the pool."""
        for _ in range(self.steps_per_batch):
            self._one(self.at)
            self.at += 1
        self.sync()

    def clouds_per_batch(self) -> int:
        return self.b * self.steps_per_batch

    def rate(self, steps: int, window_s: float) -> dict:
        return {"train_samples_per_s": self.b * steps / window_s}

    def step_flops(self) -> float:
        return flops.train_step(self.cell["config"], self.b)

    def layout(self) -> dict:
        return dict(kind="train", arch=self.arch, b=self.b, n=self.n,
                    batch_steps=self.steps_per_batch, classes=self.classes,
                    config=self.cell["config"])

    def free(self):
        self.state = self.step = None
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def _first_of(self, ref):
        self.first = dict(p0=self.first["p0"], loss=[float(x) for x in ref["loss"]],
                          grad=dict(ref["grad"]), p1=ref["state1"], p3=ref["state"])

    def _batches(self):
        return [(b["pc"], b["target"], b["keep"]) for b in self.pool[:FIRST_STEPS]]

    def control(self, batch_index: int):
        """The control in the program's place: the plain reference's three
        steps from the same weights, computed in float32 with TF32 on."""
        from benchmark.traffic.attack import _tf32

        with _tf32():
            self._first_of(RT.train_steps(self.cell["config"], self.first["p0"],
                                          self._batches(), self.lr, self.wd, self.momentum))

    def fault(self, batch_index: int):
        """A planted fault in the program's place: the plain reference's
        three steps in float32 (TF32 off) with the loss taken over half of
        the batch."""
        self._first_of(RT.train_steps(self.cell["config"], self.first["p0"], self._batches(),
                                      self.lr, self.wd, self.momentum,
                                      loss_rows=self.b // 2))

    def check(self, settings: dict) -> dict:
        """Gaps of the first three steps against the float64 reference:
        loss [3] relative; per leaf, against max(the reference's norm of the
        leaf, the median leaf's): grad, the gap of the first gradient's
        norms, and grad_diff, the norm of the gradients' difference;
        update, per leaf, the norm of the first step's change less Adam's
        update from the program's own first gradient, against the norm of
        that update (this follows the program from its own gradient: it
        checks the optimiser, the gradient being grad's and grad_diff's);
        change, the gap of the norms of the parameters' and running
        statistics' change after three steps."""
        first = self.first
        p0 = {k: v.double() if v.is_floating_point() else v for k, v in first["p0"].items()}
        ref = RT.train_steps(self.cell["config"], p0, self._batches(), self.lr, self.wd,
                             self.momentum)
        lr_ = torch.stack(ref["loss"])
        loss = (torch.tensor(first["loss"], dtype=torch.float64, device=lr_.device)
                - lr_).abs() / lr_.abs()
        leaves = ref["leaves"]
        g_ref = [ref["grad"][k] for k in leaves]
        g_prog = [first["grad"][k].double() for k in leaves]
        gn_ref = torch.stack([g.norm() for g in g_ref])
        g_den = torch.maximum(gn_ref, gn_ref.median())
        grad = (torch.stack([g.norm() for g in g_prog]) - gn_ref).abs() / g_den
        grad_diff = torch.stack([(a - b).norm() for a, b in zip(g_prog, g_ref)]) / g_den
        moved = gn_ref >= STILL_LEAF * gn_ref.median()
        keys = [k for k, m in zip(leaves, moved.tolist()) if m]
        keys += [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
        d_ref = [ref["state"][k] - p0[k] for k in keys]
        d_prog = [first["p3"][k].double() - p0[k] for k in keys]
        dn_ref = torch.stack([d.norm() for d in d_ref])
        d_den = torch.maximum(dn_ref, dn_ref.median())
        change = (torch.stack([d.norm() for d in d_prog]) - dn_ref).abs() / d_den
        # the first update against Adam's from the program's own first
        # gradient (a fresh state: bias-corrected, it is g / (|g| + eps))
        update = torch.stack([
            ((first["p1"][k].double() - p0[k]) - u).norm() / u.norm().clamp_min(1e-300)
            for k, g in zip(leaves, g_prog)
            for u in [-self.lr * g / (g.abs() + ADAM_EPS)]])
        return {"loss": loss, "grad": grad, "grad_diff": grad_diff, "update": update,
                "change": change}
