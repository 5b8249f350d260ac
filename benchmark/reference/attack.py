"""The GeoA3 attack (Wen et al., TPAMI 2020) in plain PyTorch: the loss, the
Adam step, the C&W binary search and best-tracking, as the port's engine
states them (its documented deviations included: the success test is the
gradient pass's prediction, best-tracking takes the step's constrain loss,
the search's success test is "succeeded at least once in this search step",
and the curvature term's self-kNN selection is rebuilt from the cloud at the
start of every block of K steps).

Two uses:
  * `judge` follows a run of the program step by step from the program's own
    clouds and gradients (the input its victim saw at every step, and the
    gradient of the loss at that input), recomputes in float64 what each
    step should give, and returns the gaps (benchmark/check.py says what
    they are held to);
  * `run` is the whole attack, by itself, in the dtype of its parameters:
    the control put in the program's place, and the CPU tests' stand-in.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from benchmark.reference import geometry as G
from benchmark.reference import pointnet, pointnetpp

INF = 1e10
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
TIE = 1e-4  # a success test's margin within this of 0 counts as undecided
BLOCK = 32  # clouds a reference pass takes at once


@dataclasses.dataclass(frozen=True)
class Spec:
    cfg: dict  # the victim's configuration (configs/<name>.json)
    binary_max_steps: int
    iter_max_steps: int
    refresh: int  # K: the self-kNN selection is rebuilt every K steps
    knn: int
    lr: float
    initial_const: float
    dis_w: float
    hd_w: float
    curv_w: float


@dataclasses.dataclass
class Record:
    """What one attack of a batch produced: the cloud its victim saw at each
    step of each search step, the gradient of the loss at that cloud, the
    per-instance loss at each step, and the best-tracking result."""
    clouds: list  # [binary][iter] -> [b, n, 3] float32
    grads: list  # [binary][iter] -> [b, n, 3]
    losses: list  # [binary] -> [iter, b]
    best_attack: torch.Tensor
    success: torch.Tensor
    best_step: torch.Tensor
    best_bs: torch.Tensor
    best_loss: torch.Tensor


class Victim:
    """The plain victim of a configuration: selections (float32, many
    clouds at once) and logits (in the parameters' dtype)."""

    def __init__(self, cfg: dict):
        self.cfg, self.arch = cfg, cfg["arch"]
        if self.arch not in ("PointNet", "PointNetPP_MSG"):
            raise ValueError(f"no plain reference for {self.arch}")

    def select(self, x32):
        return pointnetpp.select(self.cfg, x32) if self.arch == "PointNetPP_MSG" else None

    def take(self, sel, rows):
        return None if sel is None else pointnetpp.take(sel, rows)

    def logits(self, p, x, sel=None):
        if self.arch == "PointNet":
            return pointnet.logits(self.cfg, p, x)
        return pointnetpp.logits(self.cfg, p, x, sel)


def ce_targeted(logits, target):
    return torch.logsumexp(logits, 1) - logits.gather(1, target[:, None])[:, 0]


def search_update(lower, upper, const, success):
    """The C&W constant after a search step (success [b] bool)."""
    lower = torch.where(success, torch.maximum(lower, const), lower)
    upper = torch.where(success, upper, torch.minimum(upper, const))
    mid = (lower + upper) * 0.5
    const = torch.where(success, torch.where(upper < 1e9, mid, const * 2),
                        torch.where(upper < 1e9, mid, const))
    return lower, upper, const


class Adam:
    """Adam's step direction (bias-corrected, eps outside the root) from a
    fresh state at each search step: -lr times `direction(g)` is the
    update."""

    def __init__(self):
        self.mu = self.nu = None
        self.t = 0

    def direction(self, g):
        if self.mu is None:
            self.mu, self.nu = torch.zeros_like(g), torch.zeros_like(g)
        self.mu = (1 - B1) * g + B1 * self.mu
        self.nu = (1 - B2) * (g * g) + B2 * self.nu
        self.t += 1
        bc1 = float(1 - torch.tensor(B1, dtype=torch.float32) ** self.t)
        bc2 = float(1 - torch.tensor(B2, dtype=torch.float32) ** self.t)
        return (self.mu / bc1) / ((self.nu / bc2).sqrt() + ADAM_EPS)


def kappa_ori(pc, nrm, k, dtype):
    return G.kappa(pc.to(dtype), nrm.to(dtype), G.self_knn(pc, k))


class _Terms:
    """The loss terms at clouds X [b, n, 3] (float32, the selections' input)
    in the dtype of the parameters."""

    def __init__(self, spec, victim, params, pc, nrm, kori):
        self.s, self.v, self.p = spec, victim, params
        self.dt = next(iter(params.values())).dtype
        self.pc, self.nrm, self.kori = pc, nrm.to(self.dt), kori
        self.ori = pc.to(self.dt)

    def eval_rows(self, X, nbr, sel, r, x=None):
        """(logits, constrain) at the clouds X[r] with the self-kNN sets
        nbr[r] and the victim's selections `sel` of those rows; x is X[r] in
        the values' dtype (a leaf, for a gradient) or None."""
        s = self.s
        Xr = X[r]
        x = Xr.to(self.dt) if x is None else x
        a2o, o2a = G.nn1(Xr, self.pc[r])
        logits = self.v.logits(self.p, x, sel)
        con = G.attack_constrain(x, self.ori[r], self.kori[r], self.nrm[r],
                                 nbr[r], a2o, o2a, s.dis_w, s.hd_w, s.curv_w)[0]
        return logits, con


def _blocks(b, block):
    return [slice(i, min(b, i + block)) for i in range(0, b, block)]


def run(spec: Spec, params: dict, pc, nrm, target, offsets, block: int = BLOCK) -> Record:
    """The whole attack of one batch in the parameters' dtype (pc, nrm
    float32 [b, n, 3]; target [b]; offsets: the initial offset of each
    search step, float32 [b, n, 3]). The clouds are float32, as the
    program's are."""
    victim = Victim(spec.cfg)
    dt = next(iter(params.values())).dtype
    b = pc.shape[0]
    terms = _Terms(spec, victim, params, pc, nrm, kappa_ori(pc, nrm, spec.knn, dt))
    lower = torch.zeros(b, dtype=torch.float32, device=pc.device)
    upper = torch.full_like(lower, INF)
    const = torch.full_like(lower, spec.initial_const)
    best_loss = torch.full_like(lower, INF)
    best_attack = torch.ones_like(pc)
    best_step = torch.full((b,), -1, dtype=torch.int32, device=pc.device)
    best_bs = torch.full_like(best_step, -1)
    clouds, grads, losses = [], [], []
    for bs in range(spec.binary_max_steps):
        it_success = torch.zeros(b, dtype=torch.bool, device=pc.device)
        offset = offsets[bs].float().clone()
        adam, steps, step_grads, loss_ys = Adam(), [], [], []
        nbr = None
        for t in range(spec.iter_max_steps):
            X = pc + offset
            if t % spec.refresh == 0:
                nbr = G.self_knn(X, spec.knn)
            sel = victim.select(X)
            grad = torch.empty_like(X, dtype=dt)
            loss_n = torch.empty(b, dtype=dt, device=pc.device)
            con_all = torch.empty(b, dtype=dt, device=pc.device)
            pred = torch.empty(b, dtype=torch.long, device=pc.device)
            c = const.to(dt)
            for r in _blocks(b, block):
                x = X[r].to(dt).requires_grad_(True)
                logits, con = terms.eval_rows(X, nbr, victim.take(sel, r), r, x)
                ln = ce_targeted(logits, target[r]) + c[r] * con
                (g,) = torch.autograd.grad(ln.sum() / b, x)
                grad[r], loss_n[r] = g, ln.detach()
                con_all[r], pred[r] = con.detach(), logits.detach().argmax(-1)
            success = pred == target
            better = success & (con_all.float() < best_loss)
            best_loss = torch.where(better, con_all.float(), best_loss)
            best_attack = torch.where(better[:, None, None], X, best_attack)
            best_step = torch.where(better, t, best_step)
            best_bs = torch.where(better, bs, best_bs)
            it_success |= success
            step = (-spec.lr) * adam.direction(grad)
            steps.append(X)
            step_grads.append(grad)
            loss_ys.append(loss_n.float())
            offset = offset + step.float()
        clouds.append(steps)
        grads.append(step_grads)
        losses.append(torch.stack(loss_ys))
        lower, upper, const = search_update(lower, upper, const, it_success)
    return Record(clouds, grads, losses, best_attack, best_loss < INF, best_step,
                  best_bs, best_loss)


def sample(rec: Record, rows) -> Record:
    """The record of some clouds of the batch (rows: an index tensor)."""
    return Record([[x[rows] for x in xs] for xs in rec.clouds],
                  [[g[rows] for g in gs] for gs in rec.grads],
                  [ls[:, rows] for ls in rec.losses], rec.best_attack[rows],
                  rec.success[rows], rec.best_step[rows], rec.best_bs[rows],
                  rec.best_loss[rows])


def judge(spec: Spec, params: dict, pc, nrm, target, offsets, rec: Record,
          step_chunk: int = 10, block: int = BLOCK, batch: Optional[int] = None) -> dict:
    """Follow the record `rec` of one batch's attack from its own clouds and
    gradients, in the parameters' dtype (float64), and return the gaps:

      loss  [binary * iter + 1, b]: at every step |loss_prog - loss_ref|
            / max(|loss_ref|, the step's median |loss_ref|); and, last, the
            best-tracking gap of each cloud: how far the best-tracking
            result lies outside what the reference's success tests and
            constrain losses allow (relative; 1 for a best cloud that is
            not the cloud of its step, or a success flag that no decided
            test allows);
      step  [binary * iter, b]: at every step the larger of the gradient's
            gap |g_prog - g_ref| / |g_ref| per cloud (g_ref the reference's
            gradient at the program's cloud) and the update's gap |u_prog -
            u| / |u| per cloud (u_prog the step from this cloud to the
            next, u Adam's step from the program's own gradients, from a
            fresh state at each search step; none after a search step's
            last cloud); 1 throughout a search step whose first cloud is
            not pc + offset bit for bit;
      grad, update  [binary * iter, b]: its two parts.

    The second search step's constant is the reference's, from its own
    success tests of the first; where a test's margin (target logit minus
    the largest other, relative to the largest |logit|) is within TIE of 0
    it counts as undecided, and either constant is allowed. The clouds may
    be a sample of the batch (`sample`): each cloud's steps depend on the
    others only through the loss's mean over the whole batch, of `batch`
    clouds."""
    victim = Victim(spec.cfg)
    dt = next(iter(params.values())).dtype
    b = pc.shape[0]
    batch = batch or b
    dev = pc.device
    terms = _Terms(spec, victim, params, pc, nrm, kappa_ori(pc, nrm, spec.knn, dt))
    nb, T = spec.binary_max_steps, spec.iter_max_steps
    cls = torch.empty(nb, T, b, dtype=dt, device=dev)
    con = torch.empty_like(cls)
    margin = torch.empty_like(cls)
    grad_gap = torch.zeros(nb, T, b, dtype=dt, device=dev)
    upd_gap = torch.zeros_like(grad_gap)
    consts = []
    states = None
    for bs in range(nb):
        # the two ends of the constant the search may have set: every
        # undecided success test of the earlier search steps failed, or
        # each succeeded (equal wherever every test was decided)
        states = _search_states(spec, states, margin[:bs], b, dev)
        cs = [st[2].to(dt) for st in states]
        consts.append(cs)
        X_all, G_all = rec.clouds[bs], rec.grads[bs]
        start_ok = torch.equal(X_all[0], pc + offsets[bs].float())
        adam = Adam()
        nbr = None
        for t0 in range(0, T, step_chunk):
            ts = list(range(t0, min(T, t0 + step_chunk)))
            # a chunk of steps at once: its selections in one call
            sel = victim.select(torch.cat([X_all[t] for t in ts]))
            for j, t in enumerate(ts):
                if t % spec.refresh == 0:
                    nbr = G.self_knn(X_all[t], spec.knn)
                g_cls = torch.empty_like(X_all[t], dtype=dt)
                g_con = torch.empty_like(g_cls)
                for r in _blocks(b, block):
                    rows = slice(j * b + r.start, j * b + r.stop)
                    x = X_all[t][r].to(dt).requires_grad_(True)
                    logits, c = terms.eval_rows(X_all[t], nbr, victim.take(sel, rows), r, x)
                    ce = ce_targeted(logits, target[r])
                    (g_cls[r],) = torch.autograd.grad(ce.sum(), x)
                    (g_con[r],) = torch.autograd.grad(c.sum(), x)
                    cls[bs, t, r], con[bs, t, r] = ce.detach(), c.detach()
                    margin[bs, t, r] = _margin(logits.detach(), target[r])
                g_prog = G_all[t].to(dt)
                grad_gap[bs, t] = _rel(g_prog, [(g_cls + c_[:, None, None] * g_con) / batch
                                                for c_ in cs])
                if t + 1 < T:
                    u = (-spec.lr) * adam.direction(g_prog)
                    upd_gap[bs, t] = _rel(X_all[t + 1].to(dt) - X_all[t].to(dt), [u])
        if not start_ok:
            grad_gap[bs] = upd_gap[bs] = 1.0
    yes, maybe = margin > TIE, margin > -TIE
    loss_gap = torch.empty(nb, T, b, dtype=dt, device=dev)
    for bs in range(nb):
        lp = rec.losses[bs].to(dt)
        gaps = []
        for c in consts[bs]:
            lr_ = cls[bs] + c[None] * con[bs]
            den = torch.maximum(lr_.abs(), lr_.abs().median(dim=1, keepdim=True).values)
            gaps.append((lp - lr_).abs() / den)
        loss_gap[bs] = torch.stack(gaps).amin(0)
    best = _best_gaps(rec, con, yes, maybe)
    grad_gap, upd_gap = grad_gap.reshape(-1, b), upd_gap.reshape(-1, b)
    return {"loss": torch.cat([loss_gap.reshape(-1, b), best[None]]),
            "step": torch.maximum(grad_gap, upd_gap), "grad": grad_gap, "update": upd_gap}


def _rel(got, wants):
    """|got - want| / |want| per cloud, the least over the candidates (0
    where both are 0)."""
    return torch.stack([(got - w).flatten(1).norm(dim=1)
                        / w.flatten(1).norm(dim=1).clamp_min(1e-300)
                        for w in wants]).amin(0)


def _margin(logits, target):
    tl = logits.gather(1, target[:, None])[:, 0]
    other = logits.scatter(1, target[:, None], float("-inf")).amax(1)
    return (tl - other) / logits.abs().amax(1).clamp_min(1.0)


def _search_states(spec, states, margins, b, dev):
    """The search's two (lower, upper, const) states [b] each at the start
    of search step len(margins): from all undecided success tests failing,
    and from each succeeding."""
    if states is None:  # float32, as the search keeps them
        lower = torch.zeros(b, dtype=torch.float32, device=dev)
        return [(lower, torch.full_like(lower, INF),
                 torch.full_like(lower, spec.initial_const))] * 2
    m = margins[-1]
    return [search_update(*states[0], (m > TIE).any(0)),
            search_update(*states[1], (m > -TIE).any(0))]


def _best_gaps(rec, con, yes, maybe):
    nb, T, b = con.shape
    dev = con.device
    gap = torch.zeros(b, dtype=con.dtype, device=dev)
    conf = con.reshape(nb * T, b)
    inf = torch.tensor(float("inf"), dtype=con.dtype, device=dev)
    hi = torch.where(yes.reshape(nb * T, b), conf, inf).amin(0)  # a sure success
    lo = torch.where(maybe.reshape(nb * T, b), conf, inf).amin(0)  # any possible
    succ = rec.success.bool()
    # a success flag the tests allow: success needs a possible success,
    # failure needs no sure one
    flag_bad = torch.where(succ, torch.isinf(lo), ~torch.isinf(hi))
    bl = rec.best_loss.to(con.dtype)
    below = torch.where(succ & ~torch.isinf(lo), (lo - bl).clamp_min(0) / lo.abs().clamp_min(1e-30), 0)
    above = torch.where(succ & ~torch.isinf(hi), (bl - hi).clamp_min(0) / hi.abs().clamp_min(1e-30), 0)
    gap = torch.maximum(below, above)
    # the best cloud is the cloud of the step the program names, and its
    # loss is that step's
    for i in torch.nonzero(succ).flatten().tolist():
        bs, t = int(rec.best_bs[i]), int(rec.best_step[i])
        if not (0 <= bs < nb and 0 <= t < T) or not torch.equal(
                rec.best_attack[i], rec.clouds[bs][t][i]):
            gap[i] = 1.0
            continue
        own = con[bs, t, i]
        gap[i] = torch.maximum(gap[i], (bl[i] - own).abs() / own.abs().clamp_min(1e-30))
    return torch.where(flag_bad, torch.ones_like(gap), gap)
