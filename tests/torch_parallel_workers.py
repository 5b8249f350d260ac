"""Rank processes for tests/test_torch_parallel.py: torch and the port only.

    python -m tests.torch_parallel_workers CASE RANK WORLD DIR

Each rank reads DIR/inputs.pt, joins a gloo group of WORLD ranks through
the file DIR/store (no port to clash with other test processes), runs CASE
(attack, train or cli) and writes DIR/out_RANK.pt. `launch` starts the ranks, waits for them with
a time limit, kills them all if one fails or hangs, and returns their
outputs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT = 60  # seconds a collective may wait

# the engine modes held sharded against one process: (config, cloud points)
ATTACK = dict(attack_label="Untarget", classes=8, npoint=32, curv_loss_knn=4,
              binary_max_steps=2, iter_max_steps=10)
MODES = {
    "default": (dict(ATTACK), 32),
    "jitter": (dict(ATTACK, is_pre_jitter_input=True, jitter_k=8,
                    calculate_project_jitter_noise_iter=4, is_pro_grad=True,
                    cc_linf=0.02), 32),
    "subsample": (dict(ATTACK, npoint=32, is_subsample_opt=True, eval_num=3), 64),
    "partial_var": (dict(ATTACK, is_partial_var=True, knn_range=4,
                         partial_reinit_every=5), 32),
}


# the modes whose side draws a caller's `draws` replaces
DRAW_MODES = ("jitter", "subsample", "partial_var")


class SeededDraws:
    """A caller's `draws` (attack/engine.py) at the global batch's shape B,
    each drawn from a generator seeded by its site, so that two runs get
    the same numbers."""

    def __init__(self, B: int, n: int, cfg):
        self.B, self.n, self.cfg = B, n, cfg

    def _gen(self, *site):
        return torch.Generator().manual_seed(hash(site) % 2**31)

    def fps_start(self, bs_idx, step):
        return torch.randint(self.n, (self.B,), generator=self._gen(0, bs_idx, step))

    def eval_starts(self, bs_idx, step):
        return torch.randint(self.n, (self.cfg.eval_num, self.B),
                             generator=self._gen(1, bs_idx, step))

    def jitter_gauss(self, bs_idx, step, cloud):
        g = self._gen(2, bs_idx, step)
        shape = (self.B, cloud.shape[1], 1)
        return torch.randn(shape, generator=g), torch.randn(shape, generator=g)

    def patch_seed(self, bs_idx, phase):
        return int(torch.randint(self.n, (1,), generator=self._gen(3, bs_idx, phase)))

    def patch_offset(self, bs_idx, phase):
        return 1e-3 * torch.randn(self.B, self.cfg.knn_range, 3,
                                  generator=self._gen(4, bs_idx, phase))


def toy_victim(W: torch.Tensor, scale: float):
    """tests/test_parallel.py's victim: scale * max_n(pc @ W)."""
    def logits_fn(pc):
        return scale * (pc @ W.to(pc.dtype)).amax(dim=1)

    return logits_fn


def launch(case: str, world: int, workdir: Path, inputs: dict,
           timeout: float = 120) -> list:
    """Run CASE on WORLD gloo ranks; -> each rank's output. Raises if a rank
    fails or the group outlasts `timeout` seconds (every rank is killed)."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, workdir / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_workers", case, str(r),
         str(world), str(workdir)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.time() + timeout
    logs = [None] * world
    try:
        for r, p in enumerate(procs):
            logs[r] = p.communicate(timeout=max(1.0, deadline - time.time()))[0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError("ranks %s failed:\n%s" % (bad, "\n".join(
            (logs[r] or b"").decode()[-3000:] for r in bad)))
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False)
            for r in range(world)]


def _result(res) -> dict:
    return {k: v.clone() for k, v in res._asdict().items()}


def attack_case(inp: dict, mesh) -> dict:
    from geoa3_tpu_torch import parallel
    from geoa3_tpu_torch.attack import AttackConfig

    out = {"mesh": (mesh.size(0), mesh.size(1)),
           "rows": parallel.shard_batch(mesh, torch.arange(8)).tolist()}
    for key, bad in (("uneven", lambda: parallel.shard_batch(mesh, torch.zeros(3))),
                     ("too_big", lambda: parallel.make_mesh(2, 2))):
        try:
            bad()
        except ValueError as e:
            out[key] = str(e)
    victim = toy_victim(inp["W"], 2.0)
    j = inp["jax"]
    fn = parallel.make_sharded_attack_fn(
        victim, AttackConfig(**j["cfg"]), mesh,
        init_offset=lambda bs: j["offsets"][bs])
    out["jax"] = _result(fn(j["pc"], j["normal"], j["gt"], j["gt"]))
    judge = toy_victim(inp["W"], 2.5)
    fn = parallel.make_sharded_attack_fn(victim, AttackConfig(**j["cfg"]), mesh,
                                         eval_logits_fn=judge)
    out["judged"] = _result(fn(j["pc"], j["normal"], j["gt"], j["gt"],
                               torch.Generator().manual_seed(0)))
    for mode, m in inp["modes"].items():
        fn = parallel.make_sharded_attack_fn(victim, AttackConfig(**m["cfg"]), mesh)
        out[mode] = _result(fn(m["pc"], m["normal"], m["gt"], m["gt"],
                               torch.Generator().manual_seed(m["seed"])))
    for mode in DRAW_MODES:  # the side draws given by the caller
        m = inp["modes"][mode]
        cfg = AttackConfig(**m["cfg"])
        fn = parallel.make_sharded_attack_fn(
            victim, cfg, mesh, draws=SeededDraws(*m["pc"].shape[:2], cfg))
        out[f"draws_{mode}"] = _result(fn(m["pc"], m["normal"], m["gt"], m["gt"],
                                          torch.Generator().manual_seed(m["seed"])))
    return out


def train_case(inp: dict) -> dict:
    """Each run: one sharded train step in float64 from the given state."""
    from geoa3_tpu_torch import parallel
    from geoa3_tpu_torch import train as T
    from geoa3_tpu_torch.models import build_model

    out = {}
    for name, run in inp["runs"].items():
        cfg = T.TrainConfig(device="cpu", **run["cfg"])
        model = build_model(cfg.arch, cfg.classes, cfg.npoint, device="cpu").double()
        model.load_state_dict(run["state_dict"])
        state = T.TrainState(model.train(), T.make_optimizer(cfg, model))
        mesh = parallel.make_mesh(*run["mesh"])
        step, place = parallel.make_sharded_train_step(
            cfg, mesh, tensor_parallel=run["mesh"][1] > 1)
        local = place(state)
        rec = {}
        if run.get("eval"):
            # a split model refuses eval mode
            try:
                with torch.no_grad():
                    local.model.eval()(run["pc"])
            except RuntimeError as e:
                rec["eval"] = str(e)
            local.model.train()
        local, metrics = step(local, run["pc"], run["target"], keep=run["keep"])
        opt = local.optimizer
        rec.update(
            loss=metrics["loss"], acc=metrics["acc"],
            params={k: p.detach().clone() for k, p in local.model.named_parameters()},
            grads={k: p.grad.clone() for k, p in local.model.named_parameters()},
            buffers={k: b.clone() for k, b in local.model.named_buffers()},
            moments={k: opt.state[p]["exp_avg"].shape
                     for k, p in local.model.named_parameters()},
            coords=(mesh.get_local_rank("data"), mesh.get_local_rank("model")))
        out[name] = rec
    return out


def cli_case(inp: dict, rank: int) -> dict:
    """The attack CLI with --mesh_data_parallel on this rank's arguments,
    inside this group (the CLI keeps a group that exists); its standard
    output kept."""
    import contextlib
    import io

    from geoa3_tpu_torch.cli.main_attack import build_parser, main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        saved = cli_main(build_parser().parse_args(inp["argv"][rank]))
    return {"saved": saved, "stdout": buf.getvalue()}


def main(case: str, rank: int, world: int, workdir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    from geoa3_tpu_torch import parallel

    parallel.init_distributed(device="cpu", timeout=GROUP_TIMEOUT,
                              init_method=f"file://{workdir}/store")
    inp = torch.load(Path(workdir) / "inputs.pt", weights_only=False)
    if case == "attack":
        out = attack_case(inp, parallel.make_mesh())
    elif case == "train":
        out = train_case(inp)
    elif case == "cli":
        out = cli_case(inp, rank)
    else:
        raise ValueError(case)
    torch.save(out, Path(workdir) / f"out_{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
