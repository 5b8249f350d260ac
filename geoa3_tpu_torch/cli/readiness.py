"""Real-data readiness drill of the port (counterpart of
geoa3_tpu/cli/readiness.py): one command that proves, or cleanly skips,
everything needed to run the port on real ModelNet40 assets.

    python -m geoa3_tpu_torch.cli.readiness \\
        --checkpoint /path/to/model_best.pth.tar \\
        --modelnet_root /data/modelnet40_normal_resampled \\
        [--data_dir_file /path/to/attack_set.mat] \\
        [--reference_dir /path/to/reference/Model]

Steps (each prints PASS / FAIL / SKIP-with-reason; exit 0 iff no FAIL):
  1. convert      — load the checkpoint into the victim
                    (utils/checkpoint.py:load_victim_state);
  2. torch_parity — the port's logits against the upstream PyTorch
                    PointNet loaded from the same state dict (needs the
                    reference's Model/ sources: `--reference_dir`);
  3. clean_acc    — distill the attack set from the ModelNet40 test split
                    (reference gen_data_mat.py:230-306) and report the
                    per-class distilled counts (needs `--modelnet_root`);
  4. attack_smoke — one batch of up to 4 clouds, a tiny budget, through the
                    port's attack engine on the distilled (or given) .mat.
The victim runs on the card (`--device cuda`, the default) unless
`--device cpu` is given; without a CUDA device the default fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from geoa3_tpu_torch.device import entry_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Real-data readiness drill")
    p.add_argument("--checkpoint", default=None, type=str,
                   help=".pth.tar checkpoint (file or dir)")
    p.add_argument("--modelnet_root", default=None, type=str,
                   help="modelnet40_normal_resampled root (txt split format)")
    p.add_argument("--data_dir_file", default=None, type=str,
                   help="existing .mat attack set (skips distillation input)")
    p.add_argument("--reference_dir", default=None, type=str,
                   help="the upstream repository's Model/ sources (PointNet.py)")
    p.add_argument("--arch", default="PointNet", type=str)
    p.add_argument("--npoint", default=1024, type=int)
    p.add_argument("--classes", default=40, type=int)
    p.add_argument("--max_out_num", default=25, type=int)
    p.add_argument("--parity_atol", default=5e-4, type=float)
    p.add_argument("--device", default="cuda", type=str,
                   help="where the victim runs: cuda (default) or cpu")
    p.add_argument("--out", default=None, type=str,
                   help="write the JSON report here as well")
    return p


def _status(report, step, status, detail):
    report[step] = {"status": status, "detail": detail}
    print(f"[{status}] {step}: {detail}", flush=True)


def _convert(args, report, device):
    """Step 1 -> the victim in eval mode, or None."""
    from geoa3_tpu_torch.models import build_model
    from geoa3_tpu_torch.models.convert import load_reference_state_dict
    from geoa3_tpu_torch.utils.checkpoint import load_victim_state

    if not args.checkpoint:
        _status(report, "convert", "SKIP", "--checkpoint not given")
    elif not os.path.exists(args.checkpoint):
        _status(report, "convert", "SKIP",
                f"checkpoint path absent: {args.checkpoint}")
    else:
        try:
            state = load_victim_state(args.checkpoint, arch=args.arch)
            model = build_model(args.arch, args.classes, args.npoint, device=device)
            load_reference_state_dict(model, state)
            model.requires_grad_(False)
            n = sum(int(v.numel()) for v in state.values())
            _status(report, "convert", "PASS", f"loaded ({n} scalars)")
            return model
        except Exception as e:  # conversion failures must be loud
            _status(report, "convert", "FAIL", f"{type(e).__name__}: {e}")
    return None


def _torch_parity(args, report, model, device):
    if model is None:
        _status(report, "torch_parity", "SKIP", "no converted checkpoint")
    elif args.arch != "PointNet":
        _status(report, "torch_parity", "SKIP",
                "drill implements PointNet only; run the PointNet++ parity tests")
    elif not args.reference_dir:
        _status(report, "torch_parity", "SKIP",
                "reference sources not given (--reference_dir)")
    elif not os.path.isdir(args.reference_dir):
        _status(report, "torch_parity", "SKIP",
                f"reference sources absent: {args.reference_dir}")
    else:
        try:
            import types

            from geoa3_tpu_torch.utils.checkpoint import load_victim_state

            if "torchvision" not in sys.modules:
                tv = types.ModuleType("torchvision")
                tv.models = types.ModuleType("torchvision.models")
                sys.modules["torchvision"] = tv
                sys.modules["torchvision.models"] = tv.models
            sys.path.insert(0, args.reference_dir)
            from PointNet import PointNet as TorchPointNet

            tm = TorchPointNet(args.classes, npoint=args.npoint)
            tm.load_state_dict(load_victim_state(args.checkpoint, "PointNet"))
            tm.eval()
            pc = np.random.RandomState(0).randn(4, args.npoint, 3).astype(np.float32)
            with torch.no_grad():
                want = tm(torch.from_numpy(pc.transpose(0, 2, 1))).numpy()
                got = model(torch.from_numpy(pc).to(device)).cpu().numpy()
            err = float(np.abs(got - want).max())
            ok = err <= args.parity_atol or np.allclose(
                got, want, atol=args.parity_atol, rtol=1e-3)
            _status(report, "torch_parity", "PASS" if ok else "FAIL",
                    f"max logits err {err:.2e} (atol {args.parity_atol})")
        except Exception as e:
            _status(report, "torch_parity", "FAIL", f"{type(e).__name__}: {e}")


def _logits_fn(model, device):
    def logits_fn(pc):
        with torch.no_grad():
            return model(torch.from_numpy(np.ascontiguousarray(pc)).to(device)).cpu().numpy()

    return logits_fn


def _clean_acc(args, report, model, device):
    """Step 3 -> the .mat path of the distilled set, or None."""
    if model is None:
        _status(report, "clean_acc", "SKIP", "no converted checkpoint")
    elif not args.modelnet_root:
        _status(report, "clean_acc", "SKIP", "--modelnet_root not given")
    elif not os.path.isdir(args.modelnet_root):
        _status(report, "clean_acc", "SKIP", f"root absent: {args.modelnet_root}")
    else:
        try:
            import scipy.io as sio

            from geoa3_tpu_torch.data.gen_data_mat import distill_attack_set
            from geoa3_tpu_torch.data.modelnet_train import ModelNetTrainDataset
            from geoa3_tpu_torch.data.synthetic import TEN_LABEL_INDEXES

            ds = ModelNetTrainDataset(
                root=args.modelnet_root, batch_size=1, npoints=args.npoint,
                split="test", normal_channel=True, shuffle=False,
            )

            def instances():
                for i in range(len(ds)):
                    ps, lab = ds[i]
                    yield ps[:, 0:3], ps[:, 3:6], int(lab)

            out = distill_attack_set(instances(), _logits_fn(model, device),
                                     max_out_num=args.max_out_num, axis_swap=True)
            labels = out["label"].reshape(-1)
            counts = {int(c): int((labels == c).sum()) for c in TEN_LABEL_INDEXES}
            n = len(labels)
            full = args.max_out_num * len(TEN_LABEL_INDEXES)
            # every distilled instance is victim-correct by construction;
            # readiness requires the set to be full (the reference's 250)
            mat_path = args.data_dir_file or os.path.join(
                tempfile.gettempdir(),
                f"readiness_{n}instances{args.npoint}_{args.arch}.mat",
            )
            sio.savemat(mat_path, out)
            _status(report, "clean_acc", "PASS" if n == full else "FAIL",
                    f"distilled {n}/{full} instances, per-class {counts}; "
                    f"saved {mat_path}")
            return mat_path
        except Exception as e:
            _status(report, "clean_acc", "FAIL", f"{type(e).__name__}: {e}")
    return None


def _attack_smoke(args, report, model, device, mat_path):
    if model is None:
        _status(report, "attack_smoke", "SKIP", "no converted checkpoint")
    elif not mat_path or not os.path.isfile(mat_path):
        _status(report, "attack_smoke", "SKIP", "no attack set (.mat) available")
    else:
        try:
            import scipy.io as sio

            from geoa3_tpu_torch.attack import AttackConfig
            from geoa3_tpu_torch.attack.engine import make_attack_fn
            from geoa3_tpu_torch.models import make_eval_fn

            d = sio.loadmat(mat_path)
            dev = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
            pc = d["data"].transpose(0, 2, 1).astype(np.float32)[:4]
            nrm = d["normal"].transpose(0, 2, 1).astype(np.float32)[:4]
            gt = d["label"].reshape(-1).astype(np.int64)[:4]
            tgt = (gt + 1) % args.classes
            cfg = AttackConfig(
                attack_label="All", classes=args.classes, npoint=pc.shape[1],
                binary_max_steps=1, iter_max_steps=5,
                curv_loss_knn=min(16, pc.shape[1] - 1),
            )
            fn = make_attack_fn(make_eval_fn(model), cfg, host_binary_loop=True)
            res = fn(dev(pc, torch.float32), dev(nrm, torch.float32),
                     dev(gt, torch.int64), dev(tgt, torch.int64),
                     torch.Generator(device=device).manual_seed(0))
            adv = res.best_attack.cpu().numpy()
            assert adv.shape == pc.shape and np.isfinite(adv).all()
            _status(report, "attack_smoke", "PASS",
                    f"1 batch of {pc.shape[0]} through the engine "
                    f"(success flags {res.success.cpu().tolist()})")
        except Exception as e:
            _status(report, "attack_smoke", "FAIL", f"{type(e).__name__}: {e}")


def main(args) -> int:
    device = entry_device(args.device)
    report: dict = {}
    model = _convert(args, report, device)
    _torch_parity(args, report, model, device)
    mat_path = _clean_acc(args, report, model, device) or args.data_dir_file
    _attack_smoke(args, report, model, device, mat_path)

    failed = [k for k, v in report.items() if v["status"] == "FAIL"]
    skipped = [k for k, v in report.items() if v["status"] == "SKIP"]
    verdict = "NOT READY" if failed else (
        "READY" if not skipped else "PARTIAL (skips above)"
    )
    print(f"readiness: {verdict}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"verdict": verdict, "steps": report}, f, indent=2)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(build_parser().parse_args()))
