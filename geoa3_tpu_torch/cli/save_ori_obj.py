"""Clean-mesh / clean-cloud exporter CLI of the port (counterpart of
geoa3_tpu/cli/save_ori_obj.py; reference
Provider/save_ori_obj.py:25-103).

Two modes:
  * --is_save_from_mat: dump every instance of a dense attack-set .mat as a
    plain .xyz file (reference :65-81);
  * mesh mode: walk a directory of OFF/OBJ meshes of the 10 attacked classes,
    normalise vertices to the unit sphere, and re-export normalised .obj
    meshes (reference :83-103; the reference reads ModelNet via a torch
    loader + pytorch3d — here plain file IO).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.io as sio

from geoa3_tpu_torch.data import io as gio
from geoa3_tpu_torch.data.modelnet import TEN_LABEL_INDEXES, TEN_LABEL_NAMES

# label remap from the 'modelnet40_1024_processed' ordering to the standard
# alphabetical ModelNet40 ids (reference save_ori_obj.py:45)
CONVERT_FROM_MODELNET40_1024_PROCESSED = [
    17, 24, 9, 37, 36, 20, 29, 13, 3, 22, 30, 5, 8, 31, 7, 12, 19, 21, 35,
    39, 11, 33, 16, 0, 27, 6, 2, 26, 1, 10, 34, 18, 14, 38, 4, 23, 32, 15,
    25, 28,
]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Saving ori obj mesh")
    parser.add_argument("--is_save_from_mat", action="store_true", default=False)
    parser.add_argument("--mat_path", default="Data/modelnet40_2111instances10000_PointNet.mat")
    parser.add_argument("--mesh_dir", default=None, type=str,
                        help="directory of {class}/{file}.off|.obj meshes")
    parser.add_argument("--outdir", default="Data", type=str)
    return parser


def main(cfg) -> str:
    if cfg.is_save_from_mat:
        dataset = sio.loadmat(cfg.mat_path)
        pcs = np.asarray(dataset["data"], np.float32)  # [N, 3, n]
        out = os.path.join(cfg.outdir, "All_class_ori_mesh")
        os.makedirs(out, exist_ok=True)
        for i in range(pcs.shape[0]):
            gio.save_xyz(os.path.join(out, f"{i}.xyz"), pcs[i].T)
        print(f"dumped {pcs.shape[0]} clouds -> {out}")
        return out

    assert cfg.mesh_dir, "mesh mode needs --mesh_dir"
    out = os.path.join(cfg.outdir, "Ten_class_ori_mesh")
    os.makedirs(out, exist_ok=True)
    count = 0
    for name in TEN_LABEL_NAMES:
        class_dir = os.path.join(cfg.mesh_dir, name)
        if not os.path.isdir(class_dir):
            continue
        label = TEN_LABEL_INDEXES[TEN_LABEL_NAMES.index(name)]
        for fname in sorted(os.listdir(class_dir)):
            path = os.path.join(class_dir, fname)
            if fname.endswith(".off"):
                verts, faces = gio.read_off(path)
                faces = [f[1:] for f in faces]  # strip the leading count
            elif fname.endswith(".obj"):
                verts, faces = gio.read_obj(path)
            else:
                continue
            v = gio.pc_normalize(np.asarray(verts, np.float32))
            gio.write_obj(
                os.path.join(out, f"{count}_{label}.obj"),
                v.tolist(),
                faces,
            )
            count += 1
    print(f"exported {count} normalised meshes -> {out}")
    return out


if __name__ == "__main__":
    args = build_parser().parse_args()
    print(args)
    main(args)
