#!/usr/bin/env python3
"""The mesh path's cost on one CUDA card for one checkout of the
PyTorch/CUDA port: that checkout's ``chip_smoke.py`` phases
``lm_dense_train`` and ``mesh_parity`` (smollm-360m at full width, 4 steps
of 8 x 1024 through ``launch.train.main`` on a 1 x 1 NCCL mesh, then the
same steps on plain tensors) and, unless ``--dense-only``,
``lm_families_mesh``.

    python3 tools/mesh_ab.py [--root DIR] [--dense-only]

Imports ``chip_smoke`` and ``repro_torch`` from the checkout at DIR
(default: this one), builds its attention kernel, and prints each phase's
JSON line (the mesh and plain step ms, launches, whether the losses agree
bit for bit). Two commits compare on one card, in turns:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 tools/mesh_ab.py --root $r; done

Without a CUDA device it exits 2 before printing any result.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(
        description="The mesh path's cost on one CUDA card, one checkout.")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dense-only", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("mesh_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    import torch.distributed as dist
    from repro_torch.kernels.attention import kernel as ak
    from repro_torch.launch.mesh import init_world

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ak.build()
    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    if not init_world(dev):
        raise AssertionError("no world of one rank")
    dense = cs.lm_dense_train_phase(dev, smi)
    cs.mesh_parity_phase(dev, dense, smi)
    dist.destroy_process_group()
    if not args.dense_only:
        cs.lm_families_mesh_phase(dev, smi)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
