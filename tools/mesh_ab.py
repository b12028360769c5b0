#!/usr/bin/env python3
"""The mesh path's cost on one CUDA card for one checkout of the
PyTorch/CUDA port: that checkout's ``chip_smoke.py`` phases
``lm_dense_train`` and ``mesh_parity`` (smollm-360m at full width, 4 steps
of 8 x 1024 through ``launch.train.main`` on a 1 x 1 NCCL mesh, then the
same steps on plain tensors) and, unless ``--dense-only``,
``lm_families_mesh``. With ``--families``, ``lm_families`` and
xlstm-125m's times (``xlstm_times``) take the dense phases' place.

    python3 tools/mesh_ab.py [--root DIR] [--dense-only | --families]

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
import json
import sys
import time
from dataclasses import replace
from pathlib import Path


def xlstm_times(cs, dev) -> dict:
    """xlstm-125m as ``lm_families`` runs it (full width, FAMILY_CUTS's
    depth, the same seeds and optimizer): four prefills of FAMILY_BATCH x
    FAMILY_PROMPT tokens, ms each (the first warms up), then three
    training steps of FAMILY_TRAIN's batch, seconds and loss each, all
    synchronised with the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import make_train_step

    arch = "xlstm-125m"
    cfg = replace(get_config(arch), use_pallas=True, **cs.FAMILY_CUTS[arch])
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    batch = model.make_batch(ShapeConfig(
        "serve", cs.FAMILY_PROMPT, cs.FAMILY_BATCH, "prefill"), seed=0,
        device=dev)
    prefill = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
    mb_batch, seq = cs.FAMILY_TRAIN[arch]
    train_batch = model.make_batch(ShapeConfig(
        "train", seq, mb_batch * cfg.microbatches, "train"), seed=1,
        device=dev)
    state = {"params": params, "opt": init_opt_state(params)}
    step = make_train_step(model, OptConfig(lr=1e-4, total_steps=10,
                                            warmup_steps=1),
                           n_microbatches=cfg.microbatches)
    train_s, losses = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, train_batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
    return {"prefill_ms": prefill, "train_s": train_s, "losses": losses}


def main() -> int:
    ap = argparse.ArgumentParser(
        description="The mesh path's cost on one CUDA card, one checkout.")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--dense-only", action="store_true")
    ap.add_argument("--families", action="store_true",
                    help="lm_families and xlstm-125m's times in place of "
                         "the dense phases")
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
    if args.families:
        cs.lm_families_phase(dev, smi)
        print(json.dumps({"phase": "xlstm_times", "root": str(root),
                          **xlstm_times(cs, dev)}), flush=True)
    else:
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
