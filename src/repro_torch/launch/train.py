"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --batch 8 --seq-len 1024 --microbatches 2 --ckpt ck/

trains with ``use_pallas=True``, so on the card every causal attention
(and, for zamba2, every SSD scan) goes through the hand-written kernels,
on each rank's shards. ``--reduced --device cpu`` runs a tiny variant of
the same family on the host (the kernels' plain versions). The flags and
their defaults are the reference's (``--arch smollm-360m --strategy 2d
--model-axis 1``), plus ``--device``; the data are the reference's
synthetic token stream, with its stub patches (vlm) or frames (encdec)
beside the tokens.

Every family trains on a ("data", "model") DeviceMesh over the world
(``make_host_mesh``; a world of one NCCL rank on one card, of one gloo
rank on the host), under ``--strategy``; ``--autotune`` counts the step
under each of ``2d``, ``tp`` and ``zero3`` on that mesh (meta arguments,
``core/autotune.py``) and trains under the one the roofline ranks first.
Multi-rank:

  torchrun --nproc-per-node N -m repro_torch.launch.train --model-axis M
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Train as the flags say; returns ``run_training``'s result, with
    "mesh" ((names, shape)), "backend" (the process group's), "strategy"
    and, under ``--autotune``, "autotune" (its ``AutotuneResult``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--strategy", default="2d")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dataclasses import replace

    import torch.distributed as dist

    from ..configs import get_config, reduced as make_reduced
    from ..models.registry import build_model
    from ..sharding.rules import STRATEGIES
    from ..train.loop import TrainLoopConfig, run_training
    from ..train.optimizer import OptConfig
    from .mesh import init_world, make_host_mesh

    if args.strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {args.strategy!r}; one of "
                         f"{sorted(STRATEGIES)}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(replace(cfg, use_pallas=True))
    started = init_world(args.device)
    try:
        mesh = make_host_mesh(args.model_axis, args.device)
        first = dist.get_rank() == 0          # the rank that reports
        strategy, tuned = args.strategy, None
        if args.autotune:
            from ..configs.base import ShapeConfig
            from ..core.autotune import autotune_strategy
            tuned = autotune_strategy(
                model, ShapeConfig("tune", args.seq_len, args.batch,
                                   "train"), mesh)
            strategy = tuned.best
            if first:
                print(f"autotune picked strategy {strategy!r} "
                      f"(predicted {tuned.ranked[0][1]*1e3:.2f} ms/step)")
        out = run_training(
            model,
            TrainLoopConfig(steps=args.steps, batch=args.batch,
                            seq_len=args.seq_len, checkpoint_dir=args.ckpt,
                            checkpoint_every=args.ckpt_every, seed=args.seed,
                            strategy=strategy,
                            microbatches=args.microbatches),
            opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 5)),
            device=args.device, mesh=mesh,
            log_fn=print if first else (lambda *_: None))
        out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape))
        out["backend"] = dist.get_backend()
        out["strategy"] = strategy
        if tuned is not None:
            out["autotune"] = tuned
    finally:
        if started:
            dist.destroy_process_group()
    if first:
        print(f"final loss {out['losses'][-1]:.4f} over "
              f"{len(out['losses'])} steps; stragglers flagged: "
              f"{len(out['monitor'].flagged)}")
    return out


if __name__ == "__main__":
    main()
