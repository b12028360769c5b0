"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 200 --batch 8 --seq-len 1024 --microbatches 2 --ckpt ck/

trains with ``use_pallas=True``, so on the card every causal attention
(and, for zamba2, every SSD scan) goes through the hand-written kernels.
``--reduced --device cpu`` runs a tiny variant of the same family on the
host (the kernels' plain versions). The flags and their defaults are the
reference's (``--arch smollm-360m``), plus ``--device``; the data are the
reference's synthetic token stream, with its stub patches (vlm) or frames
(encdec) beside the tokens. The port runs on one device: ``--autotune`` (ROADMAP item 10), a
``--strategy`` other than ``single`` and a ``--model-axis`` above 1 (item
11.7) raise.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    """Train as the flags say; returns ``run_training``'s result."""
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
    ap.add_argument("--strategy", default="single")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.autotune:
        raise NotImplementedError("--autotune needs the cost model of "
                                  "ROADMAP item 10, not ported yet")
    if args.strategy != "single" or args.model_axis != 1:
        raise NotImplementedError(
            f"the port trains on one device; strategy {args.strategy!r} with "
            f"model axis {args.model_axis} waits for ROADMAP item 11.7")

    from dataclasses import replace

    from ..configs import get_config, reduced as make_reduced
    from ..models.registry import build_model
    from ..train.loop import TrainLoopConfig, run_training
    from ..train.optimizer import OptConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(replace(cfg, use_pallas=True))
    out = run_training(
        model,
        TrainLoopConfig(steps=args.steps, batch=args.batch,
                        seq_len=args.seq_len, checkpoint_dir=args.ckpt,
                        checkpoint_every=args.ckpt_every, seed=args.seed,
                        microbatches=args.microbatches),
        opt_cfg=OptConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(args.steps // 20, 5)),
        device=args.device)
    print(f"final loss {out['losses'][-1]:.4f} over {len(out['losses'])} steps"
          f"; stragglers flagged: {len(out['monitor'].flagged)}")
    return out


if __name__ == "__main__":
    main()
