"""The training loop on one device (the port of ``repro.train.loop``): the
data pipeline, the train step, checkpoints and the step monitor, with
resume from the newest checkpoint.

The reference places the state and batches on a mesh under a sharding
strategy; the port runs on one device, and meshes and strategies come with
ROADMAP item 11.7.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.synthetic import DataPipeline, SyntheticLM
from ..runtime.monitor import StepMonitor, Timer
from .optimizer import OptConfig
from .step import init_train_state, make_train_step


@dataclass
class TrainLoopConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    microbatches: int = 1
    resume: bool = True


def run_training(model, loop_cfg: TrainLoopConfig,
                 opt_cfg: OptConfig | None = None,
                 monitor: StepMonitor | None = None, log_fn=print,
                 crash_at_step: int | None = None,
                 device: str | torch.device = "cuda") -> dict:
    """Train; returns {"state", "losses", "monitor", "resumed_from"}.
    ``crash_at_step`` raises after that step (fault-tolerance tests). A
    step's time is host clock around the step and the read of its loss,
    which waits for the card."""
    opt_cfg = opt_cfg or OptConfig(total_steps=loop_cfg.steps,
                                   warmup_steps=max(loop_cfg.steps // 20, 5))
    ckpt = None
    start_step = 0
    resumed_from = None
    state = None
    if loop_cfg.checkpoint_dir:
        ckpt = CheckpointManager(loop_cfg.checkpoint_dir)
        if loop_cfg.resume and ckpt.latest_step() is not None:
            start_step, state = ckpt.restore(device=device)
            resumed_from = start_step
            log_fn(f"resumed from step {start_step}")
    if state is None:
        state = init_train_state(model, loop_cfg.seed, device)

    step_fn = make_train_step(model, opt_cfg,
                              n_microbatches=loop_cfg.microbatches)
    gen = SyntheticLM(model.cfg.vocab, seed=loop_cfg.seed)
    extra_fn, transform = _extra_inputs_fn(model.cfg, loop_cfg.seq_len)
    pipe = DataPipeline(gen, loop_cfg.batch, loop_cfg.seq_len, device=device,
                        start_index=start_step, extra_fn=extra_fn,
                        transform=transform)
    monitor = monitor or StepMonitor()
    losses = []
    try:
        for step in range(start_step, loop_cfg.steps):
            _, batch = next(pipe)
            with Timer() as t:
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
            monitor.observe(step, t.seconds)
            losses.append(loss)
            if step % loop_cfg.log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"({t.seconds * 1e3:.0f} ms)")
            if crash_at_step is not None and step == crash_at_step:
                raise RuntimeError(f"injected crash at step {step}")
            if ckpt and (step + 1) % loop_cfg.checkpoint_every == 0:
                ckpt.save(step + 1, state, {"loss": loss})
    finally:
        pipe.close()
        if ckpt:
            ckpt.wait()
    return {"state": state, "losses": losses, "monitor": monitor,
            "resumed_from": resumed_from}


def _extra_inputs_fn(cfg, seq_len: int):
    """(extra_fn, transform) for the multi-modal stub inputs, the
    reference's: a VLM's patch embeddings (its image share of ``seq_len``;
    the text trimmed to the rest) and an enc-dec's frames, float32 normal
    draws x 0.05 from their own seeded streams."""
    if cfg.family == "vlm":
        aux_len = int(seq_len * cfg.img_token_frac)
        text_len = seq_len - aux_len

        def patches(index, local_batch):
            rng = np.random.default_rng((7, index))
            return {"patch_embeds": (rng.normal(
                size=(local_batch, aux_len, cfg.patch_dim)) * 0.05
            ).astype(np.float32)}

        def trim(out):
            out["tokens"] = out["tokens"][:, :text_len]
            if "labels" in out:
                out["labels"] = out["labels"][:, :text_len]
            return out
        return patches, trim
    if cfg.family == "encdec":
        def frames(index, local_batch):
            rng = np.random.default_rng((11, index))
            return {"frames": (rng.normal(
                size=(local_batch, seq_len, cfg.d_model)) * 0.05
            ).astype(np.float32)}
        return frames, None
    return None, None
