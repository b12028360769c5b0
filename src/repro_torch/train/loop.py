"""The training loop (the port of ``repro.train.loop``): the data
pipeline, the train step, checkpoints and the step monitor, with resume
from the newest checkpoint.

With a ``mesh`` (a ("data", "model") DeviceMesh) the state is distributed
by ``tree_shardings(train_state_axes(model), mesh, strategy, ...)``, as the
reference places it: every rank builds the whole state from the seed and
keeps its shards. Batches are placed by the model's ``input_axes``: every
rank makes the same global batch from the seed and keeps its shard. The
step runs inside ``activation_sharding(mesh, strategy)``. Without a mesh
the state and batches are plain tensors on ``device``.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..data.synthetic import DataPipeline, SyntheticLM
from ..runtime.monitor import StepMonitor, Timer
from ..sharding.context import activation_sharding
from ..sharding.rules import distribute, distribute_tree, tree_shardings
from .optimizer import OptConfig
from .step import (abstract_train_state, init_train_state, make_train_step,
                   train_state_axes)


@dataclass
class TrainLoopConfig:
    steps: int = 100
    batch: int = 8
    seq_len: int = 128
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    strategy: str = "2d"
    microbatches: int = 1
    resume: bool = True


def run_training(model, loop_cfg: TrainLoopConfig,
                 opt_cfg: OptConfig | None = None,
                 monitor: StepMonitor | None = None, log_fn=print,
                 crash_at_step: int | None = None,
                 device: str | torch.device = "cuda", mesh=None) -> dict:
    """Train; returns {"state", "losses", "grad_norms", "monitor",
    "resumed_from"}. ``crash_at_step`` raises after that step
    (fault-tolerance tests). A step's time is host clock around the step
    and the read of its loss, which waits for the card."""
    from ..configs.base import ShapeConfig

    opt_cfg = opt_cfg or OptConfig(total_steps=loop_cfg.steps,
                                   warmup_steps=max(loop_cfg.steps // 20, 5))
    state_pl = batch_pl = None
    if mesh is not None:
        shape = ShapeConfig("loop", loop_cfg.seq_len, loop_cfg.batch, "train")
        state_pl = tree_shardings(train_state_axes(model), mesh,
                                  loop_cfg.strategy,
                                  abstract_train_state(model))
        batch_pl = tree_shardings(model.input_axes(shape), mesh,
                                  loop_cfg.strategy,
                                  model.abstract_inputs(shape))
    ckpt = None
    start_step = 0
    resumed_from = None
    state = None
    if loop_cfg.checkpoint_dir:
        ckpt = CheckpointManager(loop_cfg.checkpoint_dir)
        if loop_cfg.resume and ckpt.latest_step() is not None:
            start_step, state = ckpt.restore(placements=state_pl, mesh=mesh,
                                             device=device)
            resumed_from = start_step
            log_fn(f"resumed from step {start_step}")
    if state is None:
        state = init_train_state(model, loop_cfg.seed, device)
        if mesh is not None:
            state = distribute_tree(state, mesh, state_pl)

    step_fn = make_train_step(model, opt_cfg,
                              n_microbatches=loop_cfg.microbatches)
    gen = SyntheticLM(model.cfg.vocab, seed=loop_cfg.seed)
    extra_fn, transform = _extra_inputs_fn(model.cfg, loop_cfg.seq_len)
    pipe = DataPipeline(gen, loop_cfg.batch, loop_cfg.seq_len, device=device,
                        start_index=start_step, extra_fn=extra_fn,
                        transform=transform)
    monitor = monitor or StepMonitor()

    def scope():
        if mesh is None:
            return contextlib.nullcontext()
        return activation_sharding(mesh, loop_cfg.strategy)

    losses, grad_norms = [], []
    try:
        for step in range(start_step, loop_cfg.steps):
            _, batch = next(pipe)
            if mesh is not None:
                batch = {k: distribute(v, mesh, batch_pl[k])
                         for k, v in batch.items()}
            with Timer() as t, scope():
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
            monitor.observe(step, t.seconds)
            losses.append(loss)
            grad_norms.append(float(metrics["grad_norm"]))
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
    return {"state": state, "losses": losses, "grad_norms": grad_norms,
            "monitor": monitor, "resumed_from": resumed_from}


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
