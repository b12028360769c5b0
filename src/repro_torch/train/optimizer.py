"""AdamW with a cosine schedule, global-norm clipping and weight-decay
masking (the port of ``repro.train.optimizer``), as functions over nested
dicts of tensors.

The state mirrors the params (m in ``moment_dtype``, v in float32) plus an
int32 step. ``adamw_update`` updates the params and the moments IN PLACE
(the reference returns new trees): at full width each tree is 9.8 GB, and a
second copy of params and moments would not fit beside the gradients.

Numbers follow the reference's float32 arithmetic: the step, ``b1 ** step``,
the bias corrections and the cosine are float32 tensors, not Python
doubles, and weight decay applies to every parameter with more than one
dimension, which includes zamba2's stacked (G, E, d) norm weights.

On a mesh the params, gradients and moments are DTensors with the same
placements (``train.step`` redistributes each gradient to its parameter's)
and the step a replicated DTensor: the update is elementwise, so it runs
on each rank's local shards, and only the clipping norm is reduced, to the
GLOBAL norm over every shard.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from ..models.common import leaves, tree_map
from ..sharding.rules import to_local


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_frac``; a float32 tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(params, moment_dtype: str = "float32") -> dict:
    mdt = getattr(torch, moment_dtype)
    first = leaves(params)[0]
    return {
        "m": tree_map(lambda _, p: torch.zeros_like(p, dtype=mdt), params),
        "v": tree_map(lambda _, p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree) -> torch.Tensor:
    """The 2-norm over every leaf, a plain float32 tensor; a DTensor leaf's
    sum of squares is reduced over its shards."""
    sums = []
    for x in leaves(tree):
        sq = x.float().square().sum()
        sums.append(sq.full_tensor() if isinstance(sq, DTensor) else sq)
    return torch.sqrt(torch.stack(sums).sum())


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, in float32;
    the norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda _, g: g.float() * scale, grads), norm


@torch.no_grad()
def adamw_update(cfg: OptConfig, params, grads, state) -> dict:
    """One AdamW step, IN PLACE: ``params``, ``state["m"]`` and
    ``state["v"]`` are updated and ``state["step"]`` is replaced by the new
    step. grads in any dtype (the same tree as params); moments and updates
    in float32; params keep their dtype. Returns {"grad_norm", "lr"}."""
    step = to_local(state["step"]) + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()
    for p, g, m, v in zip(*(map(to_local, leaves(t)) for t in (
            params, grads, state["m"], state["v"]))):
        g = g.float() * scale
        mf = m.float()                   # m itself when m is float32
        mf.mul_(b1).add_((1 - b1) * g)
        if mf is not m:
            m.copy_(mf)
        v.mul_(b2).add_((1 - b2) * (g * g))
        del g
        delta = (m.float() / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
        decay = cfg.weight_decay if p.dim() > 1 else 0.0
        pf = p.float()                   # p itself when p is float32
        pf.mul_(1 - lr * decay).sub_(lr * delta)
        if pf is not p:
            p.copy_(pf)
    old = state["step"]
    state["step"] = step if not isinstance(old, DTensor) else \
        DTensor.from_local(step, old.device_mesh, old.placements,
                           run_check=False)
    return {"grad_norm": gnorm, "lr": lr}
