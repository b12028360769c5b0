"""The training step: loss -> grad -> (optional accumulation) -> clip ->
AdamW (the port of ``repro.train.step``).

``n_microbatches > 1`` splits the batch along its first axis and
accumulates the gradients microbatch by microbatch, in the model's
``grad_dtype``, as the reference's ``lax.scan`` does: each microbatch's
gradient is divided by the count and added to the running sum. The step
updates the state IN PLACE (``train.optimizer.adamw_update``) and returns
it beside its metrics.

On a mesh the state's leaves and the batch are DTensors, and the step runs
inside the caller's ``activation_sharding`` scope. The loss is reduced to
every rank before the gradients are taken, and each gradient is
redistributed to its parameter's placements (a reduce-scatter under FSDP).
The step alone decides which rows form microbatch i. On one device they
are rows i * B / n ... (i + 1) * B / n - 1, as the reference's reshape has
them. A batch sharded over `data` is split PER SHARD: with D data ranks of
B / D rows each, microbatch i holds rows r * B / D + i * B / (D * n) ...
+ B / (D * n) - 1 of each rank r. The loss is a mean of equal-sized
microbatch means either way, so for most models the split changes only
the rounding, and it needs no communication. A MoE's routing (which tokens
overflow an expert) and its load-balance loss depend on which tokens share
a microbatch, so for a MoE a sharded batch is gathered once a step and
split by its global rows, as on one device.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from ..models.common import leaves, tree_map
from ..sharding.rules import to_local
from .optimizer import OptConfig, adamw_update, init_opt_state


def init_train_state(model, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    params = model.init(seed, device)
    return {"params": params,
            "opt": init_opt_state(params, model.cfg.opt_moment_dtype)}


def abstract_train_state(model) -> dict:
    """The train state's tree on the ``meta`` device."""
    params = model.abstract()
    mdt = getattr(torch, model.cfg.opt_moment_dtype)
    return {"params": params,
            "opt": {"m": tree_map(lambda _, p: torch.empty_like(p, dtype=mdt),
                                  params),
                    "v": tree_map(lambda _, p: torch.empty_like(
                        p, dtype=torch.float32), params),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}


def train_state_axes(model) -> dict:
    axes = model.param_axes()
    return {"params": axes, "opt": {"m": axes, "v": axes, "step": ()}}


def _rebuild(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _, __: next(it), tree)


def loss_and_grads(model, params, batch) -> tuple[torch.Tensor, list]:
    """(loss, the gradient of every parameter as a flat list in ``leaves``
    order). ``params`` itself is left untouched: the gradients are taken
    with respect to detached leaves sharing its storage."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = model.loss(_rebuild(params, flat), batch)
    if not isinstance(loss, DTensor):
        return loss.detach(), list(torch.autograd.grad(loss, flat))
    mesh = loss.device_mesh
    loss = loss.redistribute(mesh, [Replicate()] * mesh.ndim)
    grads = torch.autograd.grad(loss, flat)
    grads = [g.redistribute(mesh, p.placements) for g, p in zip(grads, flat)]
    return loss.detach().to_local(), grads


def _microbatches(v, n: int, global_rows: bool) -> list:
    """The n microbatches of a batch leaf, by rows of its first axis (a
    scalar is every microbatch's). A DTensor's rows are taken from each
    rank's own shard, or with ``global_rows`` from the gathered whole, each
    microbatch placed as ``v`` is."""
    if not v.dim():
        return [v] * n
    if not isinstance(v, DTensor):
        return list(v.chunk(n))
    mesh, pl = v.device_mesh, v.placements
    if global_rows:
        whole = v.redistribute(mesh, [Replicate()] * mesh.ndim)
        return [part.redistribute(mesh, pl) for part in whole.chunk(n)]
    return [DTensor.from_local(part, mesh, pl, run_check=False)
            for part in v.to_local().chunk(n)]


def make_train_step(model, opt_cfg: OptConfig, n_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    holds float32 scalars on the state's device: "loss", "grad_norm",
    "lr"."""
    gdt = getattr(torch, model.cfg.grad_dtype)
    global_rows = bool(model.cfg.n_experts)

    def accum_grads(params, batch):
        B = to_local(batch["tokens"]).shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} (per shard) does not split into "
                             f"{n_microbatches} microbatches")
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        acc = [torch.zeros_like(p, dtype=gdt) for p in leaves(params)]
        parts = {k: _microbatches(v, n_microbatches, global_rows)
                 for k, v in batch.items()}
        for i in range(n_microbatches):
            part = {k: v[i] for k, v in parts.items()}
            mb_loss, grads = loss_and_grads(model, params, part)
            for a, g in zip(map(to_local, acc), grads):
                g = to_local(g).float().div_(n_microbatches)
                if a.dtype == torch.float32:
                    a.add_(g)
                else:
                    a.copy_(a.float().add_(g))
            del grads
            loss = loss + mb_loss / n_microbatches
        return loss, acc

    def train_step(state, batch):
        params = state["params"]
        if n_microbatches > 1:
            loss, grads = accum_grads(params, batch)
        else:
            loss, grads = loss_and_grads(model, params, batch)
            if gdt != torch.float32:
                grads = [g.to(gdt) for g in grads]
        metrics = adamw_update(opt_cfg, params, _rebuild(params, grads),
                               state["opt"])
        return state, {**metrics, "loss": loss}

    return train_step
