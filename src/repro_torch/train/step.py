"""The training step: loss -> grad -> (optional accumulation) -> clip ->
AdamW (the port of ``repro.train.step``).

``n_microbatches > 1`` splits the batch along its first axis and
accumulates the gradients microbatch by microbatch, in the model's
``grad_dtype``, as the reference's ``lax.scan`` does: each microbatch's
gradient is divided by the count and added to the running sum. The step
updates the state IN PLACE (``train.optimizer.adamw_update``) and returns
it beside its metrics.
"""
from __future__ import annotations

import torch

from ..models.common import leaves, tree_map
from .optimizer import OptConfig, adamw_update, init_opt_state


def init_train_state(model, seed: int = 0,
                     device: str | torch.device = "cuda") -> dict:
    params = model.init(seed, device)
    return {"params": params,
            "opt": init_opt_state(params, model.cfg.opt_moment_dtype)}


def _rebuild(tree, flat: list):
    it = iter(flat)
    return tree_map(lambda _, __: next(it), tree)


def loss_and_grads(model, params, batch) -> tuple[torch.Tensor, list]:
    """(loss, the gradient of every parameter as a flat list in ``leaves``
    order). ``params`` itself is left untouched: the gradients are taken
    with respect to detached leaves sharing its storage."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = model.loss(_rebuild(params, flat), batch)
    return loss.detach(), list(torch.autograd.grad(loss, flat))


def make_train_step(model, opt_cfg: OptConfig, n_microbatches: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``; metrics
    holds float32 scalars on the state's device: "loss", "grad_norm",
    "lr"."""
    gdt = getattr(torch, model.cfg.grad_dtype)

    def accum_grads(params, batch):
        B = batch["tokens"].shape[0]
        if B % n_microbatches:
            raise ValueError(f"batch {B} does not split into "
                             f"{n_microbatches} microbatches")
        mb = B // n_microbatches
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        acc = [torch.zeros_like(p, dtype=gdt) for p in leaves(params)]
        for i in range(n_microbatches):
            part = {k: v[i * mb:(i + 1) * mb] if v.dim() else v
                    for k, v in batch.items()}
            mb_loss, grads = loss_and_grads(model, params, part)
            for a, g in zip(acc, grads):
                g = g.float().div_(n_microbatches)
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
