"""Activation-sharding context (the port of ``repro.sharding.context``).

Model code annotates ACTIVATIONS with logical axes through
``constrain(x, axes)``. Inside an ``activation_sharding(mesh, strategy)``
scope a DTensor is redistributed to the placements the rules give those
axes, as the reference's ``with_sharding_constraint`` pins GSPMD's
propagation; outside a scope, and on a plain tensor, it is a no-op, so
one-device runs and every test without a mesh pay nothing.

Activation axis names are distinct from parameter axes: a parameter's
``embed`` dim shards over `data` (FSDP storage), while an activation's
feature dim is replicated.

Tensors the model makes itself (rotary tables, masks, position ids) are
plain tensors; where they meet a DTensor, ``on_mesh`` makes them
replicated DTensors on its mesh (every rank made the same values).

A product that contracts heads with a weight sharded over (heads,
head_dim) runs on each rank's shards (``product_on_shards``): DTensor
cannot unflatten a sharded ``heads x head_dim`` dimension into a head
count that the mesh dimension does not divide (smollm's 15 heads on a
model axis of 2).
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .rules import STRATEGIES, placements, spec_for_axes

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)

# activation-axis additions merged into every named strategy
_ACT_AXES = {
    "act_batch": ("pod", "data"),
    "act_seq": (),
    "act_embed": (),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_kv_seq": ("model",),   # context-parallel attention (kv seq axis)
    "act_mlp": ("model",),
    "act_vocab": ("model",),
    "act_expert": ("model",),
    "act_expert_cap": ("model",),
    "act_inner": ("model",),
}
for _name, _s in STRATEGIES.items():
    for k, v in _ACT_AXES.items():
        _s.setdefault(k, v)
# sequence-parallel strategy shards activation seq over model
STRATEGIES["sp"]["act_seq"] = ("model",)


@contextlib.contextmanager
def activation_sharding(mesh, strategy: str | dict):
    strat = STRATEGIES[strategy] if isinstance(strategy, str) else strategy
    token = _CTX.set((mesh, strat))
    try:
        yield
    finally:
        _CTX.reset(token)


def current_ctx():
    """(mesh, strategy dict) of the active scope, or None."""
    return _CTX.get()


def constrain(x, axes: tuple):
    """Redistribute the DTensor ``x`` to the placements of the logical
    ``axes`` (activation axis names; None = replicated dim). A no-op
    outside a scope and on a plain tensor."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, strat = ctx
    want = placements(spec_for_axes(tuple(axes), strat, mesh,
                                    tuple(x.shape)), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_tree(tree, axes_tree):
    """``constrain`` over a nested dict (one layer's weight slices) with
    the same structure of axes."""
    if _CTX.get() is None:
        return tree
    if isinstance(tree, dict):
        return {k: constrain_tree(v, axes_tree[k]) for k, v in tree.items()}
    return constrain(tree, axes_tree)


def in_scope(fn):
    """``fn`` bound to the active scope (itself outside one): it runs in
    that scope wherever it is called from. Activation checkpointing needs
    it: the backward pass recomputes a checkpointed forward on the autograd
    engine's thread (a CUDA device's worker), where the caller's scope is
    not set."""
    ctx = _CTX.get()
    if ctx is None:
        return fn

    def scoped(*args, **kwargs):
        token = _CTX.set(ctx)
        try:
            return fn(*args, **kwargs)
        finally:
            _CTX.reset(token)
    return scoped


def on_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, made by every rank alike, as a replicated DTensor on
    ``mesh``; ``t`` itself if it already is one."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def product_on_shards(fn, x, w, contract: int = 1):
    """``fn(x, w)``, a product contracting x's last ``contract`` dimensions
    with w's first ``contract`` ones, run by each rank on its shards of the
    DTensors x and w (``local_map``; ``fn`` sees plain tensors). Per mesh
    dimension: x's row shards (batch, sequence) are kept and w gathered
    there; a contracted dimension sharded in x is sharded alike in w and
    the product is a ``Partial`` sum; otherwise x is replicated and w keeps
    a shard of an output dimension (heads or ``head_dim``), which the
    product then carries; any other shard of w is gathered. Gradients of
    an operand replicated against the other's shards are partial sums."""
    mesh = x.device_mesh
    lead = x.ndim - contract
    x_pl, w_pl, out_pl, x_grad, w_grad = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        if isinstance(a, Shard) and a.dim < lead:            # rows
            pl = (a, Replicate(), a, a, Partial())
        elif isinstance(a, Shard):                           # contracted
            pl = (a, Shard(a.dim - lead), Partial(), a, Shard(a.dim - lead))
        elif isinstance(b, Shard) and b.dim >= contract:     # w's outputs
            pl = (Replicate(), b, Shard(lead + b.dim - contract), Partial(),
                  b)
        else:
            pl = (Replicate(),) * 5
        for dst, p in zip((x_pl, w_pl, out_pl, x_grad, w_grad), pl):
            dst.append(p)
    fn = local_map(fn, out_placements=out_pl, in_placements=(x_pl, w_pl),
                   in_grad_placements=(x_grad, w_grad), device_mesh=mesh)
    return fn(x.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl))
