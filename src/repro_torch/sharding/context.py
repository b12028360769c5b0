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

An embedding lookup on a DTensor table and its gradient run on local
tensors (``embedding_rows``).

A product that contracts heads with a weight sharded over (heads,
head_dim) runs on each rank's shards (``product_on_shards``): DTensor
cannot unflatten a sharded ``heads x head_dim`` dimension into a head
count that the mesh dimension does not divide (smollm's 15 heads on a
model axis of 2).

Every other projection of an activation by a 2-D weight goes through
``project``: torch 2.11's DTensor refuses the matmul's view of an x whose
sequence is sharded, or of such a gradient (fault F6), and ``project``
keeps both off that view.
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


def reduced(t):
    """The DTensor ``t`` with its partial sums reduced (``Partial`` made
    ``Replicate``); anything else itself. A partial product meets a
    sharded bias this way under torch 2.11 too, whose DTensor cannot turn
    the bias's shard into a partial sum ("redistribute from S(0) to
    P(sum) not supported yet")."""
    if not isinstance(t, DTensor) or not any(a.is_partial()
                                             for a in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if a.is_partial()
                                          else a for a in t.placements])


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


def _rows_refused(t) -> bool:
    """Whether torch 2.11's DTensor refuses to view the DTensor ``t`` (..., n)
    as (rows, n): a dimension after the first of its leading ones is
    sharded ("Attempted to flatten multiple dimensions", fault F6)."""
    return any(0 < getattr(p, "dim", 0) < t.ndim - 1 for p in t.placements)


def project(x, w):
    """``x @ w`` in x's dtype: an activation x (..., k) times a 2-D weight
    w (k, n), the one route of a projection on a mesh. A matmul views x as
    (rows, k), and in its backward the product's gradient as (rows, n). An
    x whose sequence is sharded (``sp``) runs on each rank's shards
    (``product_on_shards``); any other x takes the matmul itself,
    DTensor's own rule, so its partial sums are reduced where they were,
    and a gradient that comes back so sharded first meets the product's
    own placements there (``_GradRows``)."""
    w = w.to(x.dtype)
    if not isinstance(x, DTensor):
        return x @ w
    if _rows_refused(x):
        return product_on_shards(torch.matmul, x, w)
    return _GradRows.apply(x @ w)


class _GradRows(torch.autograd.Function):
    """The identity; in the backward, a gradient that torch 2.11 could not
    view as rows is redistributed to the forward's placements on each mesh
    dimension that shards such a dimension (a partial sum there made whole:
    a gradient is never partial by redistribution). Any other gradient
    passes as it came, so the sums stay where DTensor put them."""

    @staticmethod
    def forward(ctx, y):
        ctx.placements = y.placements
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        if not _rows_refused(grad):
            return grad
        lead = grad.ndim - 1
        want = [(Replicate() if f.is_partial() else f)
                if 0 < getattr(g, "dim", 0) < lead else g
                for g, f in zip(grad.placements, ctx.placements)]
        return grad.redistribute(grad.device_mesh, want)


def embedding_rows(table, tokens):
    """``table[tokens]``: the rows of an embedding table (V, d) for integer
    tokens of any shape. On a DTensor table the lookup and its gradient
    run on local tensors (``_Rows``), as DTensor's own indexing runs them;
    DTensor's rule for the indexing's backward (``index_put``) fails once
    the tokens are sharded under torch 2.11 ("Shard dim -1 ... must be
    normalized")."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    return _Rows.apply(table, on_mesh(tokens, table.device_mesh))


class _Rows(torch.autograd.Function):
    """Forward: every rank gathers the table and the tokens, looks up the
    whole batch, and the rows take the tokens' placements. Backward: the
    rows' gradient is gathered where it is sharded and kept a partial sum
    where it is one, and each rank accumulates every token's rows into a
    zero table in the tokens' order: the table's gradient, partial where
    the rows' gradient was."""

    @staticmethod
    def forward(ctx, table, tokens):
        mesh = table.device_mesh
        whole = [Replicate()] * mesh.ndim
        t = tokens.redistribute(mesh, whole).to_local().long()
        ctx.save_for_backward(t)
        ctx.shape = tuple(table.shape)
        rows = table.redistribute(mesh, whole).to_local()[t]
        return DTensor.from_local(rows, mesh, whole, run_check=False
                                  ).redistribute(mesh, tokens.placements)

    @staticmethod
    def backward(ctx, grad):
        t, = ctx.saved_tensors
        mesh = grad.device_mesh
        keep = [a if a.is_partial() else Replicate() for a in grad.placements]
        g = grad.redistribute(mesh, keep).to_local()
        table = g.new_zeros(ctx.shape).index_put_((t,), g, accumulate=True)
        return DTensor.from_local(table, mesh, keep, run_check=False), None
