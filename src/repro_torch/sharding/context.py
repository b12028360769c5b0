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

Every product of an activation by a weight runs on each rank's shards
(``product_on_shards``; a 2-D weight through ``project``): each rank keeps
its rows and gathers the weight where the rows are sharded, as GSPMD does
for the reference, and the weight's gradient is reduce-scattered back to
the weight's own placements inside the backward, so no rank holds a whole
weight's gradient (faults F10, F12). DTensor's own matmul would exchange
the activation against a weight sharded over the data axis, cannot
unflatten a sharded ``heads x head_dim`` dimension into a head count that
the mesh dimension does not divide (smollm's 15 heads on a model axis of
2, fault F1), and under torch 2.11 refuses the matmul's view of an x whose
sequence is sharded (fault F6). The Mamba2 mixer takes each rank's own
column ranges of its gathered in-projection (``models/mamba2.py``, fault
F11).

The LM loss on DTensor logits runs on each rank's vocabulary shard
(``cross_entropy_on_shards``): the ranks exchange only per-row values,
where DTensor's own gather and its backward would hold the whole
vocabulary, and the whole microbatch's gradient, on every rank (fault F7).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
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
    if _CTX.get() is None or not isinstance(x, DTensor):
        return x
    want = constrain_placements(x, axes)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def constrain_placements(x, axes: tuple) -> list:
    """The placements ``constrain(x, axes)`` gives the DTensor x inside a
    scope; x's own outside one."""
    ctx = _CTX.get()
    if ctx is None:
        return list(x.placements)
    mesh, strat = ctx
    return list(placements(spec_for_axes(tuple(axes), strat, mesh,
                                         tuple(x.shape)), mesh))


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


def residual(x, a):
    """``x + a``, a sublayer's output ``a`` added to the residual stream x,
    with a's partial sums reduced first (``reduced``). DTensor's rule for
    a replicated operand plus a partial one differs between torch
    versions: 2.11 reduces the partial sum there, in the activation's
    dtype, as GSPMD reduces the reference's; 2.13 keeps the sum partial and
    leaves the reduction to the next op that needs it, a norm's float32
    mean and variance (twice the bytes, and again in every projection of
    that norm's partial output)."""
    return x + reduced(a)


def product_on_shards(fn, x, w, contract: int = 1):
    """``fn(x, w)``, a product contracting x's last ``contract`` dimensions
    with w's first ``contract`` ones, run by each rank on its shards of the
    DTensors x and w (``local_map``; ``fn`` sees plain tensors). Per mesh
    dimension: x's row shards (batch, sequence) are kept and w gathered
    there; a contracted dimension sharded in x is sharded alike in w and
    the product is a ``Partial`` sum; otherwise x is replicated and w keeps
    a shard of an output dimension (heads or ``head_dim``), which the
    product then carries; any other shard of w is gathered. The gradient
    of an operand replicated against the other's shards is a partial sum,
    redistributed to the operand's own placements in the backward of its
    redistribution: x's reduced at once, as GSPMD reduces each product's,
    w's reduce-scattered where the rows are sharded. A weight
    gathered over sharded rows is not kept for the backward, which gathers
    it again (``_regathering``), as the reference's FSDP does."""
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
    given = list(out_pl)
    serving = not takes_grad(x, w)
    if serving:
        _move_activations(x, w, contract, x_pl, w_pl, out_pl)
    if any(isinstance(a, Shard) and a.dim < lead and isinstance(b, Shard)
           for a, b in zip(x.placements, w.placements)):
        fn = _regathering(fn, w, w_pl)
    fn = local_map(fn, out_placements=out_pl, in_placements=(x_pl, w_pl),
                   in_grad_placements=(x_grad, w_grad), device_mesh=mesh)
    if not serving:
        return fn(x.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl))
    out = fn(moved_to(x, x_pl), w.redistribute(mesh, w_pl))
    return out if out_pl == given else moved_to(out, given)


def takes_grad(*tensors) -> bool:
    """Whether autograd records a product of ``tensors``."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def moved_to(t, placements):
    """The DTensor ``t`` redistributed to ``placements``, where no gradient
    is taken: a mesh dimension whose shard moves from one tensor dimension
    to another moves it by one all-to-all where it can
    (``_all_to_all``), as DTensor does over NCCL (over a CPU group it
    gathers the whole and keeps a chunk); the rest by DTensor."""
    for i, (a, b) in enumerate(zip(t.placements, placements)):
        if isinstance(a, Shard) and isinstance(b, Shard) and a.dim != b.dim:
            moved = _all_to_all(t, i, b.dim)
            t = t if moved is None else moved
    if tuple(t.placements) == tuple(placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _all_to_all(t, i: int, dst: int):
    """The DTensor t with its shard over mesh dimension i moved from its
    tensor dimension to ``dst``, by an all-to-all over that dimension's
    group: each rank sends the others their chunks of ``dst`` and keeps
    the pieces of its own, in the ranks' order along the old dimension.
    None where the move is not one all-to-all: the mesh dimension does not
    divide both tensor dimensions, or another mesh dimension shards one of
    them."""
    mesh, g = t.device_mesh, t.device_mesh.size(i)
    src = t.placements[i].dim
    if not shard_moves(t.shape, t.placements, i, dst, mesh):
        return None
    pieces = torch.stack(t.to_local().chunk(g, dim=dst)).contiguous()
    got = funcol.all_to_all_single(pieces, None, None, mesh.get_group(i))
    if isinstance(got, funcol.AsyncCollectiveTensor):
        got = got.wait()
    placements = list(t.placements)
    placements[i] = Shard(dst)
    return _from_local(torch.cat(got.unbind(0), dim=src), mesh, placements,
                       tuple(t.shape))


def shard_moves(shape, placements, i: int, dst: int, mesh) -> bool:
    """Whether ``_all_to_all`` moves the shard over mesh dimension i of a
    tensor of ``shape`` placed so to tensor dimension ``dst``."""
    g, src = mesh.size(i), placements[i].dim
    return not (shape[src] % g or shape[dst] % g or any(
        isinstance(p, Shard) and p.dim in (src, dst)
        for j, p in enumerate(placements) if j != i))


def local_bytes(shape, placements, mesh, itemsize: int) -> float:
    """The bytes of one rank's shard of a tensor of global ``shape`` under
    ``placements`` (a ``Partial`` or replicated dimension whole)."""
    n = math.prod(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n /= mesh.size(i)
        # a shard's remainder is ignored: this is an estimate of bytes
    return n * itemsize


def gather_bytes(shape, placements, mesh, itemsize: int,
                 dims=None) -> float:
    """The bytes a rank receives where a tensor of global ``shape`` under
    ``placements`` is made whole over the mesh dimensions ``dims`` (all of
    them by default), one after another, by the counter's accounting
    (``core/hlo_analysis.py``: an all-gather over g ranks receives
    (g - 1) / g of what it returns)."""
    pl, n = list(placements), 0.0
    for i in range(mesh.ndim) if dims is None else dims:
        g = mesh.size(i)
        pl[i] = Replicate()
        n += local_bytes(shape, pl, mesh, itemsize) * ((g - 1) / g)
    return n


def move_bytes(shape, placements, i: int, dst, mesh, itemsize: int) -> float:
    """The bytes a rank receives where the shard over mesh dimension i of a
    tensor of global ``shape`` under ``placements`` moves to tensor
    dimension ``dst``: one all-to-all of its shard where ``_all_to_all``
    makes it, else (or with ``dst`` None) the gather of the whole there."""
    if dst is not None and shard_moves(shape, placements, i, dst, mesh):
        g = mesh.size(i)
        return local_bytes(shape, placements, mesh, itemsize) * ((g - 1) / g)
    return gather_bytes(shape, placements, mesh, itemsize, (i,))


def moves_activation(moved: float, gather: float) -> bool:
    """The one rule of the serving routes that keep a weight's shard and
    move an activation in its place: ``_move_activations`` (products),
    ``_lookup_columns`` (the embedding lookup),
    ``models/moe.py::_experts_on_shards`` (the experts) and
    ``models/mamba2.py::_projects_first`` (the Mamba2 in-projection).
    Each costs, per mesh dimension, the bytes its moves receive
    (``gather_bytes``, ``move_bytes``) against the weight's gather, as
    GSPMD weighs its options for the reference (a decode step's activation
    is one token a row; a weight is whole layers), and takes the move where
    it receives fewer bytes.

    No step that takes a gradient comes here: the moved routes run on local
    tensors (``local_map``, an autograd Function's forward) with no
    gradient placements derived for the weight's kept shard, whose
    gradient would be a partial sum over the moved dimension; a training
    step keeps the gather, whose backward reduce-scatters the weight's
    gradient to its shard (``product_on_shards``)."""
    return moved < gather


def _move_activations(x, w, contract, x_pl, w_pl, out_pl) -> None:
    """Where a product that takes no gradient (serving) would gather a
    weight's shard over a mesh dimension, move the activation there
    instead when that moves fewer bytes (``moves_activation``). Per such
    mesh dimension:

      * x replicated, w sharded on a contracted dimension: x takes the
        same shard of that dimension (a local slice) and the product is a
        partial sum, all-reduced;
      * x's rows sharded, w sharded on a contracted dimension: x's shard
        moves from its rows to that dimension and the partial product is
        reduce-scattered back to the rows;
      * x's rows sharded, w sharded on an output dimension: x's rows are
        gathered, the product keeps w's shard of its output, and that
        shard moves back to the rows.

    The caller's placements of the product stay as they were
    (``product_on_shards`` moves it back to them). Updates the placement
    lists in place."""
    mesh = x.device_mesh
    lead = x.ndim - contract
    out_shape = (*x.shape[:lead], *w.shape[contract:])
    isz, wsz = x.element_size(), w.element_size()
    for i, (a, b) in enumerate(zip(x.placements, w.placements)):
        if mesh.size(i) == 1 or not isinstance(b, Shard) \
                or w_pl[i] != Replicate() \
                or not (a == Replicate() or (isinstance(a, Shard)
                                             and a.dim < lead)):
            continue
        gather = gather_bytes(w.shape, w_pl, mesh, wsz, (i,))
        whole_out = gather_bytes(out_shape, out_pl, mesh, isz, (i,))
        if b.dim < contract and a == Replicate():   # slice; all-reduce
            new_x, new_out = Shard(lead + b.dim), Partial()
            moved = 2 * whole_out
        elif b.dim < contract:                      # move; reduce-scatter
            new_x, new_out = Shard(lead + b.dim), Partial()
            moved = move_bytes(x.shape, x_pl, i, lead + b.dim, mesh,
                               isz) + whole_out
        elif isinstance(a, Shard):                  # gather rows; move back
            new_x = Replicate()
            new_out = Shard(lead + b.dim - contract)
            out_at = out_pl[:i] + [new_out] + out_pl[i + 1:]
            moved = gather_bytes(x.shape, x_pl, mesh, isz, (i,)) + \
                move_bytes(out_shape, out_at, i, a.dim, mesh, isz)
        else:                                       # case 3 keeps w's shard
            continue
        if moves_activation(moved, gather):
            x_pl[i], w_pl[i], out_pl[i] = new_x, b, new_out


def _regathering(fn, w, w_pl):
    """``fn(x, w_local)`` of a local weight gathered from the DTensor w to
    the placements ``w_pl``: where the forward keeps what it saves for the
    backward, no saved view of the gathered weight is kept, and the
    backward gathers it again from w's shards. Inside a checkpointed
    forward (its own hooks drop what it saves) and in a recomputation
    (the backward is about to read it) ``fn`` runs as it is."""
    def run(x, w_local):
        if not torch.is_grad_enabled() or \
                torch._C._current_graph_task_id() != -1 or \
                torch._C._autograd._top_saved_tensors_default_hooks(True):
            return fn(x, w_local)
        key = w_local.untyped_storage()._cdata

        def pack(t):
            if t.untyped_storage()._cdata != key:
                return t
            return (t.shape, t.stride(), t.storage_offset())

        def unpack(saved):
            if isinstance(saved, torch.Tensor):
                return saved
            with torch.no_grad():
                again = w.redistribute(w.device_mesh, w_pl).to_local()
            return again.as_strided(*saved)

        with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            return fn(x, w_local)
    return run


def project(x, w):
    """``x @ w`` in x's dtype: an activation x (..., k) times a 2-D weight
    w (k, n), the one route of a projection on a mesh: a DTensor x runs on
    each rank's shards (``product_on_shards``)."""
    w = w.to(x.dtype)
    if not isinstance(x, DTensor):
        return x @ w
    return product_on_shards(torch.matmul, x, w)


def embedding_rows(table, tokens):
    """``table[tokens]``: the rows of an embedding table (V, d) for integer
    tokens of any shape. On a DTensor table the lookup and its gradient
    run on local tensors (``_Rows``): DTensor's rule for the indexing's
    backward (``index_put``) fails once the tokens are sharded under torch
    2.11 ("Shard dim -1 ... must be normalized", fault F5). No rank holds
    the whole table or another rank's rows (fault F8)."""
    if not isinstance(table, DTensor):
        return table[tokens.long()]
    return _Rows.apply(table, on_mesh(tokens, table.device_mesh),
                       not takes_grad(table))


class _Rows(torch.autograd.Function):
    """Forward, per mesh dimension: a vocabulary shard of the table stays
    where it is and the tokens are gathered there, so each rank looks its
    tokens up in its own rows (a token outside its range gives a zero row)
    and the rows are summed over that dimension, exactly (each token's row
    comes from one rank); any other shard of the table is gathered and the
    tokens keep theirs. The rows take the tokens' placements. Backward:
    the rows' gradient is made whole over the vocabulary's mesh dimensions
    and kept a partial sum where it is one elsewhere; each rank accumulates
    its own tokens' rows that fall in its range into a zero table of its
    shard in the tokens' order, summed over the mesh dimensions that shard
    the tokens: the table's gradient, its vocabulary sharded as the
    table's, partial where the rows' gradient was (as DTensor's own
    gradients are; torch 2.11 cannot redistribute a table's shard into a
    partial sum, so no redistribution of the table sits in the graph).

    Where no gradient is taken (``serving``), a mesh dimension that
    shards the table's columns keeps them when gathering the tokens there
    and moving the looked-up columns back to the tokens' rows moves fewer
    bytes than gathering the table (a decode step's few tokens against a
    whole vocabulary; ``_lookup_columns``)."""

    @staticmethod
    def forward(ctx, table, tokens, serving=False):
        mesh = table.device_mesh
        tok_pl = [Shard(b.dim % tokens.ndim) if isinstance(b, Shard)
                  else Replicate() for b in tokens.placements]
        vocab = [isinstance(a, Shard) and a.dim % table.ndim == 0
                 for a in table.placements]
        table_pl = [Shard(0) if v else Replicate() for v in vocab]
        lookup_pl = [Replicate() if v else b for v, b in zip(vocab, tok_pl)]
        rows_pl = [Partial() if v else b for v, b in zip(vocab, lookup_pl)]
        if serving:
            _lookup_columns(table, tokens, table_pl, lookup_pl, rows_pl)
        table = table.redistribute(mesh, table_pl)
        _, offset = compute_local_shape_and_global_offset(table.shape, mesh,
                                                          table_pl)
        w = table.to_local()
        t = tokens.redistribute(mesh, lookup_pl).to_local().long() - offset[0]
        inside = (t >= 0) & (t < w.shape[0])
        t = torch.where(inside, t, 0)
        rows = w[t]
        if any(vocab):
            rows.masked_fill_(~inside[..., None], 0)
        ctx.save_for_backward(t, inside)
        ctx.vocab, ctx.lookup = vocab, lookup_pl
        ctx.shape, ctx.global_shape = tuple(w.shape), tuple(table.shape)
        rows = _from_local(rows, mesh, rows_pl,
                           (*tokens.shape, table.shape[1]))
        return moved_to(rows, tok_pl) if serving else \
            rows.redistribute(mesh, tok_pl)

    @staticmethod
    def backward(ctx, grad):
        t, inside = ctx.saved_tensors
        mesh = grad.device_mesh
        keep = [Replicate() if v else (a if a.is_partial() else b)
                for v, a, b in zip(ctx.vocab, grad.placements, ctx.lookup)]
        g = grad.redistribute(mesh, keep).to_local()
        if any(ctx.vocab):
            g = g.masked_fill(~inside[..., None], 0)
        table = g.new_zeros(ctx.shape).index_put_((t,), g, accumulate=True)
        summed = [Shard(0) if v else (Partial() if a.is_partial()
                                      or isinstance(a, Shard) else a)
                  for v, a in zip(ctx.vocab, keep)]
        whole = [Replicate() if isinstance(a, Shard) and not v else p
                 for v, a, p in zip(ctx.vocab, keep, summed)]
        table = _from_local(table, mesh, summed, ctx.global_shape)
        return table.redistribute(mesh, whole), None, None


def _lookup_columns(table, tokens, table_pl, lookup_pl, rows_pl) -> None:
    """``_Rows``'s serving route: per mesh dimension that shards the
    table's columns and would gather them, keep the columns where the
    tokens' gather and the rows' move back to the tokens' placement (an
    all-to-all where ``_all_to_all`` makes it) cost fewer bytes than the
    table's gather (``moves_activation``). Updates the placement lists in
    place."""
    mesh = table.device_mesh
    rows_shape = (*tokens.shape, table.shape[1])
    isz = table.element_size()
    for i, a in enumerate(table.placements):
        if mesh.size(i) == 1 or a != Shard(1) or table_pl[i] != Replicate():
            continue
        gather = gather_bytes(table.shape, table_pl, mesh, isz, (i,))
        cols = rows_pl[:i] + [Shard(len(rows_shape) - 1)] + rows_pl[i + 1:]
        back = rows_pl[i].dim if isinstance(rows_pl[i], Shard) else None
        moved = gather_bytes(tokens.shape, lookup_pl, mesh, 8, (i,)) + \
            move_bytes(rows_shape, cols, i, back, mesh, isz)
        if moves_activation(moved, gather):
            table_pl[i], lookup_pl[i] = Shard(1), Replicate()
            rows_pl[i] = Shard(len(rows_shape) - 1)


def cross_entropy_on_shards(logits, labels, z_loss: float = 1e-4):
    """``models.common.cross_entropy_loss`` of the DTensor logits (B, S, V)
    against the integer labels (B, S): the mean cross entropy plus
    ``z_loss`` times the mean squared log-normalizer, in float32 (a float64
    run stays float64), as a replicated DTensor scalar. Each rank computes
    it on its own shard of the logits (``_ShardedCE``), whether a mesh
    dimension shards the vocabulary or leaves it replicated, as GSPMD
    partitions the reference's ``take_along_axis``. A partial sum is
    reduced first: scattered over the vocabulary where no mesh dimension
    shards it yet and the mesh dimension divides it (a product that
    contracted a sharded feature dimension, as zamba2's head under ``2d``),
    else made whole; any other placement but a plain shard is made whole.
    The labels take the logits' row shards and are replicated elsewhere."""
    mesh = logits.device_mesh
    last = logits.ndim - 1
    vocab = any(isinstance(p, Shard) and p.dim % logits.ndim == last
                for p in logits.placements)
    want = []
    for i, p in enumerate(logits.placements):
        if p.is_partial() and not vocab and \
                logits.shape[last] % mesh.size(i) == 0:
            p, vocab = Shard(last), True
        elif type(p) not in (Shard, Replicate):
            p = Replicate()
        want.append(p)
    if want != list(logits.placements):
        logits = logits.redistribute(mesh, want)
    rows = [Shard(p.dim % logits.ndim) if isinstance(p, Shard)
            and p.dim % logits.ndim < last else Replicate() for p in want]
    labels = on_mesh(labels, mesh)
    if list(labels.placements) != rows:
        labels = labels.redistribute(mesh, rows)
    return _ShardedCE.apply(logits, labels, z_loss)


def _from_local(t, mesh, placements, shape: tuple):
    """The DTensor of global ``shape`` (contiguous) whose local shard is
    ``t``: a shard that the mesh dimension does not divide evenly needs its
    global shape given."""
    stride, n = [], 1
    for size in reversed(shape):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


class LayerStack:
    """Per-layer tensors of one kind (a prefill's K or V, a Mamba2 state)
    stacked over leading layer dimensions ``lead``, as ``torch.stack``
    stacks them, but held once. Plain tensors are kept and stacked at the
    end (``result``), bit for bit the stack: one device runs the program
    whose trace gives the dry-run's features. A DTensor is first taken to
    the placements of the cache's logical ``axes`` (one layer's, the
    ``layers`` dimensions left out) on every mesh dimension where it is
    replicated, a local slice and no communication, and its local shard
    is then written into one stacked local buffer, allocated at the first
    layer: no rank holds every layer's tensor beside the stack, nor a
    layer's whole where the cache holds a shard. Every layer takes the
    first layer's placements."""

    def __init__(self, lead: tuple, axes: tuple):
        self.lead, self.axes = tuple(lead), tuple(axes)
        self.parts, self.buf, self.n = [], None, 0

    def put(self, t):
        if not isinstance(t, DTensor):
            self.parts.append(t)
            return
        if self.buf is None:
            want = constrain_placements(t, self.axes)
            self.pl = [b if a.is_partial() or (
                a == Replicate() and isinstance(b, Shard)) else a
                for a, b in zip(t.placements, want)]
            self.mesh, self.shape = t.device_mesh, tuple(t.shape)
        if list(t.placements) != self.pl:
            t = t.redistribute(self.mesh, self.pl)
        local = t.to_local()
        if self.buf is None:
            self.buf = local.new_empty((math.prod(self.lead),)
                                       + tuple(local.shape))
        self.buf[self.n].copy_(local)
        self.n += 1

    def result(self):
        if self.buf is None:
            out = torch.stack(self.parts)
            return out.unflatten(0, self.lead) if len(self.lead) > 1 else out
        k = len(self.lead)
        pl = [Shard(a.dim + k) if isinstance(a, Shard) else a
              for a in self.pl]
        return _from_local(self.buf.view(self.lead + self.buf.shape[1:]),
                           self.mesh, pl, self.lead + self.shape)


def batch_tables(make, x):
    """``make(n)``, tables of n rows that every row of x's batch shares
    (the rotary cos and sin, (B, S, ...)), for x's batch. Where x is a
    DTensor inside a scope, each rank makes only the rows of its own batch
    shard, a DTensor sharded as ``act_batch`` shards the batch: made whole
    and sliced, every rank would hold the whole batch's tables. Otherwise
    ``make(x.shape[0])``."""
    if _CTX.get() is None or not isinstance(x, DTensor):
        return make(x.shape[0])
    mesh = x.device_mesh
    pl = constrain_placements(x, ("act_batch",) + (None,) * (x.ndim - 1))
    local, _ = compute_local_shape_and_global_offset(tuple(x.shape), mesh,
                                                     pl)
    return tuple(_from_local(t, mesh, pl, (x.shape[0],) + tuple(t.shape[1:]))
                 for t in make(local[0]))


def all_reduced(t, op: str, groups: list):
    """``t`` reduced by ``op`` over each process group in turn (the
    functional collectives DTensor itself uses)."""
    for group in groups:
        t = funcol.all_reduce(t, op, group)
        if isinstance(t, funcol.AsyncCollectiveTensor):
            t = t.wait()
    return t


class _ShardedCE(torch.autograd.Function):
    """Forward, on each rank's local logits widened: the row max, all-reduced
    (MAX) over the mesh dimensions that shard the vocabulary, then the row
    sum of exp(x - max) (SUM), lse = max + log sum; the gold logit read
    where the label falls in the rank's vocabulary range (DTensor's own
    offset of the shard, even or not), else 0 (SUM); then the means of
    lse - gold and of lse^2 over the local rows, weighted by the rows'
    share and summed over the mesh dimensions that shard rows. Backward,
    on the local shard from the saved lse, with no collective:
    dlogits = g / N (softmax (1 + 2 z lse) - onehot), N the global rows,
    with the logits' placements."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss):
        mesh, pl = logits.device_mesh, logits.placements
        last = logits.ndim - 1
        vocab, rows = [], []
        for i, p in enumerate(pl):
            if isinstance(p, Shard) and mesh.size(i) > 1:
                (vocab if p.dim % logits.ndim == last else rows).append(
                    mesh.get_group(i))
        _, offset = compute_local_shape_and_global_offset(
            logits.shape, mesh, pl)
        x = logits.to_local()
        lf = x if x.dtype == torch.float64 else x.float()
        local = labels.to_local().long() - offset[last]
        inside = (local >= 0) & (local < lf.shape[-1])
        idx = torch.where(inside, local, 0)
        m = all_reduced(lf.amax(-1), "max", vocab)
        total = all_reduced((lf - m[..., None]).exp_().sum(-1), "sum", vocab)
        lse = total.log_().add_(m)
        gold = all_reduced(torch.where(
            inside, lf.gather(-1, idx[..., None])[..., 0], 0.0), "sum", vocab)
        n = labels.numel()
        means = torch.stack([(lse - gold).mean(), (lse ** 2).mean()])
        means = all_reduced(means * (lse.numel() / n), "sum", rows)
        ce = means[0] + z_loss * means[1] if z_loss else means[0]
        ctx.save_for_backward(x, lse, idx, inside)
        ctx.mesh, ctx.placements, ctx.n, ctx.z_loss = mesh, pl, n, z_loss
        ctx.shape = tuple(logits.shape)
        return DTensor.from_local(ce, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    @staticmethod
    def backward(ctx, grad):
        x, lse, idx, inside = ctx.saved_tensors
        coef = grad.full_tensor().to(lse.dtype) / ctx.n
        row = coef * (1 + 2 * ctx.z_loss * lse) if ctx.z_loss else \
            coef.expand_as(lse)
        d = x.to(lse.dtype, copy=True).sub_(lse[..., None]).exp_()
        d.mul_(row[..., None]).scatter_add_(
            -1, idx[..., None], torch.where(inside, -coef, 0.0)[..., None])
        return (_from_local(d.to(x.dtype), ctx.mesh, ctx.placements,
                            ctx.shape), None, None)
