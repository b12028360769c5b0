"""Mixture-of-Experts layer: top-k routing with capacity-bounded scatter
dispatch (the port of ``repro.models.moe``).

Each of the k routing choices is dispatched on its own:

  1. every token is ranked within its chosen expert by a cumulative one-hot
     count (T, E),
  2. tokens whose rank reaches the per-expert capacity are DROPPED (the
     residual path carries them),
  3. kept tokens scatter into an (E, C+1, d) buffer (row C is the overflow
     row, always zero-weighted), the experts run a batched SwiGLU,
  4. outputs gather back, weighted by the renormalized router probability.

The Switch-style load-balancing loss is returned beside the output.

On a mesh (``moe_apply`` given a DTensor) the routing stays global, as
the reference's is over all T = B·S tokens: each rank routes its own
tokens, the (T, k) expert choices are gathered (small ints) and every rank
ranks the whole batch alike, so the same tokens drop as on one device.
Each rank scatters its own tokens into the buffer, a partial sum over the
ranks that split the tokens (the reference's "local-scatter +
all-reduce"); the buffer and the expert outputs are constrained to
("act_expert", "act_expert_cap", None): the experts over the model axis
when it divides them, else the capacity slots (capacity + 1 is a multiple
of 16). Each rank keeps its shard of the partial buffer before the sum,
so the sum moves only that shard. The experts run on those shards, their
weights gathered once a layer. Each rank reads its own tokens' outputs
from its shard of the (E, C + 1, d) result (a token whose expert or slot
another rank holds reads zeros there), and the k choices' sum is reduced
once over the dimensions that shard the result (``_gather_on_shards``).

Where no gradient is taken (serving) and it moves fewer bytes, the
experts keep their weights' shards of d_model and d_ff and move the
buffer instead (``_experts_on_shards``): a decode step's buffer holds a
few slots an expert, a weight whole experts.

The reference names the dispatched buffer for its remat policy
(``save_only_these_names("moe_buf")``), so its backward keeps the buffer
and skips the scatter. ``torch.utils.checkpoint`` has no per-name policy:
under the LM's checkpoints the port saves nothing inside a layer and runs
the routing, the scatter and the experts again in the backward pass. The
numbers are the same; only the memory and the recomputation differ.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..sharding.context import (all_reduced, constrain,
                                constrain_placements, gather_bytes,
                                moves_activation, project, takes_grad)
from ..sharding.rules import distribute
from .common import EMBED, EXPERT, MLP, ParamSpec, f32, silu


def moe_specs(cfg) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": ParamSpec((d, E), (EMBED, EXPERT)),
        "wi_gate": ParamSpec((E, d, f), (EXPERT, EMBED, MLP)),
        "wi_up": ParamSpec((E, d, f), (EXPERT, EMBED, MLP)),
        "wo": ParamSpec((E, f, d), (EXPERT, MLP, EMBED)),
    }


def capacity(cfg, T: int) -> int:
    """Slots per expert for T tokens: the capacity-factor bound with a floor
    of min(T, 8) (decode steps drop nothing), then capacity + 1 rounded up
    to a multiple of 16, as the reference rounds it. ``round`` is Python's,
    as in the reference (halves to even)."""
    c = int(max(round(T / cfg.n_experts * cfg.capacity_factor), min(T, 8), 1))
    return -(-(c + 1) // 16) * 16 - 1


def route(cfg, p, xt):
    """Router probabilities (T, E) f32 and the top-k choices: (top_p
    renormalized, top_e), each (T, k), largest first. ``lax.top_k`` puts
    the lower expert index first among equal probabilities; a stable sort
    does the same (``torch.topk`` promises no order among ties)."""
    logits = f32(project(xt, p["router"]))
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_tok
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return probs, top_p, top_e


def dispatch_slots(e_idx, n_experts: int, cap: int):
    """For one routing choice: each token's rank among the tokens before it
    that chose the same expert, whether it is kept (rank < cap), and its
    slot (the overflow row ``cap`` when dropped)."""
    onehot = torch.nn.functional.one_hot(e_idx, n_experts).to(torch.int32)
    rank = torch.cumsum(onehot, dim=0) - onehot              # tokens before me
    my_rank = torch.gather(rank, 1, e_idx[:, None])[:, 0]
    keep = my_rank < cap
    return keep, torch.where(keep, my_rank, torch.full_like(my_rank, cap))


def dispatch(xt, e_idx, keep, slot, n_experts: int, cap: int,
             inplace: bool = False):
    """The (E, cap + 1, d) buffer of one routing choice: each kept token's
    row at (its expert, its slot), zeros elsewhere. A scatter-add into
    distinct slots (row ``cap`` collects the dropped tokens as zeros): the
    same sums as the reference's ``.at[].add``. ``inplace`` scatters into
    the zeroed buffer itself, so that one buffer is live, not two."""
    buf = xt.new_zeros((n_experts, cap + 1, xt.shape[1]))
    put = buf.index_put_ if inplace else buf.index_put
    return put((e_idx, slot),
               torch.where(keep[:, None], xt, torch.zeros_like(xt)),
               accumulate=True)


def experts(buf, wi_gate, wi_up, wo):
    """The batched SwiGLU of every expert on its slots: (E, C+1, d)."""
    h = silu(torch.einsum("ecd,edf->ecf", buf, wi_gate)) * \
        torch.einsum("ecd,edf->ecf", buf, wi_up)
    return torch.einsum("ecf,efd->ecd", h, wo)


def moe_apply(cfg, p, x):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
    if isinstance(x, DTensor):
        return _moe_on_mesh(cfg, p, x)
    B, S, d = x.shape
    E = cfg.n_experts
    T = B * S
    xt = x.reshape(T, d)
    dt = x.dtype
    probs, top_p, top_e = route(cfg, p, xt)

    # Switch load-balance loss: E * sum_e f_e * P_e
    assign1 = torch.nn.functional.one_hot(top_e[:, 0], E).float()
    aux = E * torch.mean(assign1.mean(0) * probs.mean(0)) * E

    cap = capacity(cfg, T)
    wi_gate, wi_up, wo = (p[k].to(dt) for k in ("wi_gate", "wi_up", "wo"))
    out = torch.zeros((T, d), dtype=dt, device=x.device)
    for choice in range(cfg.experts_per_tok):
        e_idx = top_e[:, choice]
        keep, slot = dispatch_slots(e_idx, E, cap)
        buf = dispatch(xt, e_idx, keep, slot, E, cap)
        y = experts(buf, wi_gate, wi_up, wo)                    # (E, C+1, d)
        w = (top_p[:, choice] * keep).to(dt)[:, None]
        out = out + y[e_idx, slot] * w
    return out.reshape(B, S, d), aux


def _route_rows(cfg, router, x):
    """``route`` on the (B, S, d) rows of one rank: probs, top_p, top_e and
    the one-hot of each token's first choice, each (B, S, ...)."""
    lead = x.shape[:-1]
    probs, top_p, top_e = route(cfg, {"router": router},
                                x.reshape(-1, x.shape[-1]))
    first = torch.nn.functional.one_hot(top_e[:, 0], cfg.n_experts).float()
    return tuple(t.reshape(*lead, t.shape[-1])
                 for t in (probs, top_p, top_e, first))


def _scatter_rows(n_experts: int, cap: int, x, e_idx, keep, slot):
    """``dispatch`` of one rank's (B, S) tokens, in place: each rank's
    buffer is the whole (E, cap + 1, d) before its shards are summed."""
    return dispatch(x.reshape(-1, x.shape[-1]), e_idx.reshape(-1),
                    keep.reshape(-1), slot.reshape(-1), n_experts, cap,
                    inplace=True)


def _gather_rows(e0: int, s0: int, y, e_idx, slot, w):
    """Each of one rank's (B, S) tokens' expert output, weighted, from
    y's experts e0 ... and slots s0 ... (zeros for a token outside them)."""
    e, s = e_idx - e0, slot - s0
    inside = (e >= 0) & (e < y.shape[0]) & (s >= 0) & (s < y.shape[1])
    rows = y[torch.where(inside, e, 0), torch.where(inside, s, 0)]
    return rows * (w * inside)[..., None]


def _moe_on_mesh(cfg, p, x):
    """``moe_apply`` on DTensors (the module docstring says how)."""
    mesh = x.device_mesh
    B, S, d = x.shape
    E, dt = cfg.n_experts, x.dtype
    rep = [Replicate()] * mesh.ndim
    # the tokens' shards: batch and sequence; a replicated operand's
    # gradient is a partial sum over them
    tok = [a if isinstance(a, Shard) and a.dim < 2 else Replicate()
           for a in x.placements]
    tok_grad = [Partial() if isinstance(a, Shard) else a for a in tok]
    x = x.redistribute(mesh, tok)
    router = p["router"].redistribute(mesh, rep)
    probs, top_p, top_e, first = local_map(
        partial(_route_rows, cfg), out_placements=(tok,) * 4,
        in_placements=(rep, tok), in_grad_placements=(tok_grad, tok),
        device_mesh=mesh)(router, x)
    aux = E * torch.mean(first.mean((0, 1)) * probs.mean((0, 1))) * E

    cap = capacity(cfg, B * S)
    choices = top_e.full_tensor().reshape(B * S, -1)        # every token's
    wts = [p[k].to(dt) for k in ("wi_gate", "wi_up", "wo")]
    scatter = local_map(partial(_scatter_rows, E, cap),
                        out_placements=tok_grad,
                        in_placements=(tok,) * 4, device_mesh=mesh)
    serving = not takes_grad(x, *wts)
    outs, gathered = [], None
    for choice in range(cfg.experts_per_tok):
        keep, slot = (distribute(t.reshape(B, S), mesh, tok) for t in
                      dispatch_slots(choices[:, choice], E, cap))
        e_idx = top_e[..., choice]
        buf = _shard_then_sum(scatter(x, e_idx, keep, slot),
                              ("act_expert", "act_expert_cap", None))
        b_pl = list(buf.placements)
        if serving:
            y = _experts_on_shards(buf, wts, tok)
        else:
            # the weights follow the buffer's expert shards; over its slot
            # shards they are gathered, once a layer, and their gradients
            # there are partial
            w_pl = [a if a == Shard(0) else Replicate() for a in b_pl]
            w_grad = [Partial() if isinstance(a, Shard) and a != Shard(0)
                      else b for a, b in zip(b_pl, w_pl)]
            if gathered is None:
                gathered = [w.redistribute(mesh, w_pl) for w in wts]
            y = local_map(experts, out_placements=b_pl,
                          in_placements=(b_pl,) + (w_pl,) * 3,
                          in_grad_placements=(b_pl,) + (w_grad,) * 3,
                          device_mesh=mesh)(buf, *gathered)
            y = constrain(y, ("act_expert", "act_expert_cap", None))
        w = (top_p[..., choice] * keep).to(dt)
        outs.append(_gather_on_shards(y, e_idx, slot, w, tok))
    out = outs[0]
    for o in outs[1:]:
        out = out + o
    if list(out.placements) != tok:
        out = out.redistribute(mesh, tok)
    return out, aux


def _shard_then_sum(buf, axes):
    """``constrain(buf, axes)`` of a partial buffer: each rank first keeps
    its shard of the dimensions that the axes shard (a local slice), so
    that the partial sum then moves only that shard."""
    mesh = buf.device_mesh
    want = constrain_placements(buf, axes)
    first = [b if a == Replicate() and isinstance(b, Shard) else a
             for a, b in zip(buf.placements, want)]
    if first != list(buf.placements):
        buf = buf.redistribute(mesh, first)
    return constrain(buf, axes)


def _experts_on_shards(buf, wts, tok):
    """The experts of a serving step on each rank's shards: per mesh
    dimension, the weights keep their shard of d_model or d_ff where
    moving the buffer there costs fewer bytes than gathering the three
    weights (``moves_activation``): on d_model the buffer takes the same
    shard of its d (a local slice) and the two up-projections are partial
    sums, all-reduced; on d_ff the buffer is whole there (gathered from
    its slot shards), the up-projections keep the d_ff shard and the
    down-projection is a partial sum. Elsewhere the weights follow the
    buffer's expert shards and are gathered, as in training. The moves
    are costed with the output's trip to the rows ``tok`` (made whole
    where they are sharded). Returns the (E, C + 1, d) output, ``Partial``
    where the down-projection was."""
    mesh = buf.device_mesh
    b_pl, wi_pl = list(buf.placements), list(wts[0].placements)
    buf_in, wi_in, wo_in, y_pl, groups = [], [], [], [], []
    isz = buf.element_size()
    experts_pl = [Shard(0) if b == Shard(0) else Replicate() for b in b_pl]
    h_shape = (*buf.shape[:2], wts[0].shape[2])
    for i, (b, c, t) in enumerate(zip(b_pl, wi_pl, tok)):
        g = mesh.size(i)
        # the weights gathered, as the training route gathers them
        gather = sum(gather_bytes(w.shape, [
            Shard(0) if q == Shard(0) and bj == Shard(0) else Replicate()
            for q, bj in zip(w.placements, b_pl)], mesh, isz, (i,))
            for w in wts)
        # y made whole there for the rows (``_gather_on_shards``), where
        # the rows are sharded
        y_rows = gather_bytes(buf.shape, experts_pl, mesh, isz, (i,)) \
            if isinstance(t, Shard) else 0.0
        if g > 1 and c == Shard(1) and b == Replicate():
            moved = 4 * gather_bytes(h_shape, experts_pl, mesh, isz, (i,))
            if moves_activation(moved + y_rows, gather):
                buf_in.append(Shard(2)), wi_in.append(c)
                wo_in.append(Shard(2)), y_pl.append(Shard(2))
                groups.append(mesh.get_group(i))
                continue
        if g > 1 and c == Shard(2) and b in (Replicate(), Shard(1)):
            moved = 0.0 if b == Replicate() else \
                gather_bytes(buf.shape, experts_pl, mesh, isz, (i,))
            if moves_activation(moved + 2 * y_rows, gather):
                buf_in.append(Replicate()), wi_in.append(c)
                wo_in.append(Shard(1)), y_pl.append(Partial())
                continue
        keep = Shard(0) if b == Shard(0) else Replicate()
        buf_in.append(b), wi_in.append(keep), wo_in.append(keep)
        y_pl.append(b)
    fn = local_map(partial(_experts_local, groups), out_placements=y_pl,
                   in_placements=(buf_in, wi_in, wi_in, wo_in),
                   device_mesh=mesh)
    return fn(buf.redistribute(mesh, buf_in),
              *(w.redistribute(mesh, pl) for w, pl in
                zip(wts, (wi_in, wi_in, wo_in))))


def _experts_local(groups, buf, wi_gate, wi_up, wo):
    """``experts`` on one rank's shards: the up-projections' partial sums
    all-reduced over ``groups`` first (they contracted a d_model shard)."""
    hg = all_reduced(torch.einsum("ecd,edf->ecf", buf, wi_gate), "sum",
                     groups)
    hu = all_reduced(torch.einsum("ecd,edf->ecf", buf, wi_up), "sum", groups)
    return torch.einsum("ecf,efd->ecd", silu(hg) * hu, wo)


def _gather_on_shards(y, e_idx, slot, w, tok):
    """Each of the rank's tokens' rows of the expert output y (E, C + 1,
    d), weighted by w, on y's shards. Per mesh dimension: where the tokens
    are sharded y is made whole; where they are not, each rank reads its
    tokens' rows from its own shard of the experts or slots (zeros for a
    row it does not hold) or from its partial y, and the rows are a
    partial sum there, or keeps y's shard of d. The rows' gradient reaches
    y's shards alike (a partial sum where the tokens are sharded), and
    the weights' is a partial sum where the rows are."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh = y.device_mesh
    y_pl, out_pl, y_grad = [], [], []
    for a, t in zip(y.placements, tok):
        if isinstance(t, Shard):
            y_pl.append(Replicate()), out_pl.append(t)
            y_grad.append(Partial())
        elif a == Shard(2):
            y_pl.append(a), out_pl.append(Shard(2)), y_grad.append(a)
        elif a.is_partial() or a in (Shard(0), Shard(1)):
            y_pl.append(a), out_pl.append(Partial()), y_grad.append(a)
        else:
            y_pl.append(a), out_pl.append(a), y_grad.append(a)
    if y_pl != list(y.placements):
        y = y.redistribute(mesh, y_pl)
    # a row's weight meets one rank's y: its gradient is a partial sum
    # wherever the rows are
    w_grad = [Partial() if o.is_partial() else t
              for o, t in zip(out_pl, tok)]
    _, offset = compute_local_shape_and_global_offset(y.shape, mesh, y_pl)
    return local_map(partial(_gather_rows, offset[0], offset[1]),
                     out_placements=out_pl,
                     in_placements=(y_pl, tok, tok, tok),
                     in_grad_placements=(y_grad, tok, tok, w_grad),
                     device_mesh=mesh)(y, e_idx, slot, w)
