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
of 16). The experts run on those shards, and each rank gathers its own
tokens' outputs from the whole (E, C + 1, d) result.

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

from ..sharding.context import constrain, project
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


def dispatch(xt, e_idx, keep, slot, n_experts: int, cap: int):
    """The (E, cap + 1, d) buffer of one routing choice: each kept token's
    row at (its expert, its slot), zeros elsewhere. A scatter-add into
    distinct slots (row ``cap`` collects the dropped tokens as zeros): the
    same sums as the reference's ``.at[].add``."""
    buf = xt.new_zeros((n_experts, cap + 1, xt.shape[1]))
    return buf.index_put((e_idx, slot),
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
    """``dispatch`` of one rank's (B, S) tokens."""
    return dispatch(x.reshape(-1, x.shape[-1]), e_idx.reshape(-1),
                    keep.reshape(-1), slot.reshape(-1), n_experts, cap)


def _gather_rows(y, e_idx, slot, w):
    """Each of one rank's (B, S) tokens' expert output, weighted."""
    return y[e_idx, slot] * w[..., None]


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
    gather = local_map(_gather_rows, out_placements=tok,
                       in_placements=(rep, tok, tok, tok),
                       in_grad_placements=(tok_grad, tok, tok, tok),
                       device_mesh=mesh)
    out = torch.zeros_like(x)
    for choice in range(cfg.experts_per_tok):
        keep, slot = (distribute(t.reshape(B, S), mesh, tok) for t in
                      dispatch_slots(choices[:, choice], E, cap))
        e_idx = top_e[..., choice]
        buf = constrain(scatter(x, e_idx, keep, slot),
                        ("act_expert", "act_expert_cap", None))
        # the weights follow the buffer's expert shards; over its slot
        # shards they are gathered, and their gradients there are partial
        b_pl = list(buf.placements)
        w_pl = [a if a == Shard(0) else Replicate() for a in b_pl]
        w_grad = [Partial() if isinstance(a, Shard) and a != Shard(0) else b
                  for a, b in zip(b_pl, w_pl)]
        y = local_map(experts, out_placements=b_pl,
                      in_placements=(b_pl,) + (w_pl,) * 3,
                      in_grad_placements=(b_pl,) + (w_grad,) * 3,
                      device_mesh=mesh)(
            buf, *(w.redistribute(mesh, w_pl) for w in wts))
        y = constrain(y, ("act_expert", "act_expert_cap", None))
        w = (top_p[..., choice] * keep).to(dt)
        out = out + gather(y.redistribute(mesh, rep), e_idx, slot, w)
    return out, aux
