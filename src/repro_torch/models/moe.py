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

The reference names the dispatched buffer for its remat policy
(``save_only_these_names("moe_buf")``), so its backward keeps the buffer
and skips the scatter. ``torch.utils.checkpoint`` has no per-name policy:
under the LM's checkpoints the port saves nothing inside a layer and runs
the routing, the scatter and the experts again in the backward pass. The
numbers are the same; only the memory and the recomputation differ.
"""
from __future__ import annotations

import torch

from .common import EMBED, EXPERT, MLP, ParamSpec, silu


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
    logits = (xt @ p["router"].to(xt.dtype)).float()
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


def moe_apply(cfg, p, x):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar f32)."""
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
        h = silu(torch.einsum("ecd,edf->ecf", buf, wi_gate)) * \
            torch.einsum("ecd,edf->ecf", buf, wi_up)
        y = torch.einsum("ecf,efd->ecd", h, wo)                 # (E, C+1, d)
        w = (top_p[:, choice] * keep).to(dt)[:, None]
        out = out + y[e_idx, slot] * w
    return out.reshape(B, S, d), aux
