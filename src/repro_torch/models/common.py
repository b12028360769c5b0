"""Shared model machinery: parameter specs with logical sharding axes,
initialization, norms, rotary embeddings (M-RoPE too), the LM loss (the
port of ``repro.models.common``).

Parameters are declared once as ``ParamSpec`` trees (nested dicts of shape
+ logical axes + init); ``init_params`` materializes them as a nested dict
of tensors with the same names. The logical axes are kept as data for the
sharding rules of a later slice.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ..core.forest_torch import resolve_device
from ..sharding.context import (all_reduced, cross_entropy_on_shards,
                                in_scope, reduced)

# ---------------------------------------------------------------- param specs

# logical axis vocabulary (the reference's sharding/rules.py maps them)
BATCH, SEQ, EMBED, MLP, HEADS, KV_HEADS, HEAD_DIM, VOCAB, EXPERT = (
    "batch", "seq", "embed", "mlp", "heads", "kv_heads", "head_dim",
    "vocab", "expert")
LAYERS, INNER, STATE, CONV, LORA = "layers", "inner", "state", "conv", "lora"


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                    # logical axis per dim (None = replicated)
    init: str = "normal"           # normal | zeros | ones | embed
    scale: float | None = None     # None -> 1/sqrt(fan_in)
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} "
                             f"differ in rank")


def tree_map(fn, tree, path: tuple = ()):
    """Apply ``fn(path, leaf)`` to every ``ParamSpec`` (or tensor) leaf of a
    nested dict; ``path`` is the tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def _leaf_seed(seed: int, path: tuple) -> int:
    """Per-leaf seed from the same md5 of the path as the reference's
    ``_leaf_key``, so a leaf's numbers stay put under refactors that keep
    its name. The seed enters the low 32 bits too: the CPU generator reads
    only those."""
    h = int.from_bytes(hashlib.md5("/".join(path).encode()).digest()[:4],
                       "little")
    return (h + int(seed) * 0x9E3779B97F4A7C15) % 2 ** 64


def init_params(specs, seed: int, device: str | torch.device = "cuda"):
    """Materialize a ParamSpec tree on ``device``. Each leaf draws from its
    own ``torch.Generator`` on that device, seeded from ``seed`` and the
    md5 of its path. The numbers differ from ``jax.random``'s; the scales,
    zeros and ones are the reference's. A CUDA device must exist."""
    device = resolve_device(device)

    def make(path, spec: ParamSpec):
        dt = getattr(torch, spec.dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        fan_in = spec.shape[0] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        if spec.init == "embed":
            scale = spec.scale if spec.scale is not None else 1.0
        else:
            scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        gen = torch.Generator(device=device)
        gen.manual_seed(_leaf_seed(seed, path))
        out = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                          device=device)
        return (out * scale).to(dt)

    return tree_map(make, specs)


def logical_axes(specs):
    """Tree of logical-axes tuples, same structure as the params."""
    return tree_map(lambda _, s: s.axes, specs)


def stack_specs(specs, n: int, axis_name: str = LAYERS):
    """Prepend a layer axis to every leaf (stacked-layer storage)."""
    return tree_map(lambda _, s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes,
                                           s.init, s.scale, s.dtype), specs)


def unstack(tree) -> list:
    """The slices of a nested dict along the leading (stacked) axis of every
    tensor, as a list of nested dicts of views (no copies). The slices come
    from one ``torch.unbind`` per leaf, so their gradients flow back as one
    stack; indexing each slice apart would give every slice's gradient the
    full stacked size."""
    parts = tree_map(lambda _, t: t.unbind(0), tree)
    n = len(leaves(parts)[0])
    return [tree_map(lambda _, ts: ts[i], parts) for i in range(n)]


def remat(on: bool, fn, *args):
    """``fn(*args)``; with ``on``, its activations are recomputed in the
    backward pass instead of kept (the reference's ``jax.checkpoint``).
    The models draw no random numbers, so no RNG state is saved. The
    recomputation runs in the activation-sharding scope of the forward
    (``sharding.context.in_scope``)."""
    if not on:
        return fn(*args)
    return checkpoint(in_scope(fn), *args, use_reentrant=False,
                      preserve_rng_state=False)


# ------------------------------------------------------------------- numerics

def f32(x):
    """``x`` widened to float32 where the reference computes in float32; a
    float64 ``x`` (the CPU's float64 parity runs) stays float64, so that
    such a run rounds nowhere to float32."""
    return x if x.dtype == torch.float64 else x.float()


# a row-chunked op runs in ROW_PARTS chunks of rows, so that a chunk's
# float32 work is an eighth of the bf16 whole; a tensor of fewer than
# ROW_MIN elements runs whole
ROW_PARTS, ROW_MIN = 16, 1 << 20


def row_chunk(rows: int, row_elems: int) -> int:
    """The rows of one chunk of a row-chunked op on ``rows`` rows of
    ``row_elems`` elements each."""
    if rows * row_elems < ROW_MIN:
        return rows
    return -(-rows // ROW_PARTS)


def _rms_rows(x, eps: float):
    """x normalized over its last dimension in float32, cast to x's
    dtype."""
    xf = f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _layer_rows(x, eps: float):
    """x centred and normalized over its last dimension in float32, cast
    to x's dtype."""
    xf = f32(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def in_row_chunks(fn, x, *args):
    """``fn(x, *args)`` of a function of each row (x's last dimension)
    alone, run on a chunk of rows at a time (``row_chunk``) and written
    into one output of x's dtype: each row's numbers are the whole call's,
    and only one chunk's intermediates are live."""
    rows = x.reshape(-1, x.shape[-1])
    n = row_chunk(rows.shape[0], x.shape[-1])
    if rows.shape[0] <= n:
        return fn(x, *args)
    out = torch.empty_like(rows)
    for i in range(0, rows.shape[0], n):
        out[i:i + n] = fn(rows[i:i + n], *args)
    return out.view(x.shape)


class _RMSNorm(torch.autograd.Function):
    """``_rms_rows`` that keeps for its backward only x, in its own dtype,
    and the (..., 1) float32 reciprocal root; the backward rebuilds the
    normalized rows from them."""

    @staticmethod
    def forward(ctx, x, eps):
        xf = f32(x)
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, r)
        return (xf * r).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, r = ctx.saved_tensors
        xhat = f32(x) * r
        gf = f32(g)
        dot = torch.mean(gf * xhat, dim=-1, keepdim=True)
        return ((gf - xhat * dot) * r).to(x.dtype), None


class _RMSNormShards(torch.autograd.Function):
    """``_RMSNorm`` of a rank's shard of x's last dimension (``d`` whole):
    the row sums over it, of x^2 forward and of the gradient's product
    with the normalized rows backward, all-reduced over ``groups``."""

    @staticmethod
    def forward(ctx, x, eps, d, groups):
        xf = f32(x)
        r = torch.rsqrt(all_reduced(torch.sum(xf * xf, dim=-1, keepdim=True),
                                    "sum", groups) / d + eps)
        ctx.save_for_backward(x, r)
        ctx.d, ctx.groups = d, groups
        return (xf * r).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, r = ctx.saved_tensors
        xhat = f32(x) * r
        gf = f32(g)
        dot = all_reduced(torch.sum(gf * xhat, dim=-1, keepdim=True), "sum",
                          ctx.groups) / ctx.d
        return ((gf - xhat * dot) * r).to(x.dtype), None, None, None


class _LayerNorm(torch.autograd.Function):
    """``_layer_rows`` that keeps for its backward only x, in its own
    dtype, and the (..., 1) float32 mean and reciprocal root."""

    @staticmethod
    def forward(ctx, x, eps):
        xf = f32(x)
        mu = xf.mean(dim=-1, keepdim=True)
        r = torch.rsqrt(((xf - mu) ** 2).mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(x, mu, r)
        return ((xf - mu) * r).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, mu, r = ctx.saved_tensors
        xhat = (f32(x) - mu) * r
        gf = f32(g)
        dot = torch.mean(gf * xhat, dim=-1, keepdim=True)
        return ((gf - gf.mean(dim=-1, keepdim=True) - xhat * dot)
                * r).to(x.dtype), None


def _normalized(rows, fn, x, eps: float):
    """x normalized row by row: through the ``autograd.Function`` ``fn``
    where a gradient is taken; otherwise by ``rows`` directly, and, on a
    DTensor, in row chunks (``in_row_chunks``) on each rank's local rows.
    One device without a gradient runs ``rows`` whole: the program whose
    trace gives the dry-run's features."""
    grad = torch.is_grad_enabled() and x.requires_grad
    if not isinstance(x, DTensor):
        return fn.apply(x, eps) if grad else rows(x, eps)
    pl = list(x.placements)
    local = (lambda t: fn.apply(t, eps)) if grad else \
        (lambda t: in_row_chunks(rows, t, eps))
    return local_map(local, out_placements=pl, in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=x.device_mesh)(x)


def _rows_local(x) -> bool:
    """Whether each rank holds whole rows of x (its last dimension
    unsharded): a plain tensor, or such a DTensor."""
    return not isinstance(x, DTensor) or not any(
        getattr(a, "dim", None) == x.ndim - 1 for a in x.placements)


def rms_norm(x, w, eps: float = 1e-5):
    """In float32, cast to x's dtype, and only then scaled by w. With a
    gradient the normalization keeps x and its (..., 1) float32 root for
    the backward (``_RMSNorm``), not float32 copies of x; without one, on
    a mesh, it runs in row chunks. On a DTensor whose normalized dimension
    is sharded (the Mamba2 gated norm over the inner dimension) the sum of
    squares is all-reduced, a (B, S, 1) statistic, and so is its
    gradient's (``_RMSNormShards``): the normalization and its backward
    run on the shards. A partial sum
    is reduced first, as ``sharding.context.residual`` reduces it."""
    x = reduced(x)
    if _rows_local(x):
        return _normalized(_rms_rows, _RMSNorm, x, eps) * w.to(x.dtype)
    mesh, pl = x.device_mesh, list(x.placements)
    groups = [mesh.get_group(i) for i, a in enumerate(pl)
              if getattr(a, "dim", None) == x.ndim - 1]
    out = local_map(lambda t: _RMSNormShards.apply(t, eps, x.shape[-1],
                                                   groups),
                    out_placements=pl, in_placements=(pl,),
                    in_grad_placements=(pl,), device_mesh=mesh)(x)
    return out * w.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    """In float32, cast to x's dtype, then scaled by w and shifted by b;
    its float32 work kept as ``rms_norm`` keeps it (``_LayerNorm``, row
    chunks)."""
    x = reduced(x)
    out = _normalized(_layer_rows, _LayerNorm, x, eps) if _rows_local(x) \
        else _layer_rows(x, eps)
    return out * w.to(x.dtype) + b.to(x.dtype)


def gelu(x):
    """The tanh approximation (``jax.nn.gelu``'s default)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


# ---------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) float32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D/2) (broadcast over heads).
    Half-rotation (llama-style)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mrope_cos_sin(positions3, head_dim: int, theta: float,
                  sections: tuple[int, int, int]):
    """M-RoPE (qwen2-vl): positions3 (B, S, 3) = (t, h, w) ids; the rotary
    frequency bands are split into ``sections`` (sum = head_dim/2), each band
    driven by its own position channel. Returns cos/sin (B, S, head_dim/2)."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"sections {sections} do not sum to {head_dim // 2}")
    dev = positions3.device
    freqs = rope_freqs(head_dim, theta, dev)                 # (D/2,)
    ang_txy = positions3.float()[..., None, :] * freqs[None, None, :, None]
    # ang_txy: (B, S, D/2, 3); pick the driving channel of each band: the
    # count of section ends at or below each band (made from ``arange``
    # alone, so that a fake mode traces it: a tensor of the sections' values
    # would be a constant outside the trace)
    band = torch.arange(head_dim // 2, device=dev)
    sel = (band >= sections[0]).long() + (band >= sections[0] + sections[1]).long()
    ang = torch.gather(ang_txy, -1, sel[None, None, :, None].expand(
        *ang_txy.shape[:-1], 1))[..., 0]
    return torch.cos(ang), torch.sin(ang)


def causal_mask(sq: int, skv: int, offset: int = 0, device=None):
    """(Sq, Skv) bool: query i (at position i + offset) sees keys <= it."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    ki = torch.arange(skv, device=device)[None, :]
    return qi >= ki


# ---------------------------------------------------------------------- loss

def cross_entropy_loss(logits, labels, z_loss: float = 1e-4):
    """Mean next-token cross entropy in float32, plus ``z_loss`` times the
    mean squared log-normalizer (it keeps large vocab heads stable).
    logits (B, S, V), labels (B, S). On DTensor logits each rank computes
    it on its own vocabulary shard (``cross_entropy_on_shards``)."""
    if isinstance(logits, DTensor):
        return cross_entropy_on_shards(logits, labels, z_loss)
    lf = f32(logits)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    ce = (lse - gold).mean()
    if z_loss:
        ce = ce + z_loss * (lse ** 2).mean()
    return ce
