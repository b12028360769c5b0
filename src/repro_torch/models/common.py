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
from torch.utils.checkpoint import checkpoint

from ..core.forest_torch import resolve_device
from ..sharding.context import cross_entropy_on_shards, in_scope, reduced

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


def rms_norm(x, w, eps: float = 1e-5):
    """In float32, cast to x's dtype, and only then scaled by w. On a
    DTensor whose normalized dimension is sharded (the Mamba2 gated norm
    over the inner dimension) the mean square is all-reduced, a (B, S, 1)
    statistic, and so is its gradient: the normalization and its backward
    run on the shards."""
    xf = f32(x)
    if isinstance(x, DTensor) and any(
            getattr(p, "dim", None) == x.ndim - 1 for p in x.placements):
        var = reduced(torch.sum(xf * xf, dim=-1, keepdim=True))
        # the identity, whose backward reduces a partial gradient here
        var = var.redistribute(var.device_mesh, var.placements) / x.shape[-1]
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    """In float32, cast to x's dtype, then scaled by w and shifted by b."""
    xf = f32(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


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
