"""Public wrapper for flash attention (kernel B2).

Dispatch is by the device of ``q``: a CPU tensor takes the plain
``ref.attention_ref``; a CUDA tensor launches the Hopper kernel
(``kernel.py``) or raises; any other device raises. Nothing falls back.

Gradients: the reference has no backward kernel (its Pallas kernel cannot
be differentiated at all), so ``flash_attention`` is a
``torch.autograd.Function`` whose forward is the kernel (the plain version
on the CPU) and whose backward recomputes the plain version under
``enable_grad`` and returns its ``torch.autograd.grad``. The forward never
leaves the kernel; only the backward is plain torch, until a backward
kernel lands. With ``return_lse`` the Function has two outputs, o and the
rows' log-sum-exp, and its backward takes the gradient of both (a merge of
attentions over key shards differentiates through lse).

The reference pads Sq and Skv to tile multiples and D to 128 around its TPU
kernel (``kernels/attention/ops.py``); the Hopper kernel masks ragged tiles
itself and takes any D up to 128, so nothing is padded here.
"""
from __future__ import annotations

import threading

import torch

from .. import watch
from .kernel import flash_attention_kernel
from .ref import attention_ref

#: Kernel launches made by ``flash_attention`` in this process.
launches = 0
_launch_lock = threading.Lock()


def _forward(q, k, v, causal: bool, sm_scale: float | None,
             kv_offset: int | None, return_lse: bool):
    global launches
    kw = dict(causal=causal, sm_scale=sm_scale, kv_offset=kv_offset,
              return_lse=return_lse)
    if q.device.type == "cpu":
        out = attention_ref(q, k, v, **kw)
    elif q.device.type == "cuda":
        out = flash_attention_kernel(q, k, v, **kw)
        with _launch_lock:
            launches += 1
    else:
        raise ValueError(f"flash_attention runs on the CPU or a CUDA device, "
                         f"not {q.device}")
    return watch.called("flash_attention", {"q": q, "k": k, "v": v, **kw},
                        out)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, kv_offset, return_lse):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, sm_scale=sm_scale, kv_offset=kv_offset,
                      return_lse=return_lse)
        return _forward(q, k, v, causal, sm_scale, kv_offset, return_lse)

    @staticmethod
    def backward(ctx, *grads_out):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            out = attention_ref(*inputs, **ctx.kw)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grads_out))
        return (*(next(grads) if n else None for n in need),) + (None,) * 4


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    kv_offset: int | None = None, return_lse: bool = False):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D), Hq % Hkv == 0. The causal
    mask is aligned to the end (query row r sees keys up to r + kv_offset,
    by default r + Skv - Sq; a key shard that starts at position ``start``
    of the queries' sequence takes ``kv_offset = -start``); a row that sees
    no key gives 0. ``sm_scale`` defaults to 1/sqrt(D). Returns (B, Hq, Sq,
    D) in q's dtype; with ``return_lse``, (o, lse), lse (B, Hq, Sq) each
    row's log-sum-exp of its scaled scores (-inf where it sees no key), in
    float32 (float64 for float64 inputs on the CPU). Differentiable in q, k
    and v, through lse too."""
    if q.dim() != 4 or min(q.shape[2], k.shape[2]) < 1:
        raise ValueError(f"flash_attention needs (B, H, S, D) inputs with "
                         f"S >= 1, got q{tuple(q.shape)} k{tuple(k.shape)}")
    return _FlashAttention.apply(q, k, v, bool(causal), sm_scale,
                                 None if kv_offset is None else int(kv_offset),
                                 bool(return_lse))
