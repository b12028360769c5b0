"""Bind the Hopper flash-attention kernel (``csrc/flash_attn.cu``).

The CUDA source has plain C entry points, one per input dtype, compiled with
``nvcc`` into a shared library at first use and loaded with ``ctypes``
(``kernels/_build.py``):

    int flash_attn_f32 (q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, D, kv_len,
                        kv_offset, causal, scale, strides[12], stream)
    int flash_attn_bf16(... the same, with q, k, v and o in bfloat16)

``strides`` holds the (batch, head, seq) strides of q, k, v and o; ``lse``
is null (not written) or a float32 (B, Hq, Sq) contiguous buffer. Nothing
here runs when the module is imported: the CPU tests import it on hosts
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from .._build import Build

SOURCE = _build.CSRC / "flash_attn.cu"

#: The largest head dim the kernel's tiles hold; the source's
#: ``flash_max_head_dim`` must agree (checked at load).
MAX_HEAD_DIM = 128

_ENTRY = {torch.float32: "flash_attn_f32", torch.bfloat16: "flash_attn_bf16"}


def build() -> Build:
    """Compile ``csrc/flash_attn.cu`` unless this source and these flags
    were already built in this checkout."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.POINTER(ctypes.c_longlong),
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.flash_max_head_dim.argtypes = []
    lib.flash_max_head_dim.restype = ctypes.c_int
    got = lib.flash_max_head_dim()
    if got != MAX_HEAD_DIM:
        raise RuntimeError(f"{lib._name} takes head dims up to {got}, the "
                           f"wrapper expects {MAX_HEAD_DIM}")


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool, sm_scale: float | None = None,
                           kv_len: int | None = None,
                           kv_offset: int | None = None,
                           return_lse: bool = False):
    """Launch the kernel on the current stream. Does not synchronise.

    q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); one dtype, f32 or bf16, each
    with D contiguous and other strides free (a transposed view of a
    (B, S, H, D) tensor is read in place). ``kv_len`` (default Skv) masks
    the keys past it; ``kv_offset`` (default Skv - Sq) aligns the causal
    mask; a negative one hides the first keys from the first rows (a key
    shard that starts later in the sequence). Returns o (B, Hq, Sq, D) in
    q's dtype, laid out as q is when q is dense (``torch.empty_like``); with
    ``return_lse``, (o, lse): lse (B, Hq, Sq) float32, each row's
    ln sum exp(scale q . k) over its valid keys, -inf where it has none."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device} "
                             f"(a CUDA device)")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{name} must be (B, H, S, D) with D contiguous")
    if q.dtype not in _ENTRY:
        raise ValueError(f"q is {q.dtype}; the kernel takes {list(_ENTRY)}")
    if tuple(k.shape) != (B, Hkv, Skv, D) or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, Hkv, Skv, {D})")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims 1..{MAX_HEAD_DIM}, "
                         f"got {D}")
    if min(B, Sq, Skv) < 1 or max(B, Hq) > 65535 or max(Sq, Skv) >= 2 ** 31:
        raise ValueError(f"unsupported shape q{tuple(q.shape)} "
                         f"k{tuple(k.shape)}")
    kv_len = Skv if kv_len is None else int(kv_len)
    kv_offset = Skv - Sq if kv_offset is None else int(kv_offset)
    if not 0 <= kv_len <= Skv:
        raise ValueError(f"kv_len {kv_len} outside [0, {Skv}]")
    scale = 1.0 / math.sqrt(D) if sm_scale is None else float(sm_scale)
    lib = _library()
    o = torch.empty_like(q)                  # q's strides, D contiguous
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), B, Hq, Hkv, Sq, Skv, D,
            kv_len, kv_offset, int(bool(causal)), scale, strides, stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[q.dtype]} launch failed: CUDA error "
                           f"{err} (q {tuple(q.shape)}, k {tuple(k.shape)})")
    return (o, lse) if return_lse else o
