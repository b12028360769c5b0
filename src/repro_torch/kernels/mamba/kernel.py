"""Bind the Hopper chunked-SSD kernel (``csrc/ssd.cu``).

The CUDA source has plain C entry points, one per input dtype, compiled with
``nvcc`` into a shared library at first use and loaded with ``ctypes``
(``kernels/_build.py``):

    int ssd_scan_f32 (x, alog, B, C, h0, y, h_out, Bsz, S, H, P, N, chunk,
                      x strides (b, s, h), alog strides (b, s, h),
                      B strides (b, s), C strides (b, s), workspace, stream)
    int ssd_scan_bf16(... the same, with x, B, C and y in bfloat16)
    long long ssd_workspace_bytes(Bsz, S, H, P, N, chunk)

The bf16 entry runs three kernels in order on the stream (per-chunk states,
the pass over the chunks, the chunks' outputs) through a workspace of
``ssd_workspace_bytes`` bytes that the wrapper allocates; the f32 entry runs
one kernel and takes no workspace.

Nothing here runs when the module is imported: the CPU tests import it on
hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import Build

SOURCE = _build.CSRC / "ssd.cu"

#: Limits of the kernel's shared-memory tiles; the source's
#: ``ssd_max_chunk``/``ssd_max_state``/``ssd_max_head_dim`` must agree
#: (checked at load).
MAX_CHUNK, MAX_STATE, MAX_HEAD_DIM = 128, 64, 64

_ENTRY = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}


def build() -> Build:
    """Compile ``csrc/ssd.cu`` unless this source and these flags were
    already built in this checkout."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    for name in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 10 + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    lib.ssd_workspace_bytes.argtypes = [ctypes.c_int] * 6
    lib.ssd_workspace_bytes.restype = ctypes.c_longlong
    limits = {}
    for name in ("ssd_max_chunk", "ssd_max_state", "ssd_max_head_dim"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
        limits[name] = getattr(lib, name)()
    want = {"ssd_max_chunk": MAX_CHUNK, "ssd_max_state": MAX_STATE,
            "ssd_max_head_dim": MAX_HEAD_DIM}
    if limits != want:
        raise RuntimeError(f"{lib._name} has limits {limits}, the wrapper "
                           f"expects {want}")


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def ssd_scan_kernel(x: torch.Tensor, alog: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int,
                    h0: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel (for bf16, its three passes) on the current
    stream. Does not synchronise.

    x: (Bsz, S, H, P) f32 or bf16 with P contiguous; alog: (Bsz, S, H) f32;
    B/C: (Bsz, S, N) in x's dtype with N contiguous; h0: None or
    (Bsz, H, N, P) f32 contiguous. Other strides are free (B and C may be
    column slices of one projection). A ragged last chunk is masked inside
    the kernel, so S needs no padding. Returns y (Bsz, S, H, P) in x's
    dtype and h (Bsz, H, N, P) f32, both contiguous."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    tensors = {"x": x, "alog": alog, "B": B, "C": C}
    if h0 is not None:
        tensors["h0"] = h0
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device} "
                             f"(a CUDA device)")
    if x.dtype not in _ENTRY:
        raise ValueError(f"x is {x.dtype}; the kernel takes {list(_ENTRY)}")
    for name, t, dt in (("B", B, x.dtype), ("C", C, x.dtype),
                        ("alog", alog, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"{name} is {t.dtype}, expected {dt}")
    want = {"alog": (Bsz, S, H), "B": (Bsz, S, N), "C": (Bsz, S, N)}
    if h0 is not None:
        want["h0"] = (Bsz, H, N, P)
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensors[name].shape)}, "
                             f"expected {shape}")
    if x.stride(3) != 1 or B.stride(2) != 1 or C.stride(2) != 1:
        raise ValueError("x's last axis and B's and C's must be contiguous")
    if h0 is not None and (h0.dtype != torch.float32
                           or not h0.is_contiguous()):
        raise ValueError("h0 must be a contiguous float32 tensor")
    if not (1 <= chunk <= MAX_CHUNK and 1 <= N <= MAX_STATE
            and 1 <= P <= MAX_HEAD_DIM):
        raise ValueError(f"the kernel takes chunk <= {MAX_CHUNK}, "
                         f"N <= {MAX_STATE}, P <= {MAX_HEAD_DIM}; got chunk "
                         f"{chunk}, N {N}, P {P}")
    if min(Bsz, S, H) < 1 or Bsz > 65535 or max(S, H) >= 2 ** 31:
        raise ValueError(f"unsupported shape x{tuple(x.shape)}")
    lib = _library()
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    # per-chunk states and h_in of the bf16 passes; freed on return while
    # the passes may still be queued, which is safe: the caching allocator
    # hands the block out again only to work queued after them on this
    # stream
    work = None
    if x.dtype == torch.bfloat16:
        work = torch.empty(lib.ssd_workspace_bytes(Bsz, S, H, P, N, chunk),
                           dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, _ENTRY[x.dtype])(
            x.data_ptr(), alog.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
            Bsz, S, H, P, N, chunk, *x.stride()[:3], *alog.stride(),
            *B.stride()[:2], *C.stride()[:2],
            None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{_ENTRY[x.dtype]} launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, N={N}, chunk={chunk})")
    return y, h
