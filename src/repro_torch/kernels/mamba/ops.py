"""Public wrapper for the chunked SSD scan.

Dispatch is by the device of ``x``: a CPU tensor takes the plain
``ref.ssd_chunked``; a CUDA tensor launches the Hopper kernel
(``kernel.py``) or raises; any other device raises. Nothing falls back.

The chunk follows the reference's ``kernels/mamba/ops.py``:
``min(chunk, S rounded up to 8)``. A ragged last chunk needs no padded copy
of the inputs: the kernel masks it (zero inputs and zero log-decay past S,
which is exact), and ``ssd_chunked`` pads it with the same zeros.
"""
from __future__ import annotations

import threading

import torch

from .kernel import ssd_scan_kernel
from .ref import ssd_chunked

#: Kernel launches made by ``ssd_scan`` in this process.
launches = 0
_launch_lock = threading.Lock()


def ssd_scan(x: torch.Tensor, alog: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 128,
             h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (Bsz, S, H, P); alog: (Bsz, S, H); B/C: (Bsz, S, N); h0: None
    (zero state) or (Bsz, H, N, P). Returns (y (Bsz, S, H, P) in x's dtype,
    h_final (Bsz, H, N, P) float32)."""
    global launches
    S = x.shape[1]
    if S < 1:
        raise ValueError("ssd_scan needs at least one step")
    chunk = min(chunk, -(-S // 8) * 8)
    if x.device.type == "cpu":
        return ssd_chunked(x, alog, B, C, h0=h0, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on the CPU or a CUDA device, "
                         f"not {x.device}")
    out = ssd_scan_kernel(x, alog, B, C, chunk=chunk, h0=h0)
    with _launch_lock:
        launches += 1
    return out
