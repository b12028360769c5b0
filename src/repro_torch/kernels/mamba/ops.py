"""Public wrapper for the chunked SSD scan.

Dispatch is by the device of ``x``: a CPU tensor takes the plain
``ref.ssd_chunked``; a CUDA tensor launches the Hopper kernel
(``kernel.py``) or raises; any other device raises. Nothing falls back.

The chunk follows the reference's ``kernels/mamba/ops.py``:
``min(chunk, S rounded up to 8)``. A ragged last chunk needs no padded copy
of the inputs: the kernel masks it (zero inputs and zero log-decay past S,
which is exact), and ``ssd_chunked`` pads it with the same zeros.

Gradients: the reference has no backward kernel (its Pallas kernel cannot
be differentiated at all), so ``ssd_scan`` is a ``torch.autograd.Function``
whose forward is the kernel (the plain version on the CPU) and whose
backward recomputes ``ssd_chunked`` under ``enable_grad`` and returns its
``torch.autograd.grad``, for x, alog, B and C. The training path discards
the final state and starts from a zero state, so there is no gradient for
``h0`` or through ``h_final``: asking for one raises.
"""
from __future__ import annotations

import threading

import torch

from .. import watch
from .kernel import ssd_scan_kernel
from .ref import ssd_chunked

#: Kernel launches made by ``ssd_scan`` in this process.
launches = 0
_launch_lock = threading.Lock()


def _forward(x, alog, B, C, h0, chunk: int):
    global launches
    if x.device.type == "cpu":
        out = ssd_chunked(x, alog, B, C, h0=h0, chunk=chunk)
    elif x.device.type == "cuda":
        out = ssd_scan_kernel(x, alog, B, C, chunk=chunk, h0=h0)
        with _launch_lock:
            launches += 1
    else:
        raise ValueError(f"ssd_scan runs on the CPU or a CUDA device, "
                         f"not {x.device}")
    return watch.called("ssd_scan", {"x": x, "alog": alog, "B": B, "C": C,
                                     "h0": h0, "chunk": chunk}, out)


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alog, B, C, h0, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, alog, B, C, h0)
        ctx.chunk = chunk
        return _forward(x, alog, B, C, h0, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_h):
        if grad_h is not None:
            raise RuntimeError("ssd_scan has no gradient through its final "
                               "state h (the training path discards it)")
        need = ctx.needs_input_grad[:4]
        if grad_y is None:
            return (None,) * 6
        x, alog, B, C, h0 = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip((x, alog, B, C), need)]
            y, _ = ssd_chunked(*inputs, h0=h0, chunk=ctx.chunk)
            grads = iter(torch.autograd.grad(
                y, [t for t in inputs if t.requires_grad], grad_y))
        return (*(next(grads) if n else None for n in need), None, None)


def ssd_scan(x: torch.Tensor, alog: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 128,
             h0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (Bsz, S, H, P); alog: (Bsz, S, H); B/C: (Bsz, S, N); h0: None
    (zero state) or (Bsz, H, N, P). Returns (y (Bsz, S, H, P) in x's dtype,
    h_final (Bsz, H, N, P) float32); y is differentiable in x, alog, B and
    C."""
    S = x.shape[1]
    if S < 1:
        raise ValueError("ssd_scan needs at least one step")
    if h0 is not None and h0.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("ssd_scan has no gradient for h0 (the training "
                           "path starts from a zero state)")
    chunk = min(chunk, -(-S // 8) * 8)
    return _SSDScan.apply(x, alog, B, C, h0, chunk)
