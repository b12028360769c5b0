"""Bind the Hopper forest-inference kernel (``csrc/forest.cu``).

The CUDA source has a plain C entry point, compiled with ``nvcc`` into a
shared library at first use and loaded with ``ctypes`` (``kernels/_build.py``,
shared with the port's other kernels):

    int forest_predict_f32(x, feature, threshold, value, out,
                           B, F, T, N, depth, stream)

Nothing here runs when the module is imported: the CPU tests import it on
hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import Build

SOURCE = _build.CSRC / "forest.cu"

#: Trees one block strides over; ``forest_tree_stride()`` in the source
#: must agree (checked at load).
TREE_STRIDE = 192


def build() -> Build:
    """Compile ``csrc/forest.cu`` unless this source and these flags were
    already built in this checkout. Returns the library, the command and
    nvcc's log."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    lib.forest_predict_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.forest_predict_f32.restype = ctypes.c_int
    lib.forest_tree_stride.argtypes = []
    lib.forest_tree_stride.restype = ctypes.c_int
    lib.forest_tile_rows.argtypes = [ctypes.c_int]
    lib.forest_tile_rows.restype = ctypes.c_int
    stride = lib.forest_tree_stride()
    if stride != TREE_STRIDE:
        raise RuntimeError(f"{lib._name} strides over {stride} trees, the "
                           f"wrapper expects {TREE_STRIDE}")


def _library() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


def tile_rows(batch: int) -> int:
    """Samples per block the kernel picks for a batch of ``batch`` rows."""
    return _library().forest_tile_rows(batch)


def forest_predict_kernel(x: torch.Tensor, feature: torch.Tensor,
                          threshold: torch.Tensor, value: torch.Tensor, *,
                          depth: int, n_trees: int) -> torch.Tensor:
    """Launch the kernel on the current stream; returns (B,) float32.

    x: (B, F) f32; feature (i32) / threshold / value (f32): (T_rows, N)
    with N >= 2^(depth+1)-1 and T_rows >= ``n_trees`` rounded up to
    ``TREE_STRIDE`` (``ops.pad_trees``). All on one CUDA device and
    contiguous. Does not synchronise."""
    tensors = {"x": x, "feature": feature, "threshold": threshold,
               "value": value}
    dtypes = {"x": torch.float32, "feature": torch.int32,
              "threshold": torch.float32, "value": torch.float32}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device} "
                             f"(a CUDA device)")
        if t.dtype != dtypes[name]:
            raise ValueError(f"{name} is {t.dtype}, expected {dtypes[name]}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor, got "
                             f"shape {tuple(t.shape)}")
    B, F = x.shape
    rows, N = feature.shape
    if threshold.shape != feature.shape or value.shape != feature.shape:
        raise ValueError(f"table shapes differ: {tuple(feature.shape)}, "
                         f"{tuple(threshold.shape)}, {tuple(value.shape)}")
    if depth < 0 or N < 2 ** (depth + 1) - 1:
        raise ValueError(f"depth {depth} needs {2 ** (depth + 1) - 1} nodes "
                         f"per tree, the tables have {N}")
    padded = -(-n_trees // TREE_STRIDE) * TREE_STRIDE
    if n_trees < 1 or rows < padded:
        raise ValueError(f"{n_trees} trees need {padded} table rows "
                         f"(ops.pad_trees), got {rows}")
    if min(B, F) < 1 or max(B, F, rows, N) >= 2 ** 31:
        raise ValueError(f"unsupported shape x{tuple(x.shape)} "
                         f"tables{tuple(feature.shape)}")
    lib = _library()
    out = torch.empty(B, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.forest_predict_f32(
            x.data_ptr(), feature.data_ptr(), threshold.data_ptr(),
            value.data_ptr(), out.data_ptr(), B, F, n_trees, N, depth, stream)
    if err != 0:
        raise RuntimeError(f"forest_predict_f32 launch failed: CUDA error "
                           f"{err} (B={B}, F={F}, T={n_trees}, N={N}, "
                           f"depth={depth})")
    return out
