"""Build and bind the Hopper forest-inference kernel (``csrc/forest.cu``).

The CUDA source has a plain C entry point, compiled with ``nvcc`` into a
shared library at first use and loaded with ``ctypes``:

    int forest_predict_f32(x, feature, threshold, value, out,
                           B, F, T, N, depth, stream)

The library goes to ``build/kernels/`` at the root of the checkout, named by
a hash of the source and the flags, so an edited source builds anew and an
unchanged one is built once per checkout. A failed build raises. Nothing
here runs when the module is imported: the CPU tests import it on hosts
without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "forest.cu"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Trees one block strides over; ``forest_tree_stride()`` in the source
#: must agree (checked at load).
TREE_STRIDE = 192


@dataclass(frozen=True)
class Build:
    library: Path
    command: tuple[str, ...]
    log: str                      # nvcc's output, with the -Xptxas -v lines


_lock = threading.Lock()
_build: Build | None = None
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the forest kernel cannot be built "
                       "(put nvcc on PATH or set CUDA_HOME)")


def build() -> Build:
    """Compile ``csrc/forest.cu`` unless this source and these flags were
    already built in this checkout. Returns the library, the command and
    nvcc's log."""
    global _build
    with _lock:
        if _build is not None:
            return _build
        digest = hashlib.sha256(
            SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = BUILD_DIR / f"forest_{digest}.so"
        log_path = lib.with_suffix(".log")
        nvcc = _nvcc()

        def command(out: Path) -> tuple[str, ...]:
            return (nvcc, *NVCC_FLAGS, "-o", str(out), str(SOURCE))
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # nvcc names the output's kind by its suffix: keep ".so"
            tmp = BUILD_DIR / f"{lib.stem}.{os.getpid()}.tmp.so"
            proc = subprocess.run(command(tmp), capture_output=True,
                                  text=True)
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(command(tmp))}\n{log}")
            log_path.write_text(log)
            tmp.replace(lib)
        log = log_path.read_text() if log_path.exists() else ""
        _build = Build(library=lib, command=command(lib), log=log)
        return _build


def _library() -> ctypes.CDLL:
    global _lib
    info = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(info.library))
            lib.forest_predict_f32.argtypes = (
                [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            lib.forest_predict_f32.restype = ctypes.c_int
            lib.forest_tree_stride.argtypes = []
            lib.forest_tree_stride.restype = ctypes.c_int
            lib.forest_tile_rows.argtypes = [ctypes.c_int]
            lib.forest_tile_rows.restype = ctypes.c_int
            stride = lib.forest_tree_stride()
            if stride != TREE_STRIDE:
                raise RuntimeError(f"{info.library} strides over {stride} "
                                   f"trees, the wrapper expects {TREE_STRIDE}")
            _lib = lib
        return _lib


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
