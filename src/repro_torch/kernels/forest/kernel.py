"""Bind the Hopper forest-inference kernel (``csrc/forest.cu``).

The CUDA source has a plain C entry point, compiled with ``nvcc`` into a
shared library at first use and loaded with ``ctypes`` (``kernels/_build.py``,
shared with the port's other kernels):

    int forest_predict_f32(x, partial, out, B, const Tables* tables, stream)

``Tables`` holds what a packed forest hands every call (its device
pointers and sizes), made once by ``ops.pack_tables``, so a call passes six
arguments. The kernel walks the packed tables: each block copies a group of
``TREE_GROUP`` trees' top ``split`` levels into shared memory and walks a
tile of samples through them, writing one partial sum per (group, sample);
a second kernel adds the partials in group order. Nothing here runs when the
module is imported: the CPU tests import it on hosts without ``nvcc``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .._build import Build

SOURCE = _build.CSRC / "forest.cu"

#: Trees one block walks; ``forest_tree_group()`` in the source must agree
#: (checked at load). The packed tables pad the tree count to a multiple.
TREE_GROUP = 4
#: Shared memory a group's tables may take (the tile of x comes on top):
#: all of a depth-11 group, which leaves room for two blocks an SM at the
#: engine's depth 10.
SMEM_TABLE_BYTES = 96 * 1024
#: The grid's second axis holds the groups.
MAX_GROUPS = 65535


class Tables(ctypes.Structure):
    """``struct Tables`` of ``csrc/forest.cu``, field for field."""
    _fields_ = [("nodes", ctypes.c_void_p), ("leaves", ctypes.c_void_p),
                ("n_features", ctypes.c_int), ("n_trees", ctypes.c_int),
                ("groups", ctypes.c_int), ("depth", ctypes.c_int),
                ("split", ctypes.c_int), ("leaf_stride", ctypes.c_int)]


def split_levels(depth: int) -> int:
    """Levels of each tree the kernel keeps in shared memory: all of them
    (and the leaves) when a group of ``TREE_GROUP`` trees fits
    ``SMEM_TABLE_BYTES``, else as many top levels as fit; the rest are read
    through L2. ``csrc/forest.cu``'s ``table_smem`` counts the same bytes."""
    leaves = 4 * leaf_stride(depth)
    if TREE_GROUP * ((8 << depth) + leaves) <= SMEM_TABLE_BYTES:
        return depth
    split = depth - 1
    while split > 0 and TREE_GROUP * (8 << split) > SMEM_TABLE_BYTES:
        split -= 1
    return split


def leaf_stride(depth: int) -> int:
    """Leaf values stored per tree: 2^depth, at least 4 (a 16-byte copy)."""
    return max(1 << depth, 4)


def build() -> Build:
    """Compile ``csrc/forest.cu`` unless this source and these flags were
    already built in this checkout. Returns the library, the command and
    nvcc's log."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    lib.forest_predict_f32.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    lib.forest_predict_f32.restype = ctypes.c_int
    lib.forest_tree_group.argtypes = []
    lib.forest_tree_group.restype = ctypes.c_int
    lib.forest_tile_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.forest_tile_rows.restype = ctypes.c_int
    group = lib.forest_tree_group()
    if group != TREE_GROUP:
        raise RuntimeError(f"{lib._name} walks groups of {group} trees, the "
                           f"wrapper expects {TREE_GROUP}")


_loaded: tuple = (None, None)      # (source, library): a call's lookup


def _library() -> ctypes.CDLL:
    global _loaded
    source, lib = _loaded
    if source is not SOURCE:
        lib = _build.load(SOURCE, _bind)
        _loaded = (SOURCE, lib)
    return lib


def tile_rows(packed, batch: int) -> int:
    """Samples per block the walk takes for ``batch`` rows of ``packed``
    (on the current device)."""
    return _library().forest_tile_rows(packed.tables_ptr, batch)


def forest_predict_kernel(x: torch.Tensor, packed) -> torch.Tensor:
    """Launch the kernel on the current stream of x's device; returns (B,)
    float32. Does not synchronise.

    ``packed`` is an ``ops.PackedForest`` on x's device: its tables were
    checked once, when packed. x is checked by the caller
    (``ops.check_rows``): (B, n_features) float32, contiguous, B >= 1."""
    lib = _library()
    B = x.shape[0]
    dev = x.device
    # one allocation per call: the answers, then the (groups, B) partials.
    # out is a view of it, so it keeps the partials' memory while it lives
    buf = torch.empty((packed.groups + 1) * B, dtype=torch.float32,
                      device=dev)
    out = buf[:B]
    ptr = buf.data_ptr()
    args = (x.data_ptr(), ptr + 4 * B, ptr, B, packed.tables_ptr,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.forest_predict_f32(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.forest_predict_f32(*args)
    if err != 0:
        raise RuntimeError(
            f"forest_predict_f32 launch failed: "
            f"{'no launch shape fits' if err < 0 else f'CUDA error {err}'} "
            f"(B={B}, F={packed.n_features}, T={packed.n_trees}, "
            f"depth={packed.depth}, split={packed.split})")
    return out
