"""Public wrapper for the forest-inference kernel.

A forest is packed once (``pack_tables``): its dense tables are checked
(device, dtypes, shapes, depth, feature range) and turned into the layout the
kernel reads, a ``PackedForest`` on the tables' device. A call then checks
only the rows x (``check_rows``) and launches.

Dispatch is by the device of ``x``: a CPU tensor takes a plain version
(``ref.py``); a CUDA tensor launches the Hopper kernel (``kernel.py``) or
raises. Nothing falls back.

Padding contract (the reference's ``kernels/forest/ops.py``): dense tables
may carry inert trees past the real ones; ``n_trees`` is the real count,
the rest is never read, and the mean divides by ``n_trees``. The packed
tables pad the tree count to a multiple of ``TREE_GROUP`` with inert trees
of their own. Batches need no padding: the kernel handles a ragged last
tile itself.
"""
from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass

import torch

from .kernel import (MAX_GROUPS, TREE_GROUP, Tables, forest_predict_kernel,
                     leaf_stride, split_levels)
from .ref import forest_predict_packed_ref, forest_predict_ref

#: Kernel launches made by ``forest_predict`` / ``forest_predict_packed`` in
#: this process.
launches = 0
_launch_lock = threading.Lock()

_INF_BITS = 0x7F800000          # float32 +inf, as an int32


@dataclass(frozen=True, eq=False)
class PackedForest:
    """A forest in the kernel's layout, on one device.

    ``nodes`` (T_pad, 2^depth, 2) int32: per tree, records 0 .. 2^depth - 2
    are the nodes of levels 0 .. depth-1 as {threshold f32 bits, feature};
    the last record is padding. A node with feature -1 (goes left whatever x
    holds) carries threshold +inf. ``leaves`` (T_pad, ``leaf_stride``)
    float32: level ``depth`` of ``value``. T_pad is ``n_trees`` rounded up
    to ``TREE_GROUP``; the trees past ``n_trees`` are inert (feature -1,
    leaves 0). ``split`` levels of each tree go to the kernel's shared
    memory."""

    nodes: torch.Tensor
    leaves: torch.Tensor
    depth: int
    n_trees: int
    n_features: int
    groups: int
    split: int
    leaf_stride: int
    device: torch.device
    tables: Tables               # what the kernel's entry point reads
    tables_ptr: int              # its address

    @property
    def nbytes(self) -> int:
        """Bytes of the packed tables on the device."""
        return (self.nodes.numel() * self.nodes.element_size()
                + self.leaves.numel() * self.leaves.element_size())


def pack_tables(feature: torch.Tensor, threshold: torch.Tensor,
                value: torch.Tensor, *, depth: int, n_features: int,
                n_trees: int | None = None) -> PackedForest:
    """Check a DenseForest's tables once and pack them on their device.

    feature (int32) / threshold / value (float32): (T, N), one device, with
    N >= 2^(depth+1)-1; the first ``n_trees`` rows are the forest (default:
    all). ``n_features``: the width of the rows it will be given; every
    feature read by a walk must lie in [-1, n_features). Raises ValueError
    on anything else."""
    for name, t, dtype in (("feature", feature, torch.int32),
                           ("threshold", threshold, torch.float32),
                           ("value", value, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}, expected {dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape "
                             f"{tuple(t.shape)}")
        if t.device != feature.device:
            raise ValueError(f"{name} is on {t.device}, feature on "
                             f"{feature.device}")
    if threshold.shape != feature.shape or value.shape != feature.shape:
        raise ValueError(f"table shapes differ: {tuple(feature.shape)}, "
                         f"{tuple(threshold.shape)}, {tuple(value.shape)}")
    rows, N = feature.shape
    if depth < 0 or N < 2 ** (depth + 1) - 1:
        raise ValueError(f"depth {depth} needs {2 ** (depth + 1) - 1} nodes "
                         f"per tree, the tables have {N}")
    T = rows if n_trees is None else int(n_trees)
    if not 1 <= T <= rows:
        raise ValueError(f"{T} trees asked for, the tables hold {rows}")
    groups = -(-T // TREE_GROUP)
    if groups > MAX_GROUPS or depth > 24:
        raise ValueError(f"unsupported forest: {T} trees of depth {depth}")
    inner = 2 ** depth - 1
    feat = feature[:T, :inner]
    lo = int(feat.min()) if inner else -1
    hi = int(feat.max()) if inner else -1
    F = int(n_features)
    if not 1 <= F < 2 ** 31:
        raise ValueError(f"unsupported feature count {F}")
    if lo < -1 or hi >= F:
        raise ValueError(f"features must lie in [-1, {F}), the tables hold "
                         f"[{lo}, {hi}]")

    T_pad = groups * TREE_GROUP
    nodes = torch.empty((T_pad, 2 ** depth, 2), dtype=torch.int32,
                        device=feature.device)
    nodes[..., 0] = _INF_BITS
    nodes[..., 1] = -1
    thr = threshold[:T, :inner].contiguous().view(torch.int32)
    nodes[:T, :inner, 0] = torch.where(feat < 0, _INF_BITS, thr)
    nodes[:T, :inner, 1] = feat
    leaves = torch.zeros((T_pad, leaf_stride(depth)), dtype=torch.float32,
                         device=feature.device)
    leaves[:T, :2 ** depth] = value[:T, inner:inner + 2 ** depth]
    split = split_levels(depth)
    tables = Tables(nodes.data_ptr(), leaves.data_ptr(), F, T, groups, depth,
                    split, leaves.shape[1])
    return PackedForest(nodes=nodes, leaves=leaves, depth=depth, n_trees=T,
                        n_features=F, groups=groups, split=split,
                        leaf_stride=leaves.shape[1], device=nodes.device,
                        tables=tables,
                        tables_ptr=ctypes.addressof(tables))


def check_rows(x: torch.Tensor, packed: PackedForest) -> None:
    """The per-call check: x is (B, n_features) float32, contiguous, on the
    packed tables' device."""
    if x.device != packed.device:
        raise ValueError(f"x is on {x.device}, the packed forest on "
                         f"{packed.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"x is {x.dtype}, expected torch.float32")
    if x.dim() != 2 or x.shape[1] != packed.n_features:
        raise ValueError(f"x must be (B, {packed.n_features}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def forest_predict_packed(x: torch.Tensor,
                          packed: PackedForest) -> torch.Tensor:
    """Predict with a packed forest. Returns (B,) float32 on x's device.

    The served path: ``serve/backend.py`` packs once per forest and calls
    this per batch. On the CPU it takes the plain walk over the packed
    layout; on a CUDA device it launches the kernel."""
    global launches
    check_rows(x, packed)              # x is on packed.device from here
    kind = packed.device.type
    if kind == "cpu":
        return forest_predict_packed_ref(x, packed)
    if kind != "cuda":
        raise ValueError(f"forest_predict runs on the CPU or a CUDA device, "
                         f"not {x.device}")
    if x.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=x.device)
    out = forest_predict_kernel(x, packed)
    with _launch_lock:
        launches += 1
    return out


def forest_predict(x: torch.Tensor, feature: torch.Tensor,
                   threshold: torch.Tensor, value: torch.Tensor, *,
                   depth: int, n_trees: int | None = None) -> torch.Tensor:
    """Predict with a DenseForest layout. Returns (B,) float32 on x's device.

    x: (B, F). feature/threshold/value: (T, N) with N >= 2^(depth+1)-1 and
    feature entries in [-1, F). ``n_trees`` is the real tree count when the
    tables already carry inert padding (default: all T rows are real). On a
    CUDA device the tables are packed on every call: a caller that serves
    many calls packs once (``pack_tables``) and calls
    ``forest_predict_packed``.
    """
    n = feature.shape[0] if n_trees is None else int(n_trees)
    if x.device.type == "cpu":
        return forest_predict_ref(x, feature[:n], threshold[:n], value[:n],
                                  depth)
    if x.device.type != "cuda":
        raise ValueError(f"forest_predict runs on the CPU or a CUDA device, "
                         f"not {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D, got shape {tuple(x.shape)}")
    packed = pack_tables(feature, threshold, value, depth=depth, n_trees=n,
                         n_features=x.shape[1])
    return forest_predict_packed(x, packed)


def forest_predict_from_dense(dense, x: torch.Tensor) -> torch.Tensor:
    """Convenience over a ``repro_torch.core.forest_torch.DenseForest``: the
    tables go to x's device on every call."""
    dev = x.device
    return forest_predict(
        x, torch.as_tensor(dense.feature, dtype=torch.int32, device=dev),
        torch.as_tensor(dense.threshold, dtype=torch.float32, device=dev),
        torch.as_tensor(dense.value, dtype=torch.float32, device=dev),
        depth=dense.depth)
