"""Public wrapper for the forest-inference kernel.

Dispatch is by the device of ``x``: a CPU tensor takes the plain
``ref.forest_predict_ref``; a CUDA tensor launches the Hopper kernel
(``kernel.py``) or raises. Nothing falls back.

Padding contract (the reference's ``kernels/forest/ops.py``): the kernel
walks the trees in strides of ``TREE_STRIDE``, so the tables are padded to a
multiple of it with inert trees — feature 0, threshold +inf (always left),
value 0 — that contribute nothing, and the sum is divided by the REAL tree
count ``n_trees``. A caller that serves many calls pads once with
``pad_trees`` and passes ``n_trees``; ``forest_predict`` pads per call only
when given unpadded tables. Batches need no padding: the kernel handles a
ragged last tile itself.
"""
from __future__ import annotations

import threading

import torch

from .kernel import TREE_STRIDE, forest_predict_kernel
from .ref import forest_predict_ref

#: Kernel launches made by ``forest_predict`` in this process.
launches = 0
_launch_lock = threading.Lock()


def pad_trees(feature: torch.Tensor, threshold: torch.Tensor,
              value: torch.Tensor, multiple: int = TREE_STRIDE):
    """Pad the tree axis to a multiple of ``multiple`` with inert trees."""
    T, N = feature.shape
    pad = -T % multiple
    if pad == 0:
        return feature, threshold, value

    def rows(t, fill):
        return torch.cat([t, t.new_full((pad, N), fill)])
    return (rows(feature, 0), rows(threshold, float("inf")),
            rows(value, 0.0))


def forest_predict(x: torch.Tensor, feature: torch.Tensor,
                   threshold: torch.Tensor, value: torch.Tensor, *,
                   depth: int, n_trees: int | None = None) -> torch.Tensor:
    """Predict with a DenseForest layout. Returns (B,) float32 on x's device.

    x: (B, F). feature/threshold/value: (T, N) with N >= 2^(depth+1)-1 and
    feature entries in [-1, F). ``n_trees`` is the real tree count when the
    tables already carry inert padding (default: all T rows are real).
    """
    global launches
    n = feature.shape[0] if n_trees is None else int(n_trees)
    if x.device.type == "cpu":
        return forest_predict_ref(x, feature[:n], threshold[:n], value[:n],
                                  depth)
    if x.device.type != "cuda":
        raise ValueError(f"forest_predict runs on the CPU or a CUDA device, "
                         f"not {x.device}")
    if x.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=x.device)
    if feature.shape[0] % TREE_STRIDE:
        feature, threshold, value = pad_trees(feature, threshold, value)
    out = forest_predict_kernel(x, feature, threshold, value, depth=depth,
                                n_trees=n)
    with _launch_lock:
        launches += 1
    return out


def forest_predict_from_dense(dense, x: torch.Tensor) -> torch.Tensor:
    """Convenience over a ``repro_torch.core.forest_torch.DenseForest``: the
    tables go to x's device on every call."""
    dev = x.device
    return forest_predict(
        x, torch.as_tensor(dense.feature, dtype=torch.int32, device=dev),
        torch.as_tensor(dense.threshold, dtype=torch.float32, device=dev),
        torch.as_tensor(dense.value, dtype=torch.float32, device=dev),
        depth=dense.depth)
