"""Torch inference paths for the fitted forest (counterpart of
``repro.core.forest_jax``).

Two layouts:

1. ``FlatForest`` (exact): sparse node arrays + gather-based traversal.
   Works for unbounded-depth trees. ``FlatForestTorch`` is the exact
   gather walk of the reference's ``_predict_flat_jax``.

2. ``DenseForest``: every tree is embedded into a *complete* binary tree of
   fixed depth D (child index = 2i+1 / 2i+2, no child pointers). Traversal
   is level-synchronous; ``DenseForestTorch`` is the plain torch walk and
   the oracle of the CUDA kernel in ``kernels/forest``. Trees deeper than D
   are truncated: the cut subtree is replaced by its node value (the node's
   training-set mean), a bounded, measured approximation.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``;
asking for a CUDA device on a host without one raises.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .forest import ExtraTreesRegressor, FlatForest


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist. Nothing
    falls back to the CPU: a caller that wants the CPU asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device; "
            f"pass device='cpu' to run on the host")
    return dev


# ---------------------------------------------------------------- flat (exact)

def _predict_flat_torch(feature, threshold, left, right, value, roots, x,
                        max_depth: int) -> torch.Tensor:
    B = x.shape[0]
    T = roots.shape[0]
    cur = roots[None, :].expand(B, T)
    for _ in range(max_depth):
        feat = torch.take(feature, cur)               # (B, T)
        active = feat >= 0
        f = torch.where(active, feat, 0)
        xv = torch.gather(x, 1, f)                    # (B, T) gather from (B, F)
        thr = torch.take(threshold, cur)
        nxt = torch.where(xv <= thr, torch.take(left, cur),
                          torch.take(right, cur))
        cur = torch.where(active, nxt, cur)
    return torch.take(value, cur).mean(dim=1)


class FlatForestTorch:
    """Exact inference over a FlatForest, on ``device``."""

    def __init__(self, forest: FlatForest, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        # node indices are int64: torch's gathers index with int64
        self.feature, self.left, self.right, self.roots = (
            torch.as_tensor(a.astype(np.int64), device=self.device)
            for a in (forest.feature, forest.left, forest.right, forest.roots))
        self.threshold, self.value = (
            torch.as_tensor(a, dtype=torch.float32, device=self.device)
            for a in (forest.threshold, forest.value))
        self.max_depth = int(forest.max_depth)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return _predict_flat_torch(self.feature, self.threshold, self.left,
                                   self.right, self.value, self.roots, x,
                                   max_depth=self.max_depth)


# ------------------------------------------------------------------ dense path

@dataclass
class DenseForest:
    """Complete-binary-tree layout, one row per tree.

    node i children are 2i+1, 2i+2; level ``d`` occupies [2^d - 1, 2^{d+1}-1).
    ``feature`` is -1 at virtual/leaf nodes; their ``threshold`` is +inf so
    traversal always takes the left child whose value repeats the parent's
    (self-replicating leaves), keeping the level loop branch-free.
    """
    feature: np.ndarray    # (T, N) int32
    threshold: np.ndarray  # (T, N) float32
    value: np.ndarray      # (T, N) float32
    depth: int
    n_features: int

    @property
    def n_trees(self) -> int:
        return int(self.feature.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[1])


def to_dense(est: ExtraTreesRegressor, depth: int,
             n_trees: int | None = None) -> DenseForest:
    trees = est.trees_ if n_trees is None else est.trees_[:n_trees]
    T = len(trees)
    N = 2 ** (depth + 1) - 1
    feature = np.full((T, N), -1, dtype=np.int32)
    threshold = np.full((T, N), np.float32(np.inf))
    value = np.zeros((T, N), dtype=np.float32)
    for ti, t in enumerate(trees):
        # embed: (sparse node, dense slot, level). Traversal always walks
        # exactly ``depth`` levels, so only values at level ``depth`` are ever
        # read; terminal nodes (+inf threshold => always-left) replicate their
        # value down the left spine to that level.
        stack = [(0, 0, 0)]
        while stack:
            s, d, lvl = stack.pop()
            if t.feature[s] >= 0 and lvl < depth:
                feature[ti, d] = t.feature[s]
                threshold[ti, d] = t.threshold[s]
                stack.append((int(t.left[s]), 2 * d + 1, lvl + 1))
                stack.append((int(t.right[s]), 2 * d + 2, lvl + 1))
            else:
                val = t.value[s]        # leaf value, or truncated-subtree mean
                dd, l = d, lvl
                value[ti, dd] = val
                while l < depth:
                    dd = 2 * dd + 1
                    l += 1
                    value[ti, dd] = val
    return DenseForest(feature=feature, threshold=threshold, value=value,
                       depth=depth, n_features=est.n_features_)


def dense_leaf_sum(feature, threshold, value, x, depth: int) -> torch.Tensor:
    """SUM of per-tree leaf values, (B,) — the shard-combinable core of dense
    traversal. Inert (padded) trees carry value 0 everywhere and contribute
    nothing, so a partitioned forest's prediction is
    ``sum(shard sums) / n_real_trees``."""
    B = x.shape[0]
    T = feature.shape[0]
    cur = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    trees = torch.arange(T, device=x.device)[None, :]
    for _ in range(depth):
        feat = feature[trees, cur]                    # (B, T)
        f = feat.clamp_min(0).long()
        xv = torch.gather(x, 1, f)
        thr = threshold[trees, cur]
        go_left = torch.where(feat >= 0, xv <= thr, True)
        cur = torch.where(go_left, 2 * cur + 1, 2 * cur + 2)
    return value[trees, cur].sum(dim=1)


class DenseForestTorch:
    """Plain dense traversal on ``device`` (oracle for the CUDA kernel)."""

    def __init__(self, forest: DenseForest,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.feature = torch.as_tensor(forest.feature, dtype=torch.int32,
                                       device=self.device)
        self.threshold = torch.as_tensor(forest.threshold, dtype=torch.float32,
                                         device=self.device)
        self.value = torch.as_tensor(forest.value, dtype=torch.float32,
                                     device=self.device)
        self.depth = int(forest.depth)

    def __call__(self, x) -> torch.Tensor:
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        return (dense_leaf_sum(self.feature, self.threshold, self.value, x,
                               self.depth) / self.feature.shape[0])
