"""Plain-torch oracle for dense-forest inference.

Gather-based level walk over the complete-binary-tree layout
(``repro_torch.core.forest_torch.DenseForest``): node ``i`` has children
``2i+1`` / ``2i+2``; virtual/leaf nodes carry ``feature == -1`` and
``threshold == +inf`` so the walk is branch-free. ``xv <= thr`` goes left,
so a NaN feature goes right; feature -1 goes left. This is the semantic
ground truth the CUDA kernel is held to, on the CPU and on the card.
"""
from __future__ import annotations

import torch


def forest_predict_ref(x, feature, threshold, value, depth: int) -> torch.Tensor:
    """x: (B, F) float; feature/threshold/value: (T, N) with N = 2^(depth+1)-1.

    Returns (B,) float32 — mean over trees of the leaf value reached after
    exactly ``depth`` branch-free steps."""
    x = x.to(torch.float32)
    B = x.shape[0]
    T = feature.shape[0]
    trees = torch.arange(T, device=x.device)[None, :]
    cur = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    for _ in range(depth):
        feat = feature[trees, cur]                       # (B, T)
        f = feat.clamp_min(0).long()
        xv = torch.gather(x, 1, f)
        thr = threshold[trees, cur]
        go_left = torch.where(feat >= 0, xv <= thr, True)
        cur = torch.where(go_left, 2 * cur + 1, 2 * cur + 2)
    return value[trees, cur].mean(dim=1).to(torch.float32)
