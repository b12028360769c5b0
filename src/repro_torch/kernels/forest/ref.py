"""Plain-torch oracle for dense-forest inference.

Gather-based level walk over the complete-binary-tree layout
(``repro_torch.core.forest_torch.DenseForest``): node ``i`` has children
``2i+1`` / ``2i+2``; virtual/leaf nodes carry ``feature == -1`` and
``threshold == +inf`` so the walk is branch-free. ``xv <= thr`` goes left,
so a NaN feature goes right; feature -1 goes left. This is the semantic
ground truth the CUDA kernel is held to, on the CPU and on the card.
``forest_predict_packed_ref`` walks the kernel's packed layout
(``ops.pack_tables``) in the kernel's summation order: the plain version a
packed forest takes on the CPU.
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


#: Strided runs the kernel's sum takes over the groups (``kSumWarps`` in
#: ``csrc/forest.cu``).
SUM_RUNS = 8


def forest_predict_packed_ref(x, packed) -> torch.Tensor:
    """The kernel's plain version: the same walk over the packed layout
    (``ops.PackedForest``), summed in the kernel's order, and divided by the
    real tree count. The kernel adds each group's trees in tree order into a
    partial, then the partials in ``SUM_RUNS`` strided runs (run w: groups
    w, w + SUM_RUNS, ... in order), then the runs in order. x:
    (B, n_features) float32 on the packed tables' device."""
    x = x.to(torch.float32)
    B = x.shape[0]
    T_pad, nd, _ = packed.nodes.shape
    group = T_pad // packed.groups
    thr = packed.nodes[..., 0].view(torch.float32)
    feat = packed.nodes[..., 1].long()
    trees = torch.arange(T_pad, device=x.device)[None, :]
    cur = torch.zeros((B, T_pad), dtype=torch.int64, device=x.device)
    # feature -1 reads a column of -inf, which goes left of any threshold
    xi = torch.cat([x, x.new_full((B, 1), float("-inf"))], dim=1)
    for _ in range(packed.depth):
        f = feat[trees, cur]
        xv = torch.gather(xi, 1, torch.where(f < 0, x.shape[1], f))
        cur = torch.where(xv <= thr[trees, cur], 2 * cur + 1, 2 * cur + 2)
    leaf = packed.leaves[trees, cur - (nd - 1)].reshape(B, packed.groups,
                                                        group)
    zero = torch.zeros(B, dtype=torch.float32, device=x.device)
    partial = [zero] * packed.groups
    for g in range(packed.groups):
        for j in range(group):
            partial[g] = partial[g] + leaf[:, g, j]
    total = zero
    for w in range(SUM_RUNS):
        run = zero
        for g in range(w, packed.groups, SUM_RUNS):
            run = run + partial[g]
        total = total + run
    # a tensor divisor: a scalar one may become a product by its reciprocal
    return total / torch.full_like(total, packed.n_trees)
