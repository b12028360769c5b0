"""Extremely Randomized Trees regression, from scratch (paper §3.3).

The paper uses scikit-learn's ``ExtraTreesRegressor``; sklearn is not
available here so the estimator is implemented from first principles
(Geurts et al., 2006):

  * at every node, ``K = max_features`` candidate features are drawn without
    replacement from the features that are non-constant at the node,
  * for each candidate ONE split threshold is drawn uniformly in
    ``[min, max)`` of the feature's values at the node,
  * the candidate with the best criterion score (variance reduction for
    ``mse``, absolute-deviation-around-the-median reduction for ``mae``)
    becomes the split,
  * no bootstrap: every tree sees the full training set (sklearn default for
    extra trees).

Trees are stored as flat numpy arrays (structure-of-arrays), which makes
batch prediction a handful of vectorized gathers per depth level and converts
directly to the torch and CUDA inference paths (``forest_torch.py`` and
``kernels/forest``).

A copy of ``repro.core.forest``: the same seed, X and y give bitwise-equal
trees and predictions under both packages.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal

import numpy as np

Criterion = Literal["mse", "mae"]
MaxFeatures = Literal["max", "sqrt", "log2"]

LEAF = np.int32(-1)


def _resolve_k(max_features: MaxFeatures | int, n_features: int) -> int:
    if isinstance(max_features, int):
        return max(1, min(max_features, n_features))
    if max_features == "max":
        return n_features
    if max_features == "sqrt":
        return max(1, int(math.sqrt(n_features)))
    if max_features == "log2":
        return max(1, int(math.log2(n_features)))
    raise ValueError(f"bad max_features: {max_features!r}")


@dataclass
class Tree:
    """Flat array representation of one decision tree."""
    feature: np.ndarray     # (n_nodes,) int32, -1 for leaves
    threshold: np.ndarray   # (n_nodes,) float32
    left: np.ndarray        # (n_nodes,) int32 child index (-1 for leaves)
    right: np.ndarray       # (n_nodes,) int32
    value: np.ndarray       # (n_nodes,) float32 prediction value of the node
    n_samples: np.ndarray   # (n_nodes,) int32
    impurity: np.ndarray    # (n_nodes,) float32 (criterion units)

    @property
    def n_nodes(self) -> int:
        return int(self.feature.shape[0])

    def depth(self) -> int:
        d = np.zeros(self.n_nodes, dtype=np.int32)
        maxd = 0
        for i in range(self.n_nodes):   # parents precede children by construction
            if self.feature[i] >= 0:
                for c in (self.left[i], self.right[i]):
                    d[c] = d[i] + 1
                    maxd = max(maxd, int(d[c]))
        return maxd

    def predict(self, X: np.ndarray) -> np.ndarray:
        cur = np.zeros(X.shape[0], dtype=np.int64)
        while True:
            feat = self.feature[cur]
            active = feat >= 0
            if not active.any():
                break
            f = np.where(active, feat, 0)
            go_left = X[np.arange(X.shape[0]), f] <= self.threshold[cur]
            nxt = np.where(go_left, self.left[cur], self.right[cur])
            cur = np.where(active, nxt, cur)
        return self.value[cur].astype(np.float64)

    def importances(self, n_features: int) -> np.ndarray:
        """Impurity-decrease feature importances, normalized to sum 1."""
        imp = np.zeros(n_features, dtype=np.float64)
        total = float(self.n_samples[0])
        for i in range(self.n_nodes):
            f = int(self.feature[i])
            if f < 0:
                continue
            l, r = int(self.left[i]), int(self.right[i])
            dec = (self.n_samples[i] * self.impurity[i]
                   - self.n_samples[l] * self.impurity[l]
                   - self.n_samples[r] * self.impurity[r]) / total
            imp[f] += max(dec, 0.0)
        s = imp.sum()
        return imp / s if s > 0 else imp


def _fit_tree(
    X: np.ndarray,
    y: np.ndarray,
    criterion: Criterion,
    k_features: int,
    max_depth: int | None,
    min_samples_split: int,
    min_samples_leaf: int,
    rng: np.random.Generator,
) -> Tree:
    """Single extra-tree fit. The MSE path carries sufficient statistics
    (sum, sum-of-squares) down the stack so per-node impurity is O(1); the
    hot loop avoids wrapper-heavy numpy methods (.var/.mean/errstate) —
    this runs once per node per tree and dominates nested-CV cost."""
    n, F = X.shape
    y2 = y * y
    feature: list[int] = []
    threshold: list[float] = []
    left: list[int] = []
    right: list[int] = []
    value: list[float] = []
    n_samples: list[int] = []
    impurity: list[float] = []
    mse = criterion == "mse"
    use_all = k_features >= F

    def new_node() -> int:
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        n_samples.append(0)
        impurity.append(0.0)
        return len(feature) - 1

    root = new_node()
    all_idx = np.arange(n, dtype=np.intp)
    s0 = (float(y.sum()), float(y2.sum())) if mse else (0.0, 0.0)
    # stack entries: (node, idx, depth, sum_y, sumsq_y); sums unused for MAE
    stack: list[tuple] = [(root, all_idx, 0, s0[0], s0[1])]
    max_depth = max_depth if max_depth is not None else 2**31 - 1
    uniform = rng.uniform
    permutation = rng.permutation

    while stack:
        node, idx, depth, ysum, ysq = stack.pop()
        n_node = idx.shape[0]
        y_node = y[idx]
        if mse:
            mean = ysum / n_node
            imp = max(ysq / n_node - mean * mean, 0.0)
            val = mean
        else:
            val = float(np.median(y_node))
            imp = float(np.abs(y_node - val).sum()) / n_node
        value[node] = val
        n_samples[node] = n_node
        impurity[node] = imp

        if depth >= max_depth or n_node < min_samples_split or imp <= 1e-12:
            continue

        X_node = X[idx]
        fmin = X_node.min(axis=0)
        fmax = X_node.max(axis=0)
        valid_mask = fmax > fmin
        n_valid = int(np.count_nonzero(valid_mask))
        if n_valid == 0:
            continue
        full = use_all and n_valid == F
        if full:
            feats = None                      # every feature, in order
            lo, hi = fmin, fmax
            sub = X_node
            k = F
        else:
            valid = np.flatnonzero(valid_mask)
            k = min(k_features, n_valid)
            feats = permutation(valid)[:k] if k < n_valid else valid
            lo, hi = fmin[feats], fmax[feats]
            sub = X_node[:, feats]
        thr = uniform(lo, hi).astype(np.float32)
        masks = sub <= thr[None, :]                        # (n_node, k)
        masks_f = masks.astype(np.float32)
        n_left = masks_f.sum(axis=0)
        n_right = n_node - n_left
        ok = (n_left >= min_samples_leaf) & (n_right >= min_samples_leaf)
        if not ok.any():
            continue

        if mse:
            sum_l = y_node @ masks_f                        # (k,)
            sq_l = y2[idx] @ masks_f
            n_l = np.maximum(n_left, 1.0)
            n_r = np.maximum(n_right, 1.0)
            var_l = np.maximum(sq_l / n_l - (sum_l / n_l) ** 2, 0.0)
            var_r = np.maximum((ysq - sq_l) / n_r - ((ysum - sum_l) / n_r) ** 2, 0.0)
            score = np.where(ok, n_l * var_l + n_r * var_r, np.inf)
        else:
            # vectorized SAD-around-median for all k candidates at once:
            # sort y once; per-candidate medians come from masked prefix
            # counts. Any point between the two middle masked values
            # minimizes sum|y-m| and yields the SAME sum, so using the lower
            # median is exact (leaf *values* still use the true median).
            order = np.argsort(y_node, kind="stable")
            w = y_node[order]
            mw = masks_f[order]                            # (n_node, k)
            wcol = w[:, None]
            cw = np.cumsum(mw * wcol, axis=0)
            cn = np.cumsum(mw, axis=0)
            cw_all = np.cumsum(w)
            rows = np.arange(k)
            nl = cn[-1]
            tw = cw[-1]
            ml = np.ceil(nl / 2.0)
            med_pos = (cn >= ml[None, :]).argmax(axis=0)
            med = w[med_pos]
            bw = cw[med_pos, rows]
            bn = cn[med_pos, rows]
            sad_l = med * bn - bw + (tw - bw) - med * (nl - bn)
            cn_r = np.arange(1, n_node + 1, dtype=np.float32)[:, None] - cn
            cw_r = cw_all[:, None] - cw
            nr = n_node - nl
            tw_r = cw_all[-1] - tw
            mr = np.ceil(nr / 2.0)
            med_pos_r = (cn_r >= mr[None, :]).argmax(axis=0)
            med_r = w[med_pos_r]
            bwr = cw_r[med_pos_r, rows]
            bnr = cn_r[med_pos_r, rows]
            sad_r = med_r * bnr - bwr + (tw_r - bwr) - med_r * (nr - bnr)
            score = np.where(ok, sad_l + sad_r, np.inf)

        j = int(np.argmin(score))
        if not np.isfinite(score[j]):
            continue
        m = masks[:, j]
        lnode, rnode = new_node(), new_node()
        feature[node] = int(j if full else feats[j])
        threshold[node] = float(thr[j])
        left[node] = lnode
        right[node] = rnode
        if mse:
            sl, ql = float(sum_l[j]), float(sq_l[j])
            stack.append((lnode, idx[m], depth + 1, sl, ql))
            stack.append((rnode, idx[~m], depth + 1, ysum - sl, ysq - ql))
        else:
            stack.append((lnode, idx[m], depth + 1, 0.0, 0.0))
            stack.append((rnode, idx[~m], depth + 1, 0.0, 0.0))

    return Tree(
        feature=np.asarray(feature, dtype=np.int32),
        threshold=np.asarray(threshold, dtype=np.float32),
        left=np.asarray(left, dtype=np.int32),
        right=np.asarray(right, dtype=np.int32),
        value=np.asarray(value, dtype=np.float32),
        n_samples=np.asarray(n_samples, dtype=np.int32),
        impurity=np.asarray(impurity, dtype=np.float32),
    )


@dataclass
class FlatForest:
    """All trees concatenated into single arrays (for numpy/torch inference)."""
    feature: np.ndarray    # (total_nodes,) int32
    threshold: np.ndarray  # (total_nodes,) float32
    left: np.ndarray       # (total_nodes,) int32 — GLOBAL node indices
    right: np.ndarray
    value: np.ndarray
    roots: np.ndarray      # (n_trees,) int32
    max_depth: int

    @property
    def n_trees(self) -> int:
        return int(self.roots.shape[0])


class ExtraTreesRegressor:
    """Drop-in subset of sklearn's API used by the paper's methodology."""

    def __init__(
        self,
        n_estimators: int = 256,
        criterion: Criterion = "mse",
        max_features: MaxFeatures | int = "max",
        max_depth: int | None = None,
        min_samples_split: int = 2,
        min_samples_leaf: int = 1,
        seed: int = 0,
    ):
        self.n_estimators = n_estimators
        self.criterion = criterion
        self.max_features = max_features
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.trees_: list[Tree] = []
        self.n_features_: int = 0

    def get_params(self) -> dict:
        return dict(n_estimators=self.n_estimators, criterion=self.criterion,
                    max_features=self.max_features, max_depth=self.max_depth,
                    min_samples_split=self.min_samples_split,
                    min_samples_leaf=self.min_samples_leaf, seed=self.seed)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "ExtraTreesRegressor":
        X = np.ascontiguousarray(X, dtype=np.float32)
        y = np.ascontiguousarray(y, dtype=np.float64)
        if X.ndim != 2 or y.ndim != 1 or X.shape[0] != y.shape[0]:
            raise ValueError(f"bad shapes X{X.shape} y{y.shape}")
        self.n_features_ = X.shape[1]
        k = _resolve_k(self.max_features, self.n_features_)
        seeds = np.random.SeedSequence(self.seed).spawn(self.n_estimators)
        self.trees_ = [
            _fit_tree(X, y, self.criterion, k, self.max_depth,
                      self.min_samples_split, self.min_samples_leaf,
                      np.random.default_rng(s))
            for s in seeds
        ]
        return self

    def predict(self, X: np.ndarray, n_trees: int | None = None) -> np.ndarray:
        """Mean over (the first ``n_trees``) trees.

        ``n_trees`` enables the n_estimators hyperparameter grid to be scored
        from ONE fit with max(n_estimators) trees: trees are i.i.d., so the
        first ``n`` trees of a 1024-tree forest are statistically identical
        to an ``n``-tree forest (fit-once, score-prefixes).
        """
        X = np.ascontiguousarray(X, dtype=np.float32)
        trees = self.trees_ if n_trees is None else self.trees_[:n_trees]
        if not trees:
            raise RuntimeError("not fitted")
        acc = np.zeros(X.shape[0], dtype=np.float64)
        for t in trees:
            acc += t.predict(X)
        return acc / len(trees)

    @property
    def feature_importances_(self) -> np.ndarray:
        per_tree = np.stack([t.importances(self.n_features_) for t in self.trees_])
        return per_tree.mean(axis=0)

    def avg_depth(self) -> float:
        return float(np.mean([t.depth() for t in self.trees_]))

    def to_flat(self, n_trees: int | None = None) -> FlatForest:
        trees = self.trees_ if n_trees is None else self.trees_[:n_trees]
        roots, feats, thrs, lefts, rights, vals = [], [], [], [], [], []
        offset = 0
        maxd = 0
        for t in trees:
            roots.append(offset)
            feats.append(t.feature)
            thrs.append(t.threshold)
            lefts.append(np.where(t.left >= 0, t.left + offset, t.left))
            rights.append(np.where(t.right >= 0, t.right + offset, t.right))
            vals.append(t.value)
            offset += t.n_nodes
            maxd = max(maxd, t.depth())
        return FlatForest(
            feature=np.concatenate(feats),
            threshold=np.concatenate(thrs),
            left=np.concatenate(lefts).astype(np.int32),
            right=np.concatenate(rights).astype(np.int32),
            value=np.concatenate(vals),
            roots=np.asarray(roots, dtype=np.int32),
            max_depth=maxd,
        )


def predict_flat(forest: FlatForest, X: np.ndarray) -> np.ndarray:
    """Vectorized numpy inference over (samples × trees) — the fast CPU path."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    B = X.shape[0]
    cur = np.broadcast_to(forest.roots[None, :], (B, forest.n_trees)).copy().astype(np.int64)
    rows = np.arange(B)[:, None]
    for _ in range(forest.max_depth):
        feat = forest.feature[cur]
        active = feat >= 0
        f = np.where(active, feat, 0)
        go_left = X[rows, f] <= forest.threshold[cur]
        nxt = np.where(go_left, forest.left[cur], forest.right[cur])
        cur = np.where(active, nxt, cur)
    return forest.value[cur].mean(axis=1).astype(np.float64)


class LinearBaseline:
    """Ordinary least squares on (optionally log1p-scaled) features — the
    LR/MLR baseline family from the paper's related-work table."""

    def __init__(self, log_features: bool = True):
        self.log_features = log_features
        self.coef_: np.ndarray | None = None

    def _design(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=np.float64)
        if self.log_features:
            X = np.log1p(np.maximum(X, 0.0))
        return np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearBaseline":
        A = self._design(X)
        self.coef_, *_ = np.linalg.lstsq(A, np.asarray(y, dtype=np.float64), rcond=None)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        assert self.coef_ is not None, "not fitted"
        return self._design(X) @ self.coef_
