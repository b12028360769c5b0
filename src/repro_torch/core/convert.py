"""Carry weights across from the reference.

For the predictor the weights are the fitted forest. The reference keeps
each tree as seven numpy arrays (``repro.core.forest.Tree``: feature,
threshold, left, right, value, n_samples, impurity) and a dense forest as
three tables; these functions rebuild the port's objects from such arrays,
checking shapes and types, so a forest fitted by either package serves
through the other. ``lm_params_from_arrays`` does the same for the LM
framework's parameter trees, ``train_state_from_arrays`` for a training
state (params and AdamW moments), and ``tree_to_arrays`` takes a port tree
back to numpy.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

from .forest import ExtraTreesRegressor, Tree
from .forest_torch import DenseForest

#: Tree fields and the dtype each is stored in.
TREE_FIELDS = {"feature": np.int32, "threshold": np.float32,
               "left": np.int32, "right": np.int32, "value": np.float32,
               "n_samples": np.int32, "impurity": np.float32}


def _tree(arrays: Mapping, n_features: int) -> Tree:
    missing = set(TREE_FIELDS) - set(arrays)
    if missing:
        raise ValueError(f"tree arrays lack {sorted(missing)}")
    fields = {k: np.array(arrays[k], dtype=dt) for k, dt in TREE_FIELDS.items()}
    n = fields["feature"].shape
    if len(n) != 1 or n[0] < 1 or any(a.shape != n for a in fields.values()):
        raise ValueError(f"tree arrays must be 1-D of one length, got "
                         f"{ {k: a.shape for k, a in fields.items()} }")
    f = fields["feature"]
    if f.min() < -1 or f.max() >= n_features:
        raise ValueError(f"feature index outside [-1, {n_features})")
    for side in ("left", "right"):
        child = fields[side]
        if child.min() < -1 or child.max() >= n[0]:
            raise ValueError(f"{side} child index outside [-1, {n[0]})")
    return Tree(**fields)


def estimator_from_arrays(trees: Sequence[Mapping], n_features: int,
                          params: Mapping) -> ExtraTreesRegressor:
    """A fitted port ``ExtraTreesRegressor`` from per-tree arrays.

    ``trees``: one mapping per tree with the ``TREE_FIELDS`` keys (e.g.
    ``vars(t)`` of each reference tree); ``params``: the estimator's
    ``get_params()``."""
    est = ExtraTreesRegressor(**params)
    est.trees_ = [_tree(t, n_features) for t in trees]
    est.n_features_ = int(n_features)
    return est


def lm_params_from_arrays(specs: Mapping, arrays: Mapping,
                          device="cuda") -> dict:
    """The port's LM parameters from the reference's parameter tree.

    ``specs`` is a model's ``ParamSpec`` tree (``ModelBundle.specs``);
    ``arrays`` is the reference's parameter pytree with the same names and
    the same stacked leading axes, its leaves as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``). Returns a nested dict of tensors
    on ``device`` in each spec's dtype. Every leaf's shape is checked against
    its spec; a missing or extra leaf raises."""
    def walk(spec, arr, path):
        where = "/".join(path) or "<root>"
        if isinstance(spec, Mapping):
            if not isinstance(arr, Mapping):
                raise ValueError(f"{where}: expected a mapping, got "
                                 f"{type(arr).__name__}")
            missing, extra = set(spec) - set(arr), set(arr) - set(spec)
            if missing or extra:
                raise ValueError(f"{where}: missing {sorted(missing)}, "
                                 f"extra {sorted(extra)}")
            return {k: walk(spec[k], arr[k], path + (k,)) for k in spec}
        a = np.asarray(arr)
        if tuple(a.shape) != tuple(spec.shape):
            raise ValueError(f"{where}: shape {tuple(a.shape)}, the spec "
                             f"says {tuple(spec.shape)}")
        return torch.as_tensor(np.array(a, dtype=spec.dtype), device=device)
    return walk(specs, arrays, ())


def train_state_from_arrays(specs: Mapping, arrays: Mapping, device="cuda",
                            moment_dtype: str = "float32") -> dict:
    """The port's train state from the reference's (``repro.train.step``):
    {"params": tree, "opt": {"m": tree, "v": tree, "step": int}} with numpy
    (or array-like) leaves. Params and v come out in their specs' dtype, m
    in ``moment_dtype``, step as an int32 scalar tensor; every tree is
    checked as ``lm_params_from_arrays`` checks it."""
    if set(arrays) != {"params", "opt"} or set(arrays["opt"]) != {
            "m", "v", "step"}:
        raise ValueError("expected {'params', 'opt': {'m', 'v', 'step'}}")
    opt = arrays["opt"]
    mdt = getattr(torch, moment_dtype)
    m = lm_params_from_arrays(specs, opt["m"], device)
    return {"params": lm_params_from_arrays(specs, arrays["params"], device),
            "opt": {"m": _cast(m, mdt),
                    "v": lm_params_from_arrays(specs, opt["v"], device),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=device)}}


def _cast(tree, dtype):
    if isinstance(tree, Mapping):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def tree_to_arrays(tree):
    """A nested dict of tensors as numpy arrays on the host (float32 for
    bfloat16, which numpy lacks), e.g. to compare a port state with the
    reference's."""
    if isinstance(tree, Mapping):
        return {k: tree_to_arrays(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def dense_from_arrays(feature, threshold, value, depth: int,
                      n_features: int) -> DenseForest:
    """A port ``DenseForest`` from the reference's three (T, N) tables."""
    feature = np.array(feature, dtype=np.int32)
    threshold = np.array(threshold, dtype=np.float32)
    value = np.array(value, dtype=np.float32)
    n_nodes = 2 ** (depth + 1) - 1
    if (feature.ndim != 2 or feature.shape[1] != n_nodes
            or threshold.shape != feature.shape
            or value.shape != feature.shape):
        raise ValueError(f"depth {depth} needs (T, {n_nodes}) tables, got "
                         f"{feature.shape}, {threshold.shape}, {value.shape}")
    if feature.min() < -1 or feature.max() >= n_features:
        raise ValueError(f"feature index outside [-1, {n_features})")
    return DenseForest(feature=feature, threshold=threshold, value=value,
                       depth=int(depth), n_features=int(n_features))
