"""Tree-axis device partitioning: the ``ShardedForestEngine`` (counterpart
of ``repro.serve.sharded``).

The forest's prediction is a MEAN over trees, so the stacked dense tree
arrays (T, N) partition cleanly along the tree axis: each shard owns a
contiguous block of trees, computes its partial leaf-value SUM, and the
engine combines ``sum(partial sums) / n_real_trees``.

Two placements, picked automatically:

  * ``mesh`` — with ``torch.distributed`` initialised over a world of at
    least ``n_shards`` ranks, rank r computes shard r's partial and one
    ``all_reduce(SUM)`` of the float64 partials combines them: the
    counterpart of the reference's ``shard_map`` + ``psum``. It is SPMD, as
    every collective is: each rank serves the same requests in the same
    order (ranks past ``n_shards`` add zeros).
  * ``loop`` — otherwise (one process, or forced shard counts for testing)
    each shard's block is placed round-robin over the visible cards and
    launched on its own; the launches are asynchronous, so the cards'
    work overlaps, and the partials are gathered after every shard was
    dispatched, with one copy back (and one wait) per device.

Per-shard compute reuses the inference stack unchanged: on a CUDA device
the forest kernel (``kernels/forest``, its tables packed once per shard by
``pack_tables``), which returns the shard's MEAN and is rescaled by the
shard's size in float64; on the CPU the plain
``core/forest_torch.dense_leaf_sum``. The kernel pads a shard's trees to
its tree group with inert trees and divides by the real count, so any
shard size serves exactly.

``ShardedForestEngine`` subclasses ``ForestEngine``, so micro-batching, the
feature cache, EngineStats, and hot-swap (``swap_estimator`` rebuilds the
partitioned tables off-lock and swaps atomically) all behave identically to
the single-device engine — it is a drop-in ``ServingEngine``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.forest import ExtraTreesRegressor
from ..core.forest_torch import (DenseForest, dense_leaf_sum, resolve_device,
                                 to_dense)
from .backend import PredictorBackend
from .engine import EngineConfig, ForestEngine

__all__ = ["ShardedForestEngine", "ShardedForestPredictor"]


def _shard_bounds(n_trees: int, n_shards: int) -> list[tuple[int, int]]:
    """Balanced contiguous blocks (sizes differ by at most one, none empty)."""
    splits = np.array_split(np.arange(n_trees), n_shards)
    return [(int(s[0]), int(s[-1]) + 1) for s in splits]


def _world() -> int:
    """Ranks of the initialised ``torch.distributed`` group (0 if none)."""
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 0)


def _devices(device: torch.device) -> list[torch.device]:
    """The devices the loop placement deals shards onto: every visible card
    for a CUDA device, the host for the CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


class ShardedForestPredictor:
    """PredictorBackend that partitions one dense forest across shards.

    Shard failure: ``without_shard(i)`` returns a NEW predictor over the
    surviving shards only — the mean renormalizes over the surviving trees
    (``sum(surviving partials) / n_live``), so predictions keep flowing with
    a bounded, countable accuracy degradation instead of an outage. The
    degraded predictor always uses the loop placement (a mesh with a dead
    member cannot dispatch); a later ``swap_estimator`` rebuilds the full
    partitioning.
    """

    def __init__(self, est: ExtraTreesRegressor, *, n_shards: int,
                 dense_depth: int = 10, device: str | torch.device = "cuda",
                 force_loop: bool = False):
        if not est.trees_:
            raise ValueError("estimator is not fitted")
        n_trees = len(est.trees_)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        n_shards = min(n_shards, n_trees)      # every shard owns >= 1 tree
        self.device = resolve_device(device)
        eff_depth = min(dense_depth, max(t.depth() for t in est.trees_))
        dense = to_dense(est, depth=max(eff_depth, 1))

        self.n_trees = n_trees
        self.n_shards = n_shards
        self.depth = dense.depth
        self.devices = _devices(self.device)
        self.bounds = _shard_bounds(n_trees, n_shards)
        self.shard_sizes = [b - a for a, b in self.bounds]
        self.dead: frozenset[int] = frozenset()
        self.n_live = n_trees
        self._dense = dense            # kept for shard-drop rebuilds

        mesh_capable = (n_shards > 1 and _world() >= n_shards
                        and not force_loop)
        self.placement = "mesh" if mesh_capable else "loop"
        if self.placement == "mesh":
            self._build_mesh(dense)
        else:
            self._build_loop(dense)

    @property
    def name(self) -> str:
        kind = "hopper" if self.device.type == "cuda" else "dense"
        base = f"sharded-{kind}-{self.placement}x{self.n_shards}"
        return f"{base}-deg{len(self.dead)}" if self.dead else base

    # --------------------------------------------------------- shard failure

    def live_tree_indices(self) -> list[int]:
        """Tree indices still contributing to the mean (surviving shards)."""
        return [t for i, (a, b) in enumerate(self.bounds)
                if i not in self.dead for t in range(a, b)]

    def without_shard(self, idx: int) -> "ShardedForestPredictor":
        """A new predictor serving the surviving shards only.

        The dropped shard's trees leave the mean entirely (renormalized
        denominator), so the result equals the tree-walk oracle over the
        surviving trees. The original is left untouched — the engine swaps
        the degraded predictor in atomically under its own lock.
        """
        if not 0 <= idx < self.n_shards:
            raise ValueError(f"shard index {idx} out of range "
                             f"[0, {self.n_shards})")
        if idx in self.dead:
            raise ValueError(f"shard {idx} is already dropped")
        dead = self.dead | {idx}
        if len(dead) >= self.n_shards:
            raise RuntimeError("cannot drop the last surviving shard")
        p = object.__new__(ShardedForestPredictor)
        p.n_trees = self.n_trees
        p.n_shards = self.n_shards
        p.depth = self.depth
        p.device = self.device
        p.devices = self.devices
        p.bounds = self.bounds
        p.shard_sizes = [b - a for i, (a, b) in enumerate(self.bounds)
                         if i not in dead]
        p.dead = frozenset(dead)
        p.n_live = sum(b - a for i, (a, b) in enumerate(self.bounds)
                       if i not in dead)
        p._dense = self._dense
        p.placement = "loop"           # a holed mesh cannot dispatch
        p._build_loop(self._dense)
        return p

    # ------------------------------------------------------------ one shard

    def _place(self, dense: DenseForest, a: int, b: int,
               dev: torch.device):
        """Shard [a, b)'s tables on ``dev``: packed once for the kernel on
        a card, the raw dense rows for the plain sum on the host."""
        raw = (torch.as_tensor(dense.feature[a:b], device=dev),
               torch.as_tensor(dense.threshold[a:b], device=dev),
               torch.as_tensor(dense.value[a:b], device=dev))
        if dev.type != "cuda":
            return raw
        from ..kernels.forest.ops import pack_tables
        return pack_tables(*raw, depth=self.depth,
                           n_features=dense.n_features)

    def _partial(self, tables, x: torch.Tensor, size: int) -> torch.Tensor:
        """The shard's float64 leaf sum on x's device; not waited for."""
        if x.device.type == "cuda":
            from ..kernels.forest.ops import forest_predict_packed
            # the kernel returns the shard MEAN (it divides by its real
            # tree count); rescale to a partial sum
            return forest_predict_packed(x, tables).to(torch.float64) * size
        return dense_leaf_sum(*tables, x, self.depth).to(torch.float64)

    # -------------------------------------------------------------- mesh path

    def _build_mesh(self, dense: DenseForest) -> None:
        dist = torch.distributed
        rank = dist.get_rank()
        # NCCL reduces on the card, the other backends on the host
        self._reduce_on = (self.device if dist.get_backend() == "nccl"
                           else torch.device("cpu"))
        dev = self.devices[rank % len(self.devices)]
        self._mesh_shard = None        # ranks past n_shards add zeros
        if rank < self.n_shards:
            a, b = self.bounds[rank]
            self._mesh_shard = (self._place(dense, a, b, dev), dev, b - a)

    def _mesh_call(self, x: torch.Tensor) -> np.ndarray:
        if self._mesh_shard is None:
            part = torch.zeros(x.shape[0], dtype=torch.float64)
        else:
            tables, dev, size = self._mesh_shard
            part = self._partial(tables, x.to(dev), size)
        part = part.to(self._reduce_on)
        torch.distributed.all_reduce(part, op=torch.distributed.ReduceOp.SUM)
        return part.cpu().numpy() / self.n_trees

    # -------------------------------------------------------------- loop path

    def _build_loop(self, dense: DenseForest) -> None:
        # round-robin shard blocks over the visible cards; launches are
        # asynchronous, so per-device work overlaps even though Python
        # drives the loop
        self._shards = []
        for i, (a, b) in enumerate(self.bounds):
            if i in self.dead:
                continue
            dev = self.devices[i % len(self.devices)]
            self._shards.append((self._place(dense, a, b, dev), dev, b - a))

    def _loop_call(self, x: torch.Tensor) -> np.ndarray:
        # one input transfer per unique device, not per shard
        x_on = {}
        for _, dev, _ in self._shards:
            if dev not in x_on:
                x_on[dev] = x.to(dev)
        partials: dict[torch.device, list] = {dev: [] for dev in x_on}
        order = []
        for tables, dev, size in self._shards:
            order.append((dev, len(partials[dev])))
            partials[dev].append(self._partial(tables, x_on[dev], size))
        # collect AFTER all dispatches: one copy back per device
        host = {dev: torch.stack(parts).cpu().numpy()
                for dev, parts in partials.items()}
        total = np.zeros(x.shape[0], dtype=np.float64)
        for dev, j in order:           # shard order, as the reference adds
            total += host[dev][j]
        return total / self.n_live     # == n_trees unless shards dropped

    # ------------------------------------------------------------------ call

    def __call__(self, X) -> np.ndarray:
        x = torch.as_tensor(np.ascontiguousarray(X, dtype=np.float32))
        if self.placement == "mesh":
            return self._mesh_call(x)
        return self._loop_call(x)


def _serving(predictor: ShardedForestPredictor) -> PredictorBackend:
    """The engine's backend over ``predictor``; ``fn.predictor`` is what
    the engine's placement metadata reads."""
    def fn(X):
        return predictor(X)
    fn.predictor = predictor
    return fn


class ShardedForestEngine(ForestEngine):
    """ForestEngine whose backend partitions the forest across devices.

    ``n_shards`` defaults to the ranks of an initialised
    ``torch.distributed`` group, else to the visible cards (1 on the CPU);
    pass an explicit value to force a partitioning (e.g. ``n_shards=4`` on
    one card runs four logical shards — the correctness tests do exactly
    this). Everything else — micro-batching, caching, stats, hot-swap — is
    inherited.
    """

    def __init__(self, est: ExtraTreesRegressor,
                 config: EngineConfig | None = None, *,
                 n_shards: int | None = None, force_loop: bool = False,
                 calibration_X: np.ndarray | None = None, **overrides):
        cfg = config or EngineConfig()
        backend = overrides.get("backend", cfg.backend)
        if backend not in (None, "auto"):
            raise ValueError(
                f"ShardedForestEngine always serves its partitioned path; "
                f"an explicit backend={backend!r} cannot be honored — use a "
                f"plain ForestEngine for that")
        device = resolve_device(overrides.get("device", cfg.device))
        self.n_shards = n_shards if n_shards is not None else max(
            _world(), len(_devices(device)))
        self.force_loop = force_loop
        super().__init__(est, config, calibration_X=calibration_X,
                         **overrides)

    def _build(self, est: ExtraTreesRegressor) -> dict[str, PredictorBackend]:
        predictor = ShardedForestPredictor(
            est, n_shards=self.n_shards,
            dense_depth=self.config.dense_depth, device=self.device,
            force_loop=self.force_loop)
        return {predictor.name: _serving(predictor)}

    # placement metadata reflects the INSTALLED predictor (committed under
    # the engine lock), never one mid-build or from a failed swap
    @property
    def _installed(self) -> ShardedForestPredictor:
        return self._predict_fn.predictor

    @property
    def placement(self) -> str:
        return self._installed.placement

    @property
    def shard_sizes(self) -> list[int]:
        return self._installed.shard_sizes

    @property
    def dead_shards(self) -> frozenset[int]:
        return self._installed.dead

    @property
    def live_trees(self) -> int:
        return self._installed.n_live

    def live_tree_indices(self) -> list[int]:
        return self._installed.live_tree_indices()

    # --------------------------------------------------------- shard failure

    def drop_shard(self, idx: int) -> int:
        """Drop a dead shard; predictions keep flowing from the survivors.

        The forest mean renormalizes over the surviving trees (matching the
        tree-walk oracle restricted to ``live_tree_indices()``), the feature
        cache is invalidated (a degraded model answers differently), the
        generation bumps so in-flight batches of the full forest cannot
        write back stale cache entries, and ``stats.shard_drops`` /
        ``stats.trees_lost`` count the accuracy degradation. Returns the
        number of trees lost. A later ``swap_estimator`` (e.g. from the
        refresher) rebuilds the full partitioning and clears the
        degradation.

        Shard indices are POSITIONS IN THE ORIGINAL PARTITIONING (stable
        across drops): after ``drop_shard(0)`` on a 3-shard engine the
        survivors are shards 1 and 2.
        """
        while True:
            # rebuild over the survivors OFF the engine lock (serving never
            # stalls on the rebuild), then commit atomically — same
            # discipline as swap_estimator
            base = self._installed
            degraded = base.without_shard(idx)
            fn = _serving(degraded)
            with self._cond:
                if self._closed:
                    raise RuntimeError("engine is closed")
                if self._installed is not base:
                    continue           # a swap/drop raced us; rederive
                lost = base.n_live - degraded.n_live
                self._backends = {degraded.name: fn}
                self.backend = degraded.name
                self._predict_fn = fn
                self._cache.clear()
                self._generation += 1
                self.stats.generation = self._generation
                self.stats.shard_drops += 1
                self.stats.trees_lost += lost
                return lost
