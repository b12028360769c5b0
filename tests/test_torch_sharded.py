"""The port's sharded forest engine (``repro_torch.serve.sharded``) on the
CPU against the reference's (``repro.serve.sharded``): the same forest,
fitted by the reference and carried across, partitioned the same way, with
both engines held to ``est.predict`` and to the surviving-tree oracle
within 1e-5 (the reference tests' own bar, tests/test_sharded.py) and to
each other. The loop placement runs in process; the mesh placement in a
2-rank gloo group."""
import threading
import time

import jax  # noqa: F401  (the reference's sharded engine imports it)
import numpy as np
import pytest
import torch.multiprocessing as mp

from repro.core.forest import ExtraTreesRegressor as RefTrees
from repro.serve import EngineConfig as RefConfig
from repro.serve import ShardedForestEngine as RefSharded
from repro.serve import ShardedForestPredictor as RefPredictor
from repro_torch.core import convert
from repro_torch.core.scheduler import DevicePredictor, predict_matrix
from repro_torch.serve import (EngineConfig, PredictorBackend, ServingEngine,
                               ShardedForestEngine, ShardedForestPredictor)

CPU = dict(device="cpu")


def _rel(pred, oracle):
    return np.max(np.abs(pred - oracle) / np.maximum(np.abs(oracle), 1e-9))


def _carry(ref):
    return convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())


def _survivors(est, idx, X):
    return np.mean([est.trees_[i].predict(X) for i in idx], axis=0)


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(3)
    X = rng.lognormal(1.0, 1.5, size=(140, 10)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3.0) + 0.05 * rng.normal(size=140)
    # depth < dense_depth so the dense embedding (hence sharding) is exact
    ref = RefTrees(n_estimators=10, max_depth=6, seed=0).fit(X, y)
    return _carry(ref), ref, X


# ---------------------------------------------------------------- correctness

@pytest.mark.parametrize("n_shards,sizes", [
    (1, [10]), (2, [5, 5]), (3, [4, 3, 3]), (4, [3, 3, 2, 2]),
    (7, [2, 2, 2, 1, 1, 1, 1]),
    (64, [1] * 10),                   # clamped to the tree count
])
def test_sharded_matches_reference_and_oracle(fitted, n_shards, sizes):
    est, ref, X = fitted
    oracle = ref.predict(X)
    with ShardedForestEngine(est, n_shards=n_shards, cache_size=0,
                             **CPU) as eng, \
            RefSharded(ref, n_shards=n_shards, cache_size=0) as ref_eng:
        assert eng.placement == ref_eng.placement == "loop"
        assert eng.shard_sizes == ref_eng.shard_sizes == sizes
        assert eng.backend == f"sharded-dense-loopx{len(sizes)}"
        assert eng.backend == ref_eng.backend
        got, want = eng.predict(X), ref_eng.predict(X)
    assert got.dtype == np.float64 and got.shape == (len(X),)
    assert _rel(got, oracle) <= 1e-5
    assert _rel(want, oracle) <= 1e-5
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("make", [
    lambda e, m: m(e, n_shards=0),
    lambda e, m: m(e, n_shards=-3),
], ids=["zero", "negative"])
def test_predictor_rejects_bad_shards(fitted, make):
    est, ref, _ = fitted
    with pytest.raises(ValueError):
        make(est, lambda e, **kw: ShardedForestPredictor(e, **kw, **CPU))
    with pytest.raises(ValueError):
        make(ref, RefPredictor)


@pytest.mark.parametrize("backend", ["flat-numpy", "tree-walk", "hopper"])
def test_rejects_explicit_backend(fitted, backend):
    est, ref, _ = fitted
    with pytest.raises(ValueError, match="partitioned path"):
        ShardedForestEngine(est, EngineConfig(backend=backend, **CPU))
    with pytest.raises(ValueError, match="partitioned path"):
        ShardedForestEngine(est, backend=backend, **CPU)
    if backend != "hopper":           # the reference has no such backend
        with pytest.raises(ValueError):
            RefSharded(ref, RefConfig(backend=backend))


# ------------------------------------------------------------- engine surface

def test_sharded_is_a_serving_engine(fitted):
    est, ref, X = fitted
    with ShardedForestEngine(est, n_shards=2, **CPU) as eng:
        assert isinstance(eng, ServingEngine)
        assert isinstance(ShardedForestPredictor(est, n_shards=2, **CPU),
                          PredictorBackend)
        # async micro-batching + cache inherited from ForestEngine
        futs = [eng.predict_async(X[i]) for i in range(8)]
        got = np.array([f.result(timeout=10) for f in futs])
        np.testing.assert_allclose(got, ref.predict(X[:8]), rtol=1e-5)
        eng.predict(X[:8])
        assert eng.stats.cache_hits >= 8
        # and the scheduler's frontend prices through it
        T, _ = predict_matrix(X[:20], [DevicePredictor("dev", eng)])
        np.testing.assert_allclose(T[:, 0], np.exp(ref.predict(X[:20])),
                                   rtol=1e-5)


def test_sharded_hot_swap(fitted):
    est, ref, X = fitted
    rng = np.random.default_rng(0)
    y2 = np.log(X[:, 1] + 1.0) + rng.normal(size=X.shape[0]) * 0.01
    ref2 = RefTrees(n_estimators=7, max_depth=5, seed=1).fit(X, y2)
    with ShardedForestEngine(est, n_shards=2, **CPU) as eng, \
            RefSharded(ref, n_shards=2) as ref_eng:
        p1 = eng.predict(X[:10])
        gen = eng.swap_estimator(_carry(ref2))
        assert ref_eng.swap_estimator(ref2) == gen == 1
        assert eng.stats.swaps == 1
        # swap re-partitions the NEW forest (7 trees over 2 shards)
        assert eng.shard_sizes == ref_eng.shard_sizes == [4, 3]
        p2 = eng.predict(X[:10])
        assert _rel(p2, ref2.predict(X[:10])) <= 1e-5
        assert _rel(p2, ref_eng.predict(X[:10])) <= 1e-5
        assert not np.allclose(p1, p2)


# -------------------------------------------------------------- shard failure

@pytest.mark.parametrize("n_shards,drops,sizes", [
    (3, [1], [4, 3]),                 # 10 trees -> [4, 3, 3], drop one
    (4, [0, 2], [3, 2]),              # [3, 3, 2, 2], drop two: compounds
    (10, [9, 0, 4], [1] * 7),         # one-tree shards
])
def test_drop_renormalizes_over_survivors(fitted, n_shards, drops, sizes):
    """A forced shard failure keeps predictions flowing; the renormalized
    mean matches the tree-walk oracle over the surviving trees, and the
    reference's degraded engine, to <=1e-5 rel."""
    est, ref, X = fitted
    with ShardedForestEngine(est, n_shards=n_shards, cache_size=32,
                             **CPU) as eng, \
            RefSharded(ref, n_shards=n_shards, cache_size=32) as ref_eng:
        full = eng.predict(X)
        lost = 0
        for k, idx in enumerate(drops, start=1):
            got = eng.drop_shard(idx)
            assert ref_eng.drop_shard(idx) == got
            lost += got
            assert eng.dead_shards == ref_eng.dead_shards
            assert eng.backend.endswith(f"-deg{k}")
            assert eng.stats.generation == k      # stale cache entries gone
        assert eng.shard_sizes == ref_eng.shard_sizes == sizes
        assert eng.dead_shards == frozenset(drops)
        assert eng.live_trees == len(est.trees_) - lost
        survivors = eng.live_tree_indices()
        assert survivors == ref_eng.live_tree_indices()
        assert len(survivors) == eng.live_trees
        pred = eng.predict(X)                     # still flowing
        assert _rel(pred, _survivors(ref, survivors, X)) <= 1e-5
        assert _rel(pred, ref_eng.predict(X)) <= 1e-5
        assert not np.allclose(pred, full)        # degradation is real...
        assert eng.stats.shard_drops == len(drops)  # ...and counted
        assert eng.stats.trees_lost == lost == ref_eng.stats.trees_lost


def test_drop_shard_validation(fitted):
    est, ref, _ = fitted
    with ShardedForestEngine(est, n_shards=2, cache_size=0, **CPU) as eng, \
            RefSharded(ref, n_shards=2, cache_size=0) as ref_eng:
        for e in (eng, ref_eng):
            with pytest.raises(ValueError):
                e.drop_shard(5)                   # out of range
            e.drop_shard(0)
            with pytest.raises(ValueError):
                e.drop_shard(0)                   # already dead
            with pytest.raises(RuntimeError):
                e.drop_shard(1)                   # last survivor


def test_swap_restores_full_forest_after_drop(fitted):
    est, ref, X = fitted
    with ShardedForestEngine(est, n_shards=3, **CPU) as eng, \
            RefSharded(ref, n_shards=3) as ref_eng:
        for e, forest in ((eng, est), (ref_eng, ref)):
            e.drop_shard(2)
            assert e.stats.trees_lost == 3
            e.swap_estimator(forest)              # the refresher's path
            assert e.dead_shards == frozenset()
            assert e.live_trees == len(forest.trees_)
            assert e.stats.trees_lost == 0        # degradation cleared
            assert e.stats.shard_drops == 1       # history preserved
        assert vars(eng.stats) == vars(ref_eng.stats)
        assert _rel(eng.predict(X), ref.predict(X)) <= 1e-5


def test_drop_shard_during_async_traffic(fitted):
    """Requests in flight across the drop all resolve; answers come
    uniformly from either the full or the degraded forest, never a mix."""
    est, ref, X = fitted
    full_oracle = ref.predict(X)
    with ShardedForestEngine(est, n_shards=2, max_batch=4, max_delay_ms=0.5,
                             **CPU) as eng:
        futs = [eng.predict_async(X[i]) for i in range(24)]
        eng.drop_shard(0)
        futs += [eng.predict_async(X[i]) for i in range(24, 48)]
        got = np.array([f.result(timeout=30) for f in futs])
        deg_oracle = _survivors(ref, eng.live_tree_indices(), X)
    for i, v in enumerate(got):
        ok_full = abs(v - full_oracle[i]) <= 1e-5 * abs(full_oracle[i])
        ok_deg = abs(v - deg_oracle[i]) <= 1e-5 * abs(deg_oracle[i])
        assert ok_full or ok_deg


def test_drop_races_swap(fitted):
    """drop_shard rebuilds off the lock and commits only over the predictor
    it started from: a swap landing in between makes it rederive, so the
    engine never serves a degraded copy of the superseded forest."""
    est, ref, X = fitted
    with ShardedForestEngine(est, n_shards=4, cache_size=0, **CPU) as eng:
        base = eng._installed
        real = type(base).without_shard
        swapped = threading.Event()

        def slow_without(self, idx):
            out = real(self, idx)
            if self is base and not swapped.is_set():
                swapped.set()
                eng.swap_estimator(est)           # a swap lands mid-drop
            return out
        type(base).without_shard = slow_without
        try:
            eng.drop_shard(1)
        finally:
            type(base).without_shard = real
        assert eng._installed.dead == frozenset({1})
        assert eng.stats.swaps == 1 and eng.stats.shard_drops == 1
        assert eng.stats.trees_lost == 3          # after the swap's reset
        assert _rel(eng.predict(X), _survivors(
            ref, eng.live_tree_indices(), X)) <= 1e-5


# ------------------------------------------------------------- mesh placement

def _mesh_rank(rank, world, store, est, X, out_dir):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with ShardedForestEngine(est, n_shards=2, cache_size=0,
                                 device="cpu") as eng:
            assert eng.placement == "mesh", eng.placement
            assert eng.backend == "sharded-dense-meshx2", eng.backend
            pred = eng.predict(X)
            # a shard dying out of a MESH placement degrades to the loop
            # placement, in every rank
            eng.drop_shard(0)
            assert eng.placement == "loop", eng.placement
            deg = eng.predict(X)
            live = np.asarray(eng.live_tree_indices())
        np.savez(f"{out_dir}/rank{rank}.npz", pred=pred, deg=deg, live=live)
    finally:
        dist.destroy_process_group()


def test_mesh_placement_two_gloo_ranks(fitted, tmp_path):
    """Two ranks over gloo: each computes its shard's partial, one
    all_reduce combines them; both ranks' answers, and a drop's, match the
    oracle."""
    est, ref, X = fitted
    ctx = mp.start_processes(
        _mesh_rank, args=(2, tmp_path / "store", est, X[:32], tmp_path),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + 120
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail("the mesh ranks did not finish in 120 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    oracle = ref.predict(X[:32])
    for rank in range(2):
        got = np.load(tmp_path / f"rank{rank}.npz")
        assert _rel(got["pred"], oracle) <= 1e-5
        assert list(got["live"]) == list(range(5, 10))
        assert _rel(got["deg"], _survivors(ref, got["live"], X[:32])) <= 1e-5


def test_serve_exports_the_reference_s_names():
    import repro.serve
    import repro_torch.serve
    assert set(repro.serve.__all__) <= set(repro_torch.serve.__all__)
    for name in repro.serve.__all__:
        assert hasattr(repro_torch.serve, name), name
