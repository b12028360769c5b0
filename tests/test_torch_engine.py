"""The port's serving engine (``repro_torch.serve``) on the CPU against the
reference engine (``repro.serve``): each port backend matches its reference
counterpart within 1e-5 on the same forest, the micro-batch, cache and
hot-swap cases of tests/test_engine.py hold for the port, and
``MultiDeviceEngine`` prices and schedules as the reference does."""
import threading
import time

import jax  # noqa: F401  (the reference's engine paths import it)
import numpy as np
import pytest
import torch

from repro.core.forest import ExtraTreesRegressor as RefTrees
from repro.core.scheduler import schedule as r_schedule
from repro.serve import EngineConfig as RefConfig
from repro.serve import ForestEngine as RefEngine
from repro.serve import MultiDeviceEngine as RefMulti
from repro_torch.core import convert
from repro_torch.core.forest import ExtraTreesRegressor
from repro_torch.core.latency import calibrate_backends, measure_paths
from repro_torch.core.scheduler import (DevicePredictor, predict_matrix,
                                        schedule)
from repro_torch.serve import (BACKENDS, EngineConfig, ForestEngine,
                               MultiDeviceEngine, build_backends)
from repro_torch.serve import backend as backend_mod

#: port backend -> the reference backend it is held to
PAIRS = {"tree-walk": "tree-walk", "flat-numpy": "flat-numpy",
         "flat-torch": "flat-jax", "dense-torch": "dense-jax",
         "hopper": "pallas"}


def _data(seed=0, n=150, f=10):
    rng = np.random.default_rng(seed)
    X = rng.lognormal(1.0, 1.5, size=(n, f)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3.0)
    return X, y + 0.05 * rng.normal(size=n)


def _cfg(backend="flat-numpy", **kw):
    return EngineConfig(backend=backend, device="cpu", **kw)


def _carry(ref):
    return convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())


@pytest.fixture(scope="module")
def fitted():
    X, y = _data()
    # max_depth below the engine's dense_depth so dense/kernel are EXACT
    ref = RefTrees(n_estimators=8, max_depth=6, seed=0).fit(X, y)
    return _carry(ref), X, y, ref


# ------------------------------------------------------- golden equivalence

@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_reference_engine(fitted, backend):
    est, X, _, ref = fitted
    with ForestEngine(est, _cfg(backend, dense_depth=8)) as eng, \
            RefEngine(ref, RefConfig(backend=PAIRS[backend],
                                     dense_depth=8)) as ref_eng:
        assert eng.backend == backend
        got, want = eng.predict(X), ref_eng.predict(X)
    assert got.dtype == np.float64 and got.shape == (len(X),)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, ref.predict(X), rtol=1e-5, atol=1e-5)


def test_build_backends_rejects_unknown(fitted):
    est, _, _, _ = fitted
    with pytest.raises(ValueError):
        build_backends(est, only=("warp-drive",), device="cpu")


def test_backend_table_by_device(fitted, monkeypatch):
    est, X, _, _ = fitted
    assert set(build_backends(est, device="cpu")) == set(BACKENDS)
    # on a CUDA device the plain torch paths are refused: the kernel serves
    monkeypatch.setattr(backend_mod, "resolve_device",
                        lambda d: torch.device("cuda"))
    for plain in ("flat-torch", "dense-torch"):
        with pytest.raises(ValueError, match="plain path"):
            build_backends(est, only=(plain,), device="cuda")
    host = build_backends(est, only=("tree-walk", "flat-numpy"),
                          device="cuda")
    np.testing.assert_allclose(host["flat-numpy"](X), est.predict(X),
                               rtol=1e-5)


def test_auto_selection_runs_all_candidates(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, EngineConfig(device="cpu",
                                        calibration_iters=1)) as eng:
        assert eng.backend in BACKENDS
        assert set(eng.calibration) == set(BACKENDS)
        assert np.isfinite(eng.calibration[eng.backend])
        np.testing.assert_allclose(eng.predict(X), est.predict(X),
                                   rtol=1e-5, atol=1e-5)


def test_calibration_scores_only_host_paths_away(fitted):
    est, X, _, _ = fitted

    def boom(_X):
        raise RuntimeError("broken path")
    scores = calibrate_backends({"tree-walk": boom,
                                 "flat-numpy": lambda Z: est.predict(Z)},
                                X[:8], iters=1)
    assert scores["tree-walk"] == float("inf")
    assert np.isfinite(scores["flat-numpy"])
    with pytest.raises(RuntimeError, match="broken path"):
        calibrate_backends({"hopper": boom}, X[:8], iters=1)


def test_measure_paths_on_cpu(fitted):
    est, X, _, _ = fitted
    rows = measure_paths(est, X, batch=16, dense_depth=6, device="cpu")
    assert [r.name for r in rows] == list(BACKENDS)
    assert all(r.single_ms > 0 and r.batch_size == 16 for r in rows)


# --------------------------------------------------- batching invariance

@pytest.mark.parametrize("backend", ["flat-numpy", "hopper"])
def test_batched_equals_singles(fitted, backend):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg(backend, cache_size=0)) as eng:
        batched = eng.predict(X[:32])
        singles = np.array([eng.predict(X[i])[0] for i in range(32)])
    np.testing.assert_allclose(batched, singles, rtol=1e-6)


def test_async_singles_equal_batch(fitted):
    est, X, _, _ = fitted
    n = 24
    with ForestEngine(est, _cfg("hopper", max_batch=n,
                                max_delay_ms=500.0)) as eng:
        futs = [eng.predict_async(X[i]) for i in range(n)]
        got = np.array([f.result(timeout=10) for f in futs])
        # exactly max_batch pending -> one size-triggered forest call
        assert eng.stats.flushes_size == 1
        assert eng.stats.batches == 1
    with ForestEngine(est, _cfg("hopper", cache_size=0)) as ref:
        np.testing.assert_allclose(got, ref.predict(X[:n]), rtol=1e-6)


def test_async_validates_feature_length(fitted):
    est, _, _, _ = fitted
    with ForestEngine(est, _cfg()) as eng:
        with pytest.raises(ValueError):
            eng.predict_async(np.zeros(3, dtype=np.float32))


# ------------------------------------------------------------------- cache

def test_cache_hits_on_repeat(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg("hopper", cache_size=1024)) as eng:
        p1 = eng.predict(X[:20])
        assert eng.stats.cache_misses == 20
        p2 = eng.predict(X[:20])
        assert eng.stats.cache_hits == 20
        assert eng.stats.batches == 1          # second call hit no backend
    np.testing.assert_array_equal(p1, p2)


def test_cache_dedupes_within_one_batch(fitted):
    est, X, _, _ = fitted
    dup = np.repeat(X[:5], 3, axis=0)
    with ForestEngine(est, _cfg()) as eng:
        p = eng.predict(dup)
        assert eng.stats.backend_rows == 5     # 15 rows, 5 unique
    np.testing.assert_array_equal(p[0::3], p[1::3])


def test_cache_eviction_lru(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg(cache_size=8)) as eng:
        eng.predict(X[:16])
        assert eng.cache_len() == 8
        eng.predict(X[8:16])                   # the 8 survivors (LRU)
        assert eng.stats.cache_hits == 8
        eng.predict(X[:8])                     # evicted -> misses again
        assert eng.stats.cache_misses == 16 + 8


def test_cache_disabled(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg(cache_size=0)) as eng:
        eng.predict(X[:4])
        eng.predict(X[:4])
        assert eng.cache_len() == 0
        assert eng.stats.batches == 2


def test_async_cache_hit_resolves_immediately(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg(max_batch=64, max_delay_ms=10_000.0)) as eng:
        warm = eng.predict(X[0])[0]
        fut = eng.predict_async(X[0])          # no flush can fire for 10 s
        assert fut.done()
        assert fut.result() == warm


def test_stats_match_reference_engine(fitted):
    """The same call sequence leaves the same counters in both engines."""
    est, X, _, ref = fitted
    seq = [X[:20], X[10:30], np.repeat(X[:3], 4, axis=0), X[0]]
    with ForestEngine(est, _cfg(cache_size=16)) as eng, \
            RefEngine(ref, RefConfig(backend="flat-numpy",
                                     cache_size=16)) as ref_eng:
        for batch in seq:
            np.testing.assert_allclose(eng.predict(batch),
                                       ref_eng.predict(batch), rtol=1e-12)
        got, want = eng.stats_snapshot(), ref_eng.stats_snapshot()
        assert eng.cache_len() == ref_eng.cache_len()
    for name in vars(got):
        assert getattr(got, name) == getattr(want, name), name


# ---------------------------------------------------------- deadline flush

def test_deadline_flush(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg(max_batch=64, max_delay_ms=30.0)) as eng:
        t0 = time.monotonic()
        fut = eng.predict_async(X[0])          # 1 pending << max_batch
        got = fut.result(timeout=10)
        elapsed = time.monotonic() - t0
        assert eng.stats.flushes_deadline == 1
        assert eng.stats.flushes_size == 0
    assert elapsed < 5.0                       # deadline, not the 64th request
    np.testing.assert_allclose(got, est.predict(X[:1])[0], rtol=1e-5)


def test_manual_flush(fitted):
    est, X, _, _ = fitted
    with ForestEngine(est, _cfg(max_batch=64, max_delay_ms=10_000.0)) as eng:
        futs = [eng.predict_async(X[i]) for i in range(3)]
        assert not any(f.done() for f in futs)
        assert eng.flush() == 3
        assert all(f.done() for f in futs)


def test_close_flushes_pending(fitted):
    est, X, _, _ = fitted
    eng = ForestEngine(est, _cfg(max_batch=64, max_delay_ms=10_000.0))
    fut = eng.predict_async(X[0])
    eng.close()
    assert fut.done()
    with pytest.raises(RuntimeError):
        eng.predict_async(X[0])


def test_close_idempotent_and_joins_worker(fitted):
    est, X, _, _ = fitted
    eng = ForestEngine(est, _cfg(max_batch=64, max_delay_ms=10_000.0))
    eng.predict_async(X[0])
    worker = eng._worker
    assert worker is not None and worker.is_alive()
    eng.close()
    assert not worker.is_alive()               # joined, not leaked
    flushes = eng.stats.flushes_manual
    eng.close()                                # second close: clean no-op
    eng.close()
    assert eng.stats.flushes_manual == flushes


def test_close_races_predict_async(fitted):
    """predict_async storm racing close(): every future must either resolve
    or the submit must raise the closed error — nothing hangs."""
    est, X, _, _ = fitted
    eng = ForestEngine(est, _cfg("hopper", max_batch=8, max_delay_ms=0.2,
                                 cache_size=0))
    futs, rejected = [], []
    stop = threading.Event()

    def spam():
        i = 0
        while not stop.is_set():
            try:
                futs.append(eng.predict_async(X[i % 32]))
            except RuntimeError:
                rejected.append(i)
                return
            i += 1

    threads = [threading.Thread(target=spam) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    closers = [threading.Thread(target=eng.close) for _ in range(3)]
    for t in closers:
        t.start()
    stop.set()
    for t in threads + closers:
        t.join(timeout=30)
        assert not t.is_alive()
    for f in futs:
        assert f.done()
        f.result(timeout=1)                    # resolved, not dropped


# ---------------------------------------------------------------- hot-swap

def test_swap_estimator_invalidates_cache_and_bumps_generation(fitted):
    est, X, y, _ = fitted
    est2 = ExtraTreesRegressor(n_estimators=8, max_depth=6, seed=9).fit(
        X, y + 2.0)
    with ForestEngine(est, _cfg("hopper")) as eng:
        assert eng.generation == 0
        p1 = eng.predict(X[:16])
        assert eng.cache_len() == 16
        gen = eng.swap_estimator(est2)
        assert gen == 1
        assert eng.stats.generation == 1 and eng.stats.swaps == 1
        assert eng.backend == "hopper"
        assert eng.cache_len() == 0            # stale predictions dropped
        misses = eng.stats.cache_misses
        p2 = eng.predict(X[:16])
        assert eng.stats.cache_misses == misses + 16
        np.testing.assert_allclose(p2, est2.predict(X[:16]), rtol=1e-6)
        assert not np.allclose(p1, p2)


def test_swap_estimator_validates(fitted):
    est, X, y, _ = fitted
    with ForestEngine(est, _cfg()) as eng:
        with pytest.raises(ValueError):
            eng.swap_estimator(ExtraTreesRegressor())      # unfitted
        wrong = ExtraTreesRegressor(n_estimators=2, seed=0).fit(
            X[:, :4], y)                                   # 4 != 10 features
        with pytest.raises(ValueError):
            eng.swap_estimator(wrong)
        assert eng.generation == 0             # failed swaps change nothing
    with pytest.raises(RuntimeError):
        eng.swap_estimator(est)                # closed engine refuses swaps


def test_async_requests_span_swap(fitted):
    est, X, y, _ = fitted
    est2 = ExtraTreesRegressor(n_estimators=8, max_depth=6, seed=9).fit(
        X, y + 2.0)
    with ForestEngine(est, _cfg(max_batch=64, max_delay_ms=10_000.0)) as eng:
        futs = [eng.predict_async(X[i]) for i in range(6)]
        eng.swap_estimator(est2)
        eng.flush()
        got = np.array([f.result(timeout=10) for f in futs])
        # queued BEFORE the swap, flushed AFTER: answered by the new
        # generation, uniformly (pending requests survive the swap)
        np.testing.assert_allclose(got, est2.predict(X[:6]), rtol=1e-6)


# -------------------------------------------------- multi-device / scheduler

@pytest.fixture(scope="module")
def multi(fitted):
    est, X, y, ref = fitted
    ref2 = RefTrees(n_estimators=8, max_depth=6, seed=1).fit(
        X, y + np.log(3.0))                    # a ~3x slower device
    ref_p = RefTrees(n_estimators=8, max_depth=6, seed=2).fit(
        X, np.full(len(y), 75.0))
    fits = {"fast": (est, _carry(ref_p)), "slow": (_carry(ref2), None)}
    ref_fits = {"fast": (ref, ref_p), "slow": (ref2, None)}
    mde = MultiDeviceEngine.from_fits(fits, counts={"fast": 2},
                                      config=_cfg("hopper"))
    ref_mde = RefMulti.from_fits(ref_fits, counts={"fast": 2},
                                 config=RefConfig(backend="dense-jax"))
    yield mde, ref_mde, X
    mde.close()
    ref_mde.close()


def test_price_matches_reference(multi):
    mde, ref_mde, X = multi
    T, P = mde.price(X[:30])
    Tr, Pr = ref_mde.price(X[:30])
    assert T.shape == P.shape == (30, 2)
    np.testing.assert_allclose(T, Tr, rtol=1e-5)
    np.testing.assert_allclose(P, Pr, rtol=1e-5)
    assert np.allclose(P[:, 1], 1.0)           # no power model -> unit power


@pytest.mark.parametrize("objective", ["makespan", "energy", "edp"])
def test_schedule_matches_reference(multi, objective):
    mde, ref_mde, X = multi
    got = schedule(X[:40], mde, objective)
    want = r_schedule(X[:40], ref_mde, objective)
    assert len(got.assignments) == 40
    np.testing.assert_allclose(got.makespan_us, want.makespan_us, rtol=1e-5)
    np.testing.assert_allclose(got.energy_j, want.energy_j, rtol=1e-5)
    assert ([a.device for a in got.assignments]
            == [a.device for a in want.assignments])


def test_scheduler_consumes_engine_frontend(multi):
    mde, _, X = multi
    T_eng, P_eng = predict_matrix(X[:40], mde)
    T_dp, P_dp = predict_matrix(X[:40], mde.to_device_predictors())
    np.testing.assert_allclose(T_eng, T_dp)
    np.testing.assert_allclose(P_eng, P_dp)


def test_legacy_callable_predictors_still_work(fitted):
    est, X, _, _ = fitted
    devs = [DevicePredictor("a", est.predict, None, log_time=True),
            DevicePredictor("b", lambda Z: est.predict(Z) + 1.0, None)]
    T, _ = predict_matrix(X[:10], devs)
    assert (T[:, 1] > T[:, 0]).all()


def test_multi_device_swap_fits(fitted):
    est, X, y, _ = fitted
    est2 = ExtraTreesRegressor(n_estimators=8, max_depth=6, seed=1).fit(
        X, y + np.log(3.0))
    est_new = ExtraTreesRegressor(n_estimators=8, max_depth=6, seed=7).fit(
        X, y + 1.0)
    mde = MultiDeviceEngine.from_fits(
        {"fast": (est, None), "slow": (est2, None)}, config=_cfg())
    try:
        T_before, _ = mde.price(X[:10])
        gens = mde.swap_fits({"fast": (est_new, None)})
        assert gens == {"fast": 1}
        assert mde.generations() == {"fast": 1, "slow": 0}
        T_after, _ = mde.price(X[:10])
        np.testing.assert_allclose(T_after[:, 0],
                                   np.exp(est_new.predict(X[:10])), rtol=1e-6)
        np.testing.assert_allclose(T_after[:, 1], T_before[:, 1])  # untouched
        with pytest.raises(KeyError):
            mde.swap_fits({"nope": (est_new, None)})
        # atomicity: one bad fit rejects the WHOLE batch — no device swaps
        wrong = ExtraTreesRegressor(n_estimators=2, seed=0).fit(X[:, :4], y)
        with pytest.raises(ValueError):
            mde.swap_fits({"fast": (est, None), "slow": (wrong, None)})
        assert mde.generations() == {"fast": 1, "slow": 0}
    finally:
        mde.close()
