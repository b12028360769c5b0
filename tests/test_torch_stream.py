"""The port's streaming collection and live refresh
(``repro_torch.workloads.stream``, ``repro_torch.serve.refresh``): the
reference's collector and refresher tests on the port's modules, with torch
workloads and engines on the host, and the port's streamed store beside the
reference's, streamed over the same workloads from the same seed."""
import threading
import time

import jax  # noqa: F401  (the reference's package imports it)
import numpy as np
import pytest
import torch

from repro.core.dataset import DatasetStore as RDatasetStore
from repro.workloads.stream import StreamingCollector as RStreamingCollector
from repro.workloads.suite import suite as r_suite
from repro_torch.core.dataset import Dataset, DatasetStore, Sample
from repro_torch.core.forest import ExtraTreesRegressor
from repro_torch.serve import (EngineRefresher, ForestEngine,
                               single_device_fit_fn)
from repro_torch.workloads.collect import collect
from repro_torch.workloads.stream import StreamingCollector, iter_samples
from repro_torch.workloads.suite import Workload
from repro_torch.workloads.suite import suite as p_suite

N_F = 8
SIM_INPUTS = ("flops", "hbm_bytes", "collective_bytes", "special_ops",
              "control_ops")


def _workloads(n=5):
    out = []
    for i in range(n):
        rows = 8 * (i + 1)
        a = torch.arange(float(rows * 4)).reshape(rows, 4)
        out.append(Workload("toy", f"k{i}", f"n{rows}",
                            lambda a: (a * 2.0 + 1.0).sum(dim=1), (a,),
                            float(rows)))
    return out


def _sample(i: int, kernel: str = "k") -> Sample:
    return Sample(app="app", kernel=kernel, variant=f"v{i}",
                  features=np.full(N_F, float(i)),
                  targets={"d": {"time_us": float(i + 1)}})


def _engine(est, **kw):
    return ForestEngine(est, device="cpu", backend="flat-numpy", **kw)


# ------------------------------------------------------------- determinism

def test_streamed_samples_equal_batch_collect():
    wls = _workloads()
    streamed = list(iter_samples(wls, repeats=3, measure_cpu=False, seed=7))
    batch = collect(wls, repeats=3, measure_cpu=False, seed=7)
    assert len(streamed) == len(batch.samples)
    for a, b in zip(streamed, batch.samples):
        assert a.to_json() == b.to_json()


def test_streaming_collector_snapshot_determinism():
    wls = _workloads()
    snaps = []
    for chunk in (1, 3):                       # chunking must not matter
        store = DatasetStore(max_per_group=100, seed=0)
        c = StreamingCollector(store, wls, repeats=3, measure_cpu=False,
                               seed=11, chunk_size=chunk)
        assert c.run_sync() == len(wls)
        snaps.append(store.snapshot())
    a, b = snaps
    assert [s.to_json() for s in a.dataset.samples] == \
           [s.to_json() for s in b.dataset.samples]


def test_streaming_collector_background_thread():
    wls = _workloads()
    store = DatasetStore(max_per_group=100, seed=0)
    chunks = []
    c = StreamingCollector(store, wls, repeats=2, measure_cpu=False, seed=0,
                           chunk_size=2,
                           on_chunk=lambda v, n: chunks.append((v, n)))
    with c:
        assert c.wait(timeout=120)
    assert c.error is None
    assert c.collected == len(wls)
    assert len(store) == len(wls)
    assert store.version == len(chunks)        # one version bump per chunk
    assert sum(n for _, n in chunks) == len(wls)


def test_streaming_collector_surfaces_errors():
    def boom(a):
        raise RuntimeError("workload failed")
    wls = _workloads(2) + [Workload("toy", "bad", "n1", boom,
                                    (torch.ones(2),), 1.0)]
    store = DatasetStore(max_per_group=100, seed=0)
    seen = []
    c = StreamingCollector(store, wls, measure_cpu=False, chunk_size=1)
    c.add_on_chunk(lambda v, n: seen.append(v))
    with pytest.raises(Exception, match="workload failed"):
        c.run_sync()
    assert c.error is not None and c.done.is_set()
    assert c.collected == 2 and seen == [1, 2]


# --------------------------------------------------------------- refresher

def _const_est(X: np.ndarray, c: float) -> ExtraTreesRegressor:
    """Forest whose every prediction is EXACTLY c (constant target => the
    root is a pure leaf) — makes model generations observable per row."""
    return ExtraTreesRegressor(n_estimators=4, seed=0).fit(
        X, np.full(X.shape[0], c))


def test_refresher_refits_on_new_snapshots():
    rng = np.random.default_rng(0)
    X = rng.lognormal(1.0, 1.0, (32, N_F)).astype(np.float32)
    store = DatasetStore(max_per_group=100, seed=0)
    eng = _engine(_const_est(X, 0.0))
    ref = EngineRefresher(store, eng, lambda ds: _const_est(X, float(len(ds))),
                          min_samples=1)
    assert ref.refresh_once() is None          # empty store: nothing to do
    store.append(_sample(0))
    assert ref.refresh_once() == store.version
    assert eng.generation == 1
    assert eng.predict(X[:4])[0] == 1.0        # trained on the 1-sample set
    assert ref.refresh_once() is None          # no new version
    assert ref.stats.refreshes == 1 and ref.stats.skipped == 2
    store.extend([_sample(1), _sample(2)])
    assert ref.refresh_once() == store.version
    assert eng.predict(X[:4])[0] == 3.0
    eng.close()


def test_refresher_blacklists_failing_version():
    """A deterministically bad snapshot must not become a refit hot-loop:
    the failed version is skipped until the store advances."""
    rng = np.random.default_rng(0)
    X = rng.lognormal(1.0, 1.0, (16, N_F)).astype(np.float32)
    store = DatasetStore(max_per_group=100, seed=0)
    store.append(_sample(0))
    eng = _engine(_const_est(X, 0.0))
    calls = []

    def flaky_fit(ds):
        calls.append(len(ds))
        if len(ds) < 2:
            raise RuntimeError("not enough signal")
        return _const_est(X, float(len(ds)))

    ref = EngineRefresher(store, eng, flaky_fit, min_samples=1)
    with pytest.raises(RuntimeError):
        ref.refresh_once()
    assert ref.stats.errors == 1
    assert ref.stats.failed_version == store.version
    assert ref.refresh_once() is None          # blacklisted, NOT retried
    assert len(calls) == 1
    assert eng.generation == 0                 # old generation kept serving
    store.append(_sample(1))                   # store advances -> retry
    assert ref.refresh_once() == store.version
    assert eng.generation == 1 and len(calls) == 2
    eng.close()


def test_refresher_background_thread_and_fit_fn_helper():
    wls = _workloads(4)
    store = DatasetStore(max_per_group=100, seed=0)
    store.extend(list(iter_samples(wls[:2], repeats=2, measure_cpu=False,
                                   seed=0)))
    fit = single_device_fit_fn("tpu-v5e", n_estimators=8)
    eng = _engine(fit(store.snapshot().dataset))
    with EngineRefresher(store, eng, fit, min_samples=1, poll_s=0.01) as ref:
        store.extend(list(iter_samples(wls[2:], repeats=2, measure_cpu=False,
                                       seed=1)))
        deadline = time.monotonic() + 30
        while ref.stats.last_version < store.version:
            assert time.monotonic() < deadline
            time.sleep(0.01)
    assert ref.stats.refreshes >= 1
    assert eng.generation >= 1
    # the serving forest is the helper's fit on the latest snapshot
    X, y, _ = store.snapshot().dataset.matrix("tpu-v5e", "time_us")
    X = X.astype(np.float32)
    want = ExtraTreesRegressor(n_estimators=8, seed=0).fit(X, np.log(y))
    np.testing.assert_allclose(eng.predict(X), want.predict(X), rtol=1e-6)
    with pytest.raises(ValueError, match="no samples"):
        fit(Dataset())
    eng.close()


@pytest.mark.parametrize("backend", ["flat-numpy", "hopper"])
def test_hot_swap_never_mixes_generations_under_load(backend):
    """Acceptance: swaps land mid-storm; every answered batch must be
    uniformly one model generation. Constant-prediction forests make a mixed
    batch directly visible as >1 distinct value in one result. ``hopper``
    on the host serves through the forest kernel's plain version, its
    tables packed anew at each swap."""
    rng = np.random.default_rng(1)
    X = rng.lognormal(1.0, 1.0, (48, N_F)).astype(np.float32)
    store = DatasetStore(max_per_group=100, seed=0)
    store.append(_sample(0))
    eng = ForestEngine(_const_est(X, float(len(store))), device="cpu",
                       backend=backend, max_batch=16, max_delay_ms=0.5,
                       cache_size=4096)
    ref = EngineRefresher(store, eng, lambda ds: _const_est(X, float(len(ds))),
                          min_samples=1)

    stop = threading.Event()
    mixed, errors = [], []

    def client():
        try:
            while not stop.is_set():
                out = eng.predict(X)
                vals = np.unique(out)
                if vals.size != 1:
                    mixed.append(vals)
        except Exception as exc:               # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    n_swaps = 8
    for i in range(1, n_swaps + 1):
        time.sleep(0.02)
        store.append(_sample(i))
        assert ref.refresh_once() == store.version
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert not mixed, f"mixed-generation batches: {mixed[:3]}"
    assert eng.generation == n_swaps
    # post-swap steady state serves the latest generation only
    assert eng.predict(X)[0] == float(len(store))
    eng.close()


# ------------------------------------------------------ against the reference

# gemm and triad give the simulator the reference's five inputs at size s,
# atax does not (its hbm_bytes differs)
STREAMED = ("gemm", "atax", "triad")


def _pick(ws):
    by_kernel = {w.kernel: w for w in ws}
    return [by_kernel[k] for k in STREAMED]


def test_streamed_store_equals_reference_where_inputs_equal():
    stores = []
    for Store, Collector, ws in (
            (DatasetStore, StreamingCollector,
             _pick(p_suite(sizes=("s",), device="cpu"))),
            (RDatasetStore, RStreamingCollector, _pick(r_suite(sizes=("s",))))):
        store = Store(max_per_group=100, seed=0)
        assert Collector(store, ws, repeats=3, measure_cpu=False, seed=5,
                         chunk_size=2).run_sync() == len(STREAMED)
        stores.append(store)
    port, ref = stores
    assert port.version == ref.version == 2
    equal = set()
    for p, r in zip(port.snapshot().dataset.samples,
                    ref.snapshot().dataset.samples):
        assert (p.app, p.kernel, p.variant) == (r.app, r.kernel, r.variant)
        if all(p.aux[k] == r.aux[k] for k in SIM_INPUTS):
            equal.add(p.kernel)
            assert p.targets == r.targets, p.kernel
    assert equal >= {"gemm", "triad"}
