"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``): the same updates give the same snapshot and
the same Prometheus exposition byte for byte; the engines, the sharded
engine, the refresher and the supervisor register the same names with the
same TYPE lines in both; calibration MAPE and trace context agree."""
import jax  # noqa: F401  (the reference's engine imports it)
import numpy as np
import pytest

from repro import obs as r_obs
from repro.core.dataset import DatasetStore as RefStore
from repro.core.devices import TPU_V5E as R_TPU_V5E
from repro.core.forest import ExtraTreesRegressor as RefTrees
from repro.core.transfer import TransferPredictor as RefTransfer
from repro.serve import EngineConfig as RefConfig
from repro.serve import EngineRefresher as RefRefresher
from repro.serve import ForestEngine as RefEngine
from repro.serve import ShardedForestEngine as RefSharded
from repro.serve import TransferSupervisor as RefSupervisor
from repro_torch import obs as p_obs
from repro_torch.core import convert
from repro_torch.core.dataset import DatasetStore
from repro_torch.core.devices import TPU_V5E
from repro_torch.core.transfer import TransferPredictor
from repro_torch.serve import (EngineConfig, EngineRefresher, ForestEngine,
                               ShardedForestEngine, TransferSupervisor)


def _carry(ref):
    return convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(5)
    X = rng.lognormal(1.0, 1.5, size=(120, 8)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3.0)
    ref = RefTrees(n_estimators=9, max_depth=6, seed=0).fit(X, y)
    return _carry(ref), ref, X


def _drive_registry(obs_mod):
    reg = obs_mod.MetricsRegistry()
    reg.counter("frontend.served").inc(3)
    reg.counter("frontend.served", tenant="a").inc()
    reg.counter("frontend.shed", tenant="b-1").inc(2.5)
    g = reg.gauge("pool.healthy", replica="r0")
    g.set(4)
    g.add(-1)
    h = reg.histogram("frontend.wait_s")
    for v in (1e-5, 3e-4, 2e-3, 0.04, 0.9, 7.0, 1e3):
        h.observe(v)
    reg.histogram("engine.batch_rows", buckets=(1, 8, 64)).observe(12)
    reg.register_fn("engine.hit_rate", lambda: 0.25, replica="r0")
    reg.register_fn("engine.predictions", lambda: 17, kind="counter")
    reg.register_fn("broken", lambda: 1 / 0)
    res = obs_mod.Reservoir(capacity=64, seed=3)
    for v in np.random.default_rng(0).lognormal(size=500):
        res.offer(float(v))
    mon = obs_mod.CalibrationMonitor(reg, alpha=0.3, min_samples=2)
    for i in range(12):
        mon.record("chip", "time_us", 10.0 + i, 11.0 + 0.5 * i,
                   kernel=f"k{i % 3}")
    mon.record("chip", "power_w", 200.0, 190.0)
    return reg, res, mon


def test_registry_exposition_is_the_reference_s():
    ref_reg, ref_res, ref_mon = _drive_registry(r_obs)
    reg, res, mon = _drive_registry(p_obs)
    assert reg.render_prometheus() == ref_reg.render_prometheus()
    assert repr(reg.snapshot()) == repr(ref_reg.snapshot())
    assert res.values() == ref_res.values()
    assert [res.percentile(p) for p in (50, 95, 99)] == [
        ref_res.percentile(p) for p in (50, 95, 99)]
    assert mon.series() == ref_mon.series()
    assert mon.mape_by_kernel("chip", "time_us") == ref_mon.mape_by_kernel(
        "chip", "time_us")
    assert mon.over_threshold({"time_us": 1.0, "power_w": 1.0}) == \
        ref_mon.over_threshold({"time_us": 1.0, "power_w": 1.0})


def test_engine_register_metrics_matches_reference(fitted):
    """ForestEngine and ShardedForestEngine export the reference's names
    and kinds; after the same traffic, a drop and a swap the whole
    exposition is the same, shard_drops and trees_lost included."""
    est, ref, X = fitted
    texts = []
    for engine, sharded, forest in (
            (lambda e: ForestEngine(e, EngineConfig(backend="flat-numpy",
                                                    device="cpu")),
             lambda e: ShardedForestEngine(e, n_shards=3, device="cpu"),
             est),
            (lambda e: RefEngine(e, RefConfig(backend="flat-numpy")),
             lambda e: RefSharded(e, n_shards=3), ref)):
        reg = (p_obs if forest is est else r_obs).MetricsRegistry()
        with engine(forest) as eng, sharded(forest) as sh:
            eng.register_metrics(reg, replica="r0")
            sh.register_metrics(reg, replica="sharded")
            for e in (eng, sh):
                e.predict(X[:40])
                e.predict(X[20:60])
                e.predict_async(X[70]).result(timeout=10)
            sh.drop_shard(1)
            sh.predict(X[:10])
            eng.swap_estimator(forest)
            texts.append(reg.render_prometheus())
    port, reference = texts
    assert port == reference
    for name in ("shard_drops", "trees_lost", "predictions", "swaps"):
        assert f"# TYPE repro_engine_{name} counter" in port
    for name in ("generation", "hit_rate", "cache_len"):
        assert f"# TYPE repro_engine_{name} gauge" in port
    assert 'repro_engine_shard_drops{replica="sharded"} 1' in port
    assert 'repro_engine_trees_lost{replica="sharded"} 3' in port


def _refresher_text(obs_mod, transfer, device, engine, config, refresher,
                    store):
    est = transfer(device)
    rng = np.random.default_rng(0)
    X = rng.lognormal(8, 2, size=(16, 12))
    y = rng.lognormal(3, 1, size=16)
    est.calibrate((X, y))
    with engine(est.to_forest(), config) as eng:
        ref = refresher(store(), eng, fit_fn=lambda ds: None)
        reg = obs_mod.MetricsRegistry()
        ref.register_metrics(reg)
        return reg.render_prometheus()


def test_refresher_metrics_pinned_kinds():
    """tests/test_supervise.py's refresher check, on the port's registry,
    and the same exposition as the reference's."""
    text = _refresher_text(p_obs, TransferPredictor, TPU_V5E, ForestEngine,
                           EngineConfig(backend="tree-walk", cache_size=0,
                                        device="cpu"),
                           EngineRefresher, DatasetStore)
    for name in ("last_version", "failed_version"):
        assert f"# TYPE repro_refresh_{name} gauge" in text, text
        assert f"repro_refresh_{name} -1" in text
    for name in ("refreshes", "skipped", "drift_skipped",
                 "drift_refreshes", "errors"):
        assert f"# TYPE repro_refresh_{name} counter" in text, text
    assert text == _refresher_text(
        r_obs, RefTransfer, R_TPU_V5E, RefEngine,
        RefConfig(backend="tree-walk", cache_size=0), RefRefresher, RefStore)


def test_supervisor_metrics_pinned_kinds():
    texts = []
    for obs_mod, transfer, store, supervisor in (
            (p_obs, TransferPredictor, DatasetStore, TransferSupervisor),
            (r_obs, RefTransfer, RefStore, RefSupervisor)):
        reg = obs_mod.MetricsRegistry()
        mon = obs_mod.CalibrationMonitor(reg, alpha=0.5, min_samples=4)
        sup = supervisor(store(), mon, registry=reg)
        sup.manage(transfer("new-chip", monitor=mon), key="new-chip")
        sup.supervise_once()
        texts.append(reg.render_prometheus())
    text = texts[0]
    for name in ("polls", "ingested", "feedback", "graduations",
                 "retargets", "alerts", "errors"):
        assert f"# TYPE repro_supervisor_{name} counter" in text, text
    for name in ("last_store_version", "devices", "graduated_devices",
                 "envelope_exceeded"):
        assert f"# TYPE repro_supervisor_{name} gauge" in text, text
    assert "repro_supervisor_devices 1" in text
    assert text == texts[1]


def test_trace_context_and_spans_cross_packages():
    """Trace context rides the frame meta: each package reads the other's
    context and spans."""
    for src, dst in ((p_obs, r_obs), (r_obs, p_obs)):
        tracer = src.Tracer(slow_threshold_s=None)
        root = tracer.start("client.request")
        child = tracer.start("wire", parent=root.ctx)
        tracer.finish(child, rows=4)
        tracer.finish(root)
        meta = src.ctx_to_meta(root.ctx)
        ctx = dst.ctx_from_meta(meta)
        assert (ctx.trace_id, ctx.span_id) == (root.trace_id, root.span_id)
        other = dst.Tracer(slow_threshold_s=None)
        assert other.ingest(tracer.export(root.trace_id)) == 2
        assert other.export(root.trace_id) == tracer.export(root.trace_id)
        assert other.render_tree(root.trace_id) == tracer.render_tree(
            root.trace_id)
        assert src.ctx_from_meta({"bad": 1}) is None
        assert dst.ctx_from_meta({"bad": 1}) is None
