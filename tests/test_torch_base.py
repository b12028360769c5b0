"""The port's framework-neutral base against the reference: the numpy
modules copied into ``repro_torch.core`` give bitwise-equal results for the
same inputs and rng state, the committed suite fixture loads to the same
matrices, a reference-fitted forest carries across, and the package keeps
its import and device rules."""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the reference's package imports it)
import numpy as np
import pytest
import torch

from repro.core import dataset as r_dataset
from repro.core import devices as r_devices
from repro.core import forest as r_forest
from repro.core import metrics as r_metrics
from repro.core import power as r_power
from repro.core import simulate as r_simulate
from repro.core import split as r_split
from repro.core.forest_jax import to_dense as r_to_dense
from repro_torch.core import convert
from repro_torch.core import dataset as p_dataset
from repro_torch.core import devices as p_devices
from repro_torch.core import features as p_features
from repro_torch.core import forest as p_forest
from repro_torch.core import metrics as p_metrics
from repro_torch.core import power as p_power
from repro_torch.core import simulate as p_simulate
from repro_torch.core import split as p_split
from repro_torch.core.forest_torch import to_dense as p_to_dense

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "suite_dataset_v1.json"
TREE_FIELDS = ("feature", "threshold", "left", "right", "value", "n_samples",
               "impurity")


def _data(seed=0, n=120, f=12):
    rng = np.random.default_rng(seed)
    X = rng.lognormal(1.0, 1.5, size=(n, f)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3.0) + 0.1 * rng.normal(size=n)
    return X, y


def _assert_trees_equal(a, b):
    assert len(a.trees_) == len(b.trees_)
    for ta, tb in zip(a.trees_, b.trees_):
        for k in TREE_FIELDS:
            np.testing.assert_array_equal(getattr(ta, k), getattr(tb, k),
                                          err_msg=k)


# ------------------------------------------------------------------ forest

FIT_PARAMS = [
    dict(n_estimators=8, seed=0),
    dict(n_estimators=6, criterion="mae", max_features="sqrt", seed=3),
    dict(n_estimators=6, max_features="log2", max_depth=5,
         min_samples_leaf=2, seed=5),
    dict(n_estimators=4, max_features=4, min_samples_split=6, seed=7),
]


@pytest.mark.parametrize("params", FIT_PARAMS)
def test_extra_trees_bitwise_equal(params):
    X, y = _data()
    a = p_forest.ExtraTreesRegressor(**params).fit(X, y)
    b = r_forest.ExtraTreesRegressor(**params).fit(X, y)
    _assert_trees_equal(a, b)
    np.testing.assert_array_equal(a.predict(X), b.predict(X))
    np.testing.assert_array_equal(a.predict(X, n_trees=2),
                                  b.predict(X, n_trees=2))
    np.testing.assert_array_equal(a.feature_importances_,
                                  b.feature_importances_)
    assert a.avg_depth() == b.avg_depth()
    fa, fb = a.to_flat(), b.to_flat()
    for k in ("feature", "threshold", "left", "right", "value", "roots"):
        np.testing.assert_array_equal(getattr(fa, k), getattr(fb, k))
    assert fa.max_depth == fb.max_depth
    np.testing.assert_array_equal(p_forest.predict_flat(fa, X),
                                  r_forest.predict_flat(fb, X))


@pytest.mark.parametrize("depth", [2, 6, 10])
def test_to_dense_bitwise_equal(depth):
    X, y = _data(1)
    a = p_forest.ExtraTreesRegressor(n_estimators=6, seed=1).fit(X, y)
    b = r_forest.ExtraTreesRegressor(n_estimators=6, seed=1).fit(X, y)
    da, db = p_to_dense(a, depth), r_to_dense(b, depth)
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(da, k), getattr(db, k))
    assert (da.depth, da.n_features) == (db.depth, db.n_features)
    np.testing.assert_array_equal(p_to_dense(a, depth, n_trees=3).value,
                                  r_to_dense(b, depth, n_trees=3).value)


def test_linear_baseline_equal():
    X, y = _data(2)
    for log_features in (True, False):
        a = p_forest.LinearBaseline(log_features).fit(X, y)
        b = r_forest.LinearBaseline(log_features).fit(X, y)
        np.testing.assert_array_equal(a.predict(X), b.predict(X))


# ------------------------------------------------- simulate / power / devices

def test_device_zoo_equal():
    assert ([dataclasses.asdict(d) for d in p_devices.DEVICE_MODELS.values()]
            == [dataclasses.asdict(d) for d in r_devices.DEVICE_MODELS.values()])
    assert ([d.name for d in p_devices.SIMULATED_DEVICES]
            == [d.name for d in r_devices.SIMULATED_DEVICES])
    assert p_features.FEATURE_NAMES == r_dataset.FEATURE_NAMES
    assert p_features.N_FEATURES == 12


SPEC = dict(flops=3e9, hbm_bytes=2e8, collective_bytes=1e6,
            special_ops=1e6, control_ops=1e4, work_items=4096.0)


@pytest.mark.parametrize("name", sorted(r_devices.DEVICE_MODELS))
@pytest.mark.parametrize("freq", [1.0, 0.7])
def test_simulated_targets_equal(name, freq):
    pd, rd = p_devices.DEVICE_MODELS[name], r_devices.DEVICE_MODELS[name]
    for n_shards in (1, 4):
        ps = p_simulate.WorkloadSpec(**SPEC, n_shards=n_shards)
        rs = r_simulate.WorkloadSpec(**SPEC, n_shards=n_shards)
        got = (p_simulate.simulate_time_median_us(
                   ps, pd, np.random.default_rng(3), freq=freq),
               p_power.simulate_power_mean_w(
                   ps, pd, np.random.default_rng(4), freq=freq))
        want = (r_simulate.simulate_time_median_us(
                    rs, rd, np.random.default_rng(3), freq=freq),
                r_power.simulate_power_mean_w(
                    rs, rd, np.random.default_rng(4), freq=freq))
        assert got == want


def test_power_split_fit_equal():
    specs = [p_simulate.WorkloadSpec(**{**SPEC, "flops": f})
             for f in (1e7, 1e9, 1e11)]
    r_specs = [r_simulate.WorkloadSpec(**{**SPEC, "flops": f})
               for f in (1e7, 1e9, 1e11)]
    pf, pr = p_power.collect_dvfs_samples(specs, seed=2)
    rf, rr = r_power.collect_dvfs_samples(r_specs, seed=2)
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pr, rr)
    (ps, perr), (rs_, rerr) = (p_power.fit_power_split(pf, pr),
                               r_power.fit_power_split(rf, rr))
    assert (ps.idle_frac, ps.alpha, perr) == (rs_.idle_frac, rs_.alpha, rerr)
    X = np.abs(np.random.default_rng(5).normal(size=(16, 12))) * 1e6
    for name in ("tpu-v5e", "edge-dvfs"):
        np.testing.assert_array_equal(
            p_simulate.AnalyticalBaseline(p_devices.DEVICE_MODELS[name]).predict(X),
            r_simulate.AnalyticalBaseline(r_devices.DEVICE_MODELS[name]).predict(X))


# --------------------------------------------------------- metrics / split

def test_metrics_equal():
    rng = np.random.default_rng(6)
    y = rng.lognormal(3, 2, size=200)
    p = y * rng.lognormal(0, 0.4, size=200)
    for fn in ("ape", "mape", "median_ape", "mae", "mse", "rmse", "smape",
               "error_buckets"):
        got = getattr(p_metrics, fn)(y, p)
        want = getattr(r_metrics, fn)(y, p)
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want, fn


def test_splits_equal():
    y = np.random.default_rng(7).lognormal(7, 3, size=90)
    for k in (2, 5):
        for pf, rf in zip(p_split.time_stratified_kfold(
                              y, k, np.random.default_rng(k)),
                          r_split.time_stratified_kfold(
                              y, k, np.random.default_rng(k))):
            np.testing.assert_array_equal(pf.train, rf.train)
            np.testing.assert_array_equal(pf.test, rf.test)
        for pf, rf in zip(p_split.plain_kfold(90, k, np.random.default_rng(k)),
                          r_split.plain_kfold(90, k, np.random.default_rng(k))):
            np.testing.assert_array_equal(pf.test, rf.test)
    np.testing.assert_array_equal(
        p_split.duration_strata(y), r_split.duration_strata(y))
    pl = p_split.loo_folds(12, forced_train=np.array([0, 3]))
    rl = r_split.loo_folds(12, forced_train=np.array([0, 3]))
    assert [f.test.tolist() for f in pl] == [f.test.tolist() for f in rl]


# ----------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def fixture_sets():
    return p_dataset.Dataset.load(FIXTURE), r_dataset.Dataset.load(FIXTURE)


def test_fixture_matrices_equal(fixture_sets):
    p, r = fixture_sets
    assert len(p) == len(r) == 328            # 82 kernels x 4 sizes
    assert p.devices() == r.devices()
    for dev in r.devices():
        for target in ("time_us", "power_w"):
            Xp, yp, kp = p.matrix(dev, target)
            Xr, yr, kr = r.matrix(dev, target)
            np.testing.assert_array_equal(Xp, Xr)
            np.testing.assert_array_equal(yp, yr)
            assert [s.group for s in kp] == [s.group for s in kr]
        assert p.stats(dev) == r.stats(dev)


def test_fixture_cap_and_store_equal(fixture_sets):
    p, r = fixture_sets
    for cap in (100, 3):
        a = p.reduce_overrepresented(max_per_group=cap, seed=1)
        b = r.reduce_overrepresented(max_per_group=cap, seed=1)
        assert [s.to_json() for s in a.samples] == [s.to_json()
                                                    for s in b.samples]
    ps = p_dataset.DatasetStore.from_dataset(p, max_per_group=2)
    rs = r_dataset.DatasetStore.from_dataset(r, max_per_group=2)
    assert ps.version == rs.version == 1
    assert ([s.to_json() for s in ps.snapshot().dataset.samples]
            == [s.to_json() for s in rs.snapshot().dataset.samples])


def test_dataset_round_trip(tmp_path, fixture_sets):
    p, _ = fixture_sets
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    p.save(a)
    r_dataset.Dataset.load(a).save(b)
    assert a.read_bytes() == b.read_bytes()


# --------------------------------------------------------- weights across

def test_reference_forest_carries_across():
    X, y = _data(8)
    ref = r_forest.ExtraTreesRegressor(n_estimators=10, seed=4).fit(X, y)
    est = convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())
    _assert_trees_equal(est, ref)
    np.testing.assert_array_equal(est.predict(X), ref.predict(X))
    assert est.get_params() == ref.get_params()
    rd = r_to_dense(ref, 6)
    dense = convert.dense_from_arrays(rd.feature, rd.threshold, rd.value,
                                      rd.depth, rd.n_features)
    pd = p_to_dense(est, 6)
    for k in ("feature", "threshold", "value"):
        np.testing.assert_array_equal(getattr(dense, k), getattr(pd, k))


def test_convert_rejects_bad_arrays():
    X, y = _data(9)
    ref = r_forest.ExtraTreesRegressor(n_estimators=2, seed=0).fit(X, y)
    bad = dict(vars(ref.trees_[0]))
    bad["feature"] = np.where(bad["feature"] >= 0, 12, -1)
    with pytest.raises(ValueError):
        convert.estimator_from_arrays([bad], 12, ref.get_params())
    short = dict(vars(ref.trees_[0]))
    del short["impurity"]
    with pytest.raises(ValueError):
        convert.estimator_from_arrays([short], 12, ref.get_params())
    rd = r_to_dense(ref, 4)
    with pytest.raises(ValueError):
        convert.dense_from_arrays(rd.feature, rd.threshold, rd.value, 5, 12)


# ------------------------------------------------------ import/device rules

def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith("
        "('jax.', 'jaxlib')) or k == 'repro' or k.startswith('repro.'))\n"
        "assert len(mods) >= 20, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_smoke_script_imports_neither_jax_nor_reference():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "repro_torch.serve" in names
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a card-less host")
    from repro_torch.core.forest_torch import DenseForestTorch, FlatForestTorch
    from repro_torch.cluster.remote import demo_frontend
    from repro_torch.serve import (ForestEngine, ShardedForestEngine,
                                   build_backends)
    from repro_torch.workloads.collect import collect
    from repro_torch.workloads.stream import StreamingCollector
    X, y = _data(10)
    est = p_forest.ExtraTreesRegressor(n_estimators=2, seed=0).fit(X, y)
    for make in (lambda: ForestEngine(est),
                 lambda: build_backends(est),
                 lambda: FlatForestTorch(est.to_flat()),
                 lambda: DenseForestTorch(p_to_dense(est, 4)),
                 lambda: collect(),
                 lambda: StreamingCollector(p_dataset.DatasetStore()),
                 lambda: ShardedForestEngine(est),
                 lambda: demo_frontend()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
