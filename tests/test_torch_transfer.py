"""The port's cold-start tier (``repro_torch.core.transfer``) and its
supervisor (``repro_torch.serve.supervise``) against the reference's: the
same probes give bitwise-equal probe orders, priors, refits and
``to_forest()`` fits, and the supervisor graduates at the same step on the
same feed, serving the same answers after it."""
import jax  # noqa: F401  (the reference's engine imports it)
import numpy as np
import pytest

from repro.cluster.frontend import ClusterFrontend as RefFrontend
from repro.cluster.replicas import ReplicaPool as RefPool
from repro.core import transfer as r_tr
from repro.core.dataset import DatasetStore as RefStore
from repro.core.dataset import Sample as RefSample
from repro.core.devices import TPU_V5E as R_TPU_V5E
from repro.obs.calibration import CalibrationMonitor as RefMonitor
from repro.serve import EngineConfig as RefConfig
from repro.serve import ForestEngine as RefEngine
from repro.serve import MultiDeviceEngine as RefMulti
from repro.serve import supervise as r_sup
from repro_torch.cluster.frontend import ClusterFrontend
from repro_torch.cluster.replicas import ReplicaPool
from repro_torch.core import transfer as p_tr
from repro_torch.core.dataset import DatasetStore, Sample
from repro_torch.core.devices import TPU_V5E
from repro_torch.obs.calibration import CalibrationMonitor
from repro_torch.serve import EngineConfig, ForestEngine, MultiDeviceEngine
from repro_torch.serve import supervise as p_sup

DEV = "day-zero-accelerator"


@pytest.fixture(scope="module")
def rows():
    """The supervisor smoke's cliff rows (simulated tpu-v5e physics with an
    off-spec cliff): a probe stream and an eval set, equal in both."""
    Xp, yp = p_sup.cliff_rows(TPU_V5E, 96, seed=1)
    Xe, ye = p_sup.cliff_rows(TPU_V5E, 24, seed=2)
    rXp, ryp = r_sup.cliff_rows(R_TPU_V5E, 96, seed=1)
    np.testing.assert_array_equal(Xp, rXp)
    np.testing.assert_array_equal(yp, ryp)
    return Xp, yp, Xe, ye


def _trees_equal(a, b):
    assert len(a.trees_) == len(b.trees_)
    for ta, tb in zip(a.trees_, b.trees_):
        for k, v in vars(tb).items():
            np.testing.assert_array_equal(getattr(ta, k), v, err_msg=k)


@pytest.mark.parametrize("budget", [1, 7, 40, 96])
def test_select_probes_bitwise(rows, budget):
    Xp = rows[0]
    np.testing.assert_array_equal(p_tr.select_probes(Xp, budget),
                                  r_tr.select_probes(Xp, budget))


@pytest.mark.parametrize("device", [TPU_V5E, "tpu-v4", DEV])
def test_prior_bitwise(rows, device):
    rdev = R_TPU_V5E if device is TPU_V5E else device
    p = p_tr.FittedAnalyticalModel(device)
    r = r_tr.FittedAnalyticalModel(rdev)
    np.testing.assert_array_equal(p.theta, r.theta)
    np.testing.assert_array_equal(p.predict(rows[2]), r.predict(rows[2]))
    assert vars(p_tr.generic_device_prior()) == vars(
        r_tr.generic_device_prior())


@pytest.mark.parametrize("n_probes,mode", [(4, "fitted"), (12, "hybrid"),
                                           (40, "hybrid")])
def test_refits_and_to_forest_bitwise(rows, n_probes, mode):
    """Streamed observations and a bulk calibration refit the same
    coefficients and residual forests; ``to_forest()`` fits the same
    trees."""
    Xp, yp, Xe, _ = rows
    order = p_tr.select_probes(Xp, n_probes)
    cfg = dict(min_samples_leaf=4, shrinkage=32.0)
    p = p_tr.TransferPredictor(DEV, config=p_tr.TransferConfig(**cfg))
    r = r_tr.TransferPredictor(DEV, config=r_tr.TransferConfig(**cfg))
    for j in order:
        assert p.observe(Xp[j], yp[j]) == r.observe(Xp[j], yp[j])
    assert p.mode == r.mode == mode
    assert p.stats_snapshot().as_dict() == r.stats_snapshot().as_dict()
    np.testing.assert_array_equal(p.predict(Xe), r.predict(Xe))
    bulk = p_tr.TransferPredictor(DEV, config=p_tr.TransferConfig(**cfg),
                                  log_output=True)
    rbulk = r_tr.TransferPredictor(DEV, config=r_tr.TransferConfig(**cfg),
                                   log_output=True)
    bulk.calibrate((Xp[order], yp[order]))
    rbulk.calibrate((Xp[order], yp[order]))
    np.testing.assert_array_equal(bulk.predict(Xe), rbulk.predict(Xe))
    if mode == "hybrid":
        pf, rf = p.to_forest(), r.to_forest()
        _trees_equal(pf, rf)
        np.testing.assert_array_equal(pf.predict(Xe), rf.predict(Xe))


@pytest.fixture
def fitted_multi(rows):
    Xp, yp = rows[0], rows[1]
    fits = []
    for tr, dev, engine, cfg in (
            (p_tr, TPU_V5E, ForestEngine,
             EngineConfig(backend="tree-walk", cache_size=0, device="cpu")),
            (r_tr, R_TPU_V5E, RefEngine,
             RefConfig(backend="tree-walk", cache_size=0))):
        t = tr.TransferPredictor(dev)
        t.calibrate((Xp[:24], yp[:24]))
        fits.append((engine(t.to_forest(), cfg)))
    multi = MultiDeviceEngine({"tpu-v5e": {"time_us": fits[0],
                                           "power_w": None}})
    ref_multi = RefMulti({"tpu-v5e": {"time_us": fits[1], "power_w": None}})
    yield multi, ref_multi
    multi.close()
    ref_multi.close()


def _graduate(sup_mod, tr, store_cls, sample_cls, monitor_cls, pool_cls,
              frontend_cls, multi, engine_cfg, rows):
    """The supervisor smoke's feed, chunk by chunk: returns the chunk at
    which the device graduated, its stats and the served eval answers."""
    Xp, yp, Xe, _ = rows
    mon = monitor_cls(alpha=0.3)
    tp = tr.TransferPredictor(DEV, monitor=mon, config=tr.TransferConfig(
        min_samples_leaf=4, shrinkage=32.0))
    store = store_cls()
    pool = pool_cls({"cold": tp}, check_interval_s=60.0)
    sup = sup_mod.TransferSupervisor(
        store, mon, pool=pool, multi_engine=multi,
        config=sup_mod.SupervisorConfig(min_graduate_samples=48,
                                        plateau_window=3,
                                        engine_config=engine_cfg))
    sup.manage(tp, replica="cold", key=DEV)
    order = tr.select_probes(Xp, len(Xp))
    graduated_at = None
    with frontend_cls(pool, max_queue=64) as fe:
        for k, start in enumerate(range(0, len(order), 8)):
            store.extend([sample_cls(
                app="t", kernel=f"k{j}", variant="s", features=Xp[j],
                targets={DEV: {"time_us": float(yp[j])}})
                for j in order[start:start + 8]])
            if sup.supervise_once()["graduated"] and graduated_at is None:
                graduated_at = k
        served = fe.predict(Xe)
    snap = sup.stats_snapshot()
    return graduated_at, snap, served, mon.series()


def test_supervisor_graduates_at_the_same_step(rows, fitted_multi):
    multi, ref_multi = fitted_multi
    got = _graduate(p_sup, p_tr, DatasetStore, Sample, CalibrationMonitor,
                    ReplicaPool, ClusterFrontend, multi,
                    EngineConfig(backend="tree-walk", cache_size=0,
                                 device="cpu"), rows)
    want = _graduate(r_sup, r_tr, RefStore, RefSample, RefMonitor, RefPool,
                     RefFrontend, ref_multi,
                     RefConfig(backend="tree-walk", cache_size=0), rows)
    assert got[0] is not None and got[0] == want[0]
    assert got[1]["devices"] == want[1]["devices"]
    assert got[1]["devices"][DEV]["stage"] == "forest"
    assert vars(got[1]["stats"]) == vars(want[1]["stats"])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3]
    # graduation admitted the device into both pricing matrices, priced alike
    assert multi.device_names == ref_multi.device_names == ["tpu-v5e", DEV]
    np.testing.assert_array_equal(multi.price(rows[2])[0],
                                  ref_multi.price(rows[2])[0])


def test_add_device_copies_and_rebinds(fitted_multi):
    """add_device replaces the tables (a pricing call iterating the old
    ones sees a consistent matrix) and refuses a name already priced."""
    multi, _ = fitted_multi
    engines, counts = multi.engines, multi.counts
    eng = multi.engines["tpu-v5e"]["time_us"]
    multi.add_device("twin", eng, count=2, freq_scale=0.5,
                     freq_grid=(0.5, 1.0))
    assert multi.engines is not engines and multi.counts is not counts
    assert "twin" not in engines and "twin" not in counts
    assert multi.counts["twin"] == 2 and multi.freq_scales["twin"] == 0.5
    assert multi.freq_grids["twin"] == (0.5, 1.0)
    with pytest.raises(ValueError, match="already priced"):
        multi.add_device("twin", eng)


def test_supervise_smoke_on_the_cpu():
    assert p_sup.smoke(device="cpu") == 0
