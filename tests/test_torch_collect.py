"""The port's ground-truth collection (``repro_torch.workloads.collect``)
against the reference's: the simulator's inputs, the rng discipline over
the whole suite, real exports side by side, the measurement on the host,
the dry-run cells and the dataset cache."""
import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import jax  # noqa: F401  (the reference's package imports it)
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import is_fake

from repro.core.dataset import FEATURE_NAMES
from repro.workloads import collect as r_collect
from repro.workloads.suite import suite as r_suite
from repro_torch.core.dataset import Dataset
from repro_torch.core.features import FeatureVector
from repro_torch.workloads import collect as p_collect
from repro_torch.workloads.suite import Workload
from repro_torch.workloads.suite import suite as p_suite

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "suite_dataset_v1.json"
SIM_INPUTS = ("flops", "hbm_bytes", "collective_bytes", "special_ops",
              "control_ops")


@pytest.fixture(scope="module")
def fixture_records():
    return json.loads(FIXTURE.read_text())


def _sim_inputs(aux):
    return tuple(aux[k] for k in SIM_INPUTS)


@pytest.mark.parametrize("n_shards", [1, 4])
def test_spec_from_features_equal(fixture_records, n_shards):
    for rec in fixture_records:
        fv = SimpleNamespace(aux=rec["aux"])
        got = p_collect.spec_from_features(fv, rec["aux"]["work_items"],
                                           n_shards)
        want = r_collect.spec_from_features(fv, rec["aux"]["work_items"],
                                            n_shards)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), rec["kernel"]


def test_collect_reproduces_fixture_targets(fixture_records, monkeypatch):
    """The port's collect with the fixture's own features in place of its
    exports reproduces every target of all 328 records: the simulated
    devices in the reference's order, each drawing from one rng stream."""
    ws = p_suite(device="cpu")
    by_key = {(r["app"], r["kernel"], r["variant"]): r
              for r in fixture_records}
    lookup = {tuple(id(a) for a in w.args): by_key[(w.app, w.kernel,
                                                     w.variant)]
              for w in ws}

    def fixture_extract(fn, *args, launch=None):
        rec = lookup[tuple(id(a) for a in args)]
        return FeatureVector(values=np.asarray(rec["features"]),
                             aux=dict(rec["aux"]))

    monkeypatch.setattr(p_collect, "extract", fixture_extract)
    ds = p_collect.collect(ws, measure_cpu=False, seed=0)
    assert len(ds.samples) == len(fixture_records) == 328
    for s, rec in zip(ds.samples, fixture_records):
        assert (s.app, s.kernel, s.variant) == (rec["app"], rec["kernel"],
                                                rec["variant"])
        assert s.targets == rec["targets"], s.group


# gemm, 2mm, syrk and triad give the simulator the reference's five inputs
# at size s; atax does not (the walker's hbm_bytes is 66048 against the
# reference's 67072), and it sits between them so that the workloads after
# it show the rng stream still aligned
COLLECTED = ("gemm", "atax", "2mm", "syrk", "triad")
EQUAL_INPUTS = {"gemm", "2mm", "syrk", "triad"}


def _pick(ws):
    by_kernel = {w.kernel: w for w in ws}
    return [by_kernel[k] for k in COLLECTED]


def test_collect_equals_reference_where_inputs_equal():
    port = p_collect.collect(_pick(p_suite(sizes=("s",), device="cpu")),
                             measure_cpu=False, seed=0)
    ref = r_collect.collect(_pick(r_suite(sizes=("s",))), measure_cpu=False,
                            seed=0)
    equal, gaps = set(), {}
    for p, r in zip(port.samples, ref.samples):
        assert (p.app, p.kernel, p.variant) == (r.app, r.kernel, r.variant)
        assert list(p.targets) == list(r.targets)
        pi, ri = _sim_inputs(p.aux), _sim_inputs(r.aux)
        if pi == ri:
            equal.add(p.kernel)
            assert p.targets == r.targets, p.kernel
        else:
            gaps[p.kernel] = {k: (a, b) for k, a, b in zip(SIM_INPUTS, pi, ri)
                              if a != b}
    assert equal >= EQUAL_INPUTS, gaps
    assert set(gaps) <= set(COLLECTED) - EQUAL_INPUTS, gaps


def test_measure_on_the_host():
    calls = []

    def fn(a):
        if not is_fake(a):                 # the export traces on fake tensors
            calls.append(1)
        return (a * 2.0 + 1.0).sum(dim=1)

    a = torch.arange(64.0).reshape(16, 4)
    w = Workload("toy", "k", "n16", fn, (a,), 16.0)
    rng = np.random.default_rng(0)
    fv, targets = p_collect.measure_workload(w, rng, repeats=4,
                                             measure_cpu=True)
    assert p_collect.measured_device("cpu") == "cpu-host"
    host = targets["cpu-host"]
    assert set(host) == {"time_us", "time_cov"}
    assert host["time_us"] > 0 and host["time_cov"] >= 0
    assert len(calls) == 4 + 1
    assert list(targets) == ["cpu-host", "tpu-v5e", "tpu-v4", "tpu-v5p",
                             "tpu-v6e", "edge-dvfs"]
    # the timing leaves the rng alone: the same draws as without it
    _, plain = p_collect.measure_workload(w, np.random.default_rng(0),
                                          repeats=4, measure_cpu=False)
    assert {k: v for k, v in targets.items() if k != "cpu-host"} == plain


def _dryrun_record(i, status="ok"):
    rng = np.random.default_rng(i)
    aux = {"flops": float(rng.integers(1, 10**12)),
           "hbm_bytes": float(rng.integers(1, 10**10)),
           "io_bytes": 1e6, "collective_bytes": float(rng.integers(0, 10**8)),
           "special_ops": float(rng.integers(0, 10**6)),
           "control_ops": float(rng.integers(0, 10**3)), "mem_move": 0.0,
           "work_items": float(rng.integers(1, 10**6)),
           "n_shards": int(rng.choice([1, 4, 16]))}
    return {"tag": f"arch{i}__train_4k__mesh{i}__2d", "status": status,
            "features": {n: float(rng.lognormal(5, 3)) for n in FEATURE_NAMES},
            "feature_aux": aux}


def test_cells_dataset_equal(tmp_path):
    for i in range(4):
        (tmp_path / f"c{i}.json").write_text(json.dumps(_dryrun_record(i)))
    (tmp_path / "failed.json").write_text(
        json.dumps(_dryrun_record(9, status="error")))
    no_features = _dryrun_record(10)
    del no_features["features"]
    (tmp_path / "partial.json").write_text(json.dumps(no_features))
    got = p_collect.cells_dataset(tmp_path)
    want = r_collect.cells_dataset(tmp_path)
    assert len(got) == len(want) == 4
    assert ([s.to_json() for s in got.samples]
            == [s.to_json() for s in want.samples])
    assert len(p_collect.cells_dataset(tmp_path / "missing")) == 0


def test_load_or_collect_loads_an_existing_path(tmp_path):
    ds = Dataset.load(FIXTURE)
    ds.samples = ds.samples[:5]
    path = tmp_path / "ds.json"
    ds.save(path)
    got = p_collect.load_or_collect(path)
    assert [s.to_json() for s in got.samples] == [s.to_json()
                                                  for s in ds.samples]
    assert p_collect.ARTIFACT != r_collect.ARTIFACT
    assert p_collect.ARTIFACT.parent == r_collect.ARTIFACT.parent
