"""Ground-truth collection over the workload suite (paper §4.2): the port of
``repro.workloads.collect``.

Per workload:
  * features from the exported program (``core.features.extract``; recorded
    ONCE — portability; nothing runs inside the export),
  * the device the workload's inputs live on: REAL time, one warm-up call
    then ``repeats`` timed calls, median kept, CoV recorded (paper Fig. 3).
    On a CUDA card each call is timed by CUDA events on the current stream
    and filed under the card's name (``measured_device``); on the host by
    the wall clock, filed under ``cpu-host`` as in the reference,
  * each simulated TPU device model: analytic time (median of noisy draws)
    + power (mean of draws), from the same rng stream as the reference.

Returns a ``repro_torch.core.dataset.Dataset``; cached as JSON under
artifacts/ (``ARTIFACT``, another file than the reference's).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core.dataset import Dataset
from ..core.devices import CPU_HOST, SIMULATED_DEVICES
from ..core.features import FEATURE_NAMES, FeatureVector, LaunchConfig, extract
from ..core.forest_torch import resolve_device
from ..core.power import simulate_power_mean_w
from ..core.simulate import WorkloadSpec, simulate_time_median_us
from .suite import Workload, suite

ARTIFACT = (Path(__file__).resolve().parents[3] / "artifacts"
            / "suite_dataset_torch.json")
# the port's dry-run records (launch/dryrun.py)
DRYRUN_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


@dataclass
class CollectStats:
    """Totals over the workloads measured since the caller last set
    ``collect.stats = CollectStats()``, as the kernel wrappers count their
    launches: seconds exporting, seconds measuring, and the dynamo graphs
    compiled inside timed repeats, by ``app/kernel/variant`` (the suite's
    scans compile on their first call; the warm-up call must absorb that,
    since one compile inside the repeats is an outlier the median hides)."""
    export_s: float = 0.0
    measure_s: float = 0.0
    timed_compiles: dict = field(default_factory=dict)


stats = CollectStats()


def measured_device(device) -> str:
    """The target name a measurement on ``device`` is filed under:
    ``cpu-host`` on the host, as in the reference; on a card its name,
    lower-cased, spaces as ``-`` (``nvidia-h100-80gb-hbm3``)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CPU_HOST.name
    return torch.cuda.get_device_name(dev).lower().replace(" ", "-")


def _device_of(args) -> torch.device:
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                torch.device("cpu"))


def _measure(fn, args, repeats: int) -> tuple[float, float, int]:
    """One warm-up call, then ``repeats`` timed calls of ``fn(*args)`` on the
    device ``args`` live on: (median us, CoV = std / mean, dynamo graphs
    compiled inside the timed calls).

    On a CUDA card a call is timed by a pair of CUDA events recorded on the
    current stream around it, then a synchronize on the end event. The
    reading includes the card's idle gaps while the host launches, so it is
    the program's time on the card: the counterpart of the reference's wall
    clock around ``block_until_ready``. On the host: ``time.perf_counter``."""
    from torch._dynamo.utils import counters
    dev = _device_of(args)
    fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    graphs = counters["stats"]["unique_graphs"]
    xs = []
    for _ in range(repeats):
        if dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            fn(*args)
            end.record(stream)
            end.synchronize()
            xs.append(start.elapsed_time(end) * 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            xs.append((time.perf_counter() - t0) * 1e6)
    compiled = counters["stats"]["unique_graphs"] - graphs
    xs = np.asarray(xs)
    return (float(np.median(xs)), float(xs.std() / max(xs.mean(), 1e-9)),
            compiled)


def spec_from_features(fv, work_items: float, n_shards: int = 1) -> WorkloadSpec:
    aux = fv.aux
    return WorkloadSpec(
        flops=max(aux["flops"], 1.0),
        hbm_bytes=max(aux["hbm_bytes"], 1.0),
        collective_bytes=aux["collective_bytes"],
        special_ops=aux["special_ops"],
        control_ops=aux["control_ops"],
        work_items=work_items,
        n_shards=n_shards)


def measure_workload(w: Workload, rng, repeats: int = 10,
                     measure_cpu: bool = True):
    """Features (extracted ONCE from the exported program) + per-device
    targets for ONE workload. Shared by the batch collector below and the
    streaming collector (``workloads/stream.py``): given the same rng state
    it yields identical measurements on the simulated devices, which is what
    makes streamed and batch-collected datasets byte-identical under one
    seed. ``measure_cpu`` (the reference's name) measures the device the
    workload's inputs live on; the timing never touches ``rng``, and each
    simulated device takes the same number of draws whatever the workload,
    so the stream stays aligned with the reference's.
    Returns (FeatureVector, targets dict)."""
    t0 = time.perf_counter()
    fv = extract(w.fn, *w.args, launch=LaunchConfig(work_items=w.work_items))
    t1 = time.perf_counter()
    stats.export_s += t1 - t0
    targets = {}
    if measure_cpu:
        t_us, cov, compiled = _measure(w.fn, w.args, repeats)
        stats.measure_s += time.perf_counter() - t1
        if compiled:
            stats.timed_compiles[f"{w.app}/{w.kernel}/{w.variant}"] = compiled
        targets[measured_device(_device_of(w.args))] = {"time_us": t_us,
                                                        "time_cov": cov}
    spec = spec_from_features(fv, w.work_items)
    for dev in SIMULATED_DEVICES:
        t_us, tcov = simulate_time_median_us(spec, dev, rng, repeats)
        p_w, pcov = simulate_power_mean_w(spec, dev, rng, repeats)
        targets[dev.name] = {"time_us": t_us, "time_cov": tcov,
                             "power_w": p_w, "power_cov": pcov}
    return fv, targets


def collect(workloads: list[Workload] | None = None, repeats: int = 10,
            measure_cpu: bool = True, seed: int = 0,
            progress=None) -> Dataset:
    """The dataset of ``workloads`` (default: the whole suite on the card)."""
    workloads = workloads if workloads is not None else suite()
    ds = Dataset()
    rng = np.random.default_rng(seed)
    for i, w in enumerate(workloads):
        fv, targets = measure_workload(w, rng, repeats, measure_cpu)
        ds.add(w.app, w.kernel, w.variant, fv, targets)
        if progress and (i + 1) % 20 == 0:
            progress(f"  collected {i+1}/{len(workloads)}")
    return ds


def cells_dataset(dryrun_dir: Path | None = None, seed: int = 1,
                  repeats: int = 10) -> Dataset:
    """The 40-cell dry-run programs as predictor samples: their portable
    features were extracted by the port's dry-run (``launch/dryrun.py``
    writes the records to DRYRUN_DIR, never the reference's directory);
    here we attach simulated per-device targets. These are the
    SECONDS-scale samples (train/prefill steps of 0.1B..123B models) that
    extend the dataset's dynamic range to the paper's ~8 orders of
    magnitude. A missing directory gives an empty dataset."""
    dryrun_dir = dryrun_dir or DRYRUN_DIR
    rng = np.random.default_rng(seed)
    ds = Dataset()
    for p in sorted(dryrun_dir.glob("*.json")):
        with open(p) as f:
            rec = json.load(f)
        if rec.get("status") != "ok" or "features" not in rec:
            continue
        vals = np.asarray([rec["features"][n] for n in FEATURE_NAMES])
        fv = FeatureVector(values=vals, aux=rec["feature_aux"])
        arch, shape, mesh, strat = rec["tag"].split("__")
        spec = spec_from_features(fv, fv.aux["work_items"],
                                  n_shards=int(fv.aux["n_shards"]))
        targets = {}
        for dev in SIMULATED_DEVICES:
            t_us, tcov = simulate_time_median_us(spec, dev, rng, repeats)
            p_w, pcov = simulate_power_mean_w(spec, dev, rng, repeats)
            targets[dev.name] = {"time_us": t_us, "time_cov": tcov,
                                 "power_w": p_w, "power_cov": pcov}
        ds.add(f"framework-{arch}", shape, mesh, fv, targets)
    return ds


def load_or_collect(path: Path = ARTIFACT, fast: bool = False,
                    progress=print, include_cells: bool = True) -> Dataset:
    if path.exists():
        return Dataset.load(path)
    sizes = ("s", "m", "l") if fast else ("s", "m", "l", "xl")
    ds = collect(suite(sizes=sizes), repeats=5 if fast else 10,
                 progress=progress)
    if include_cells:
        ds.samples.extend(cells_dataset().samples)
    ds.save(path)
    return ds
