"""Analytic execution-time model per device model (SIMULATED HARDWARE GATE).

Produces the *ground-truth* execution times for the five simulated TPU device
models (the paper measured its five GPUs). A copy of ``repro.core.simulate``:
the same spec and rng state give the same draws under both packages. The
model is deliberately richer than the 12 hardware-independent features the
random forest sees — it consumes exact FLOP/byte counts, per-shard
parallelism, and op-mix ratios, applies a non-linear utilization curve, an
imperfect compute/memory overlap, a latency floor, and noise whose
coefficient of variation grows for short kernels (reproducing paper Fig. 3).
The RF must therefore *learn* the mapping, as in the paper; nothing is
trivially linear in its inputs.

``AnalyticalBaseline`` is the static analytical-model baseline (paper §7.2's
PPT-GPU comparison and Table 1 "AM" rows): a plain roofline estimate from the
same hardware-independent features the RF uses. Its MAPE is reported next to
the RF's in ``benchmarks/bench_analytical_baseline.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .devices import DeviceModel

# throughput derating per instruction class, relative to peak MACs
SPECIAL_OP_COST = 8.0       # transcendental ops run on slower pipes
LOGIC_OP_COST = 1.0
CONTROL_OP_COST = 4.0       # scalar unit / sequencing overhead


@dataclass(frozen=True)
class WorkloadSpec:
    """Hardware-independent description handed to the simulator.

    These come from the feature extractor's *aux* channel — exact counts the
    simulator (the 'physical device') is allowed to see, unlike the model.
    """
    flops: float               # total useful FLOPs
    hbm_bytes: float           # bytes moved to/from device memory
    collective_bytes: float    # bytes over interconnect
    special_ops: float         # transcendental op count (dynamic)
    control_ops: float
    work_items: float          # parallel work items (e.g. rows/tokens)
    n_shards: int = 1          # devices participating


def utilization_saturation(device: DeviceModel) -> float:
    """Work items at which a device reaches half of peak utilization —
    the single constant behind :func:`utilization`, exposed so the fitted
    analytical model (``core.transfer``) can seed its occupancy-term priors
    from the same curve the simulator applies."""
    return 5e3 * (device.peak_flops / 1e12)


def utilization(work_items: float, device: DeviceModel) -> float:
    """SM/MXU occupancy analogue: small kernels cannot fill the chip.

    Saturates at 1 with ~1M parallel work items per TFLOP/s of peak —
    mirrors the paper's finding that threads/CTA dominates prediction."""
    sat = utilization_saturation(device)
    u = work_items / (work_items + sat)
    return 0.02 + 0.98 * u


def simulate_time_us(
    spec: WorkloadSpec, device: DeviceModel, rng: np.random.Generator | None,
    freq: float = 1.0,
) -> float:
    """One 'measurement' of the workload on the simulated device (us).

    ``freq`` pins the CORE clock to a DVFS operating point relative to
    nominal (``device.freq_grid``): compute throughput scales with the core
    clock, memory bandwidth does not (the memory clock is a separate domain
    — Wang & Chu, arXiv:1701.05308), so the observed slowdown at reduced
    frequency is sub-linear for memory-bound kernels. Ground truth only; the
    predictor's pricing assumes the conservative t ∝ 1/f.
    """
    per_shard = max(spec.n_shards, 1)
    flops = spec.flops / per_shard
    bts = spec.hbm_bytes / per_shard
    u = utilization(spec.work_items / per_shard, device)

    eff_flops = flops + SPECIAL_OP_COST * spec.special_ops / per_shard \
        + CONTROL_OP_COST * spec.control_ops / per_shard
    t_comp = eff_flops / (device.peak_flops * u * max(freq, 1e-6))
    t_mem = bts / (device.hbm_bw * (0.55 + 0.45 * u))
    t_coll = spec.collective_bytes / max(device.ici_bw, 1.0) if spec.n_shards > 1 else 0.0

    # imperfect overlap: dominant term + 30 % of the others
    terms = sorted([t_comp, t_mem, t_coll], reverse=True)
    t = terms[0] + 0.3 * (terms[1] + terms[2])
    t_us = t * 1e6 + device.latency_floor_us

    if rng is not None:
        # DVFS wander (consumer devices): one frequency draw per measurement
        if device.freq_jitter > 0:
            t_us *= 1.0 / rng.uniform(1.0 - device.freq_jitter,
                                      1.0 + device.freq_jitter)
        # measurement noise: CoV shrinks with duration (paper Fig. 3)
        cov = min(0.02 + 0.6 / np.sqrt(max(t_us, 1.0)), 0.5)
        t_us *= float(np.exp(rng.normal(0.0, cov)))
    return float(t_us)


def simulate_time_median_us(
    spec: WorkloadSpec, device: DeviceModel, rng: np.random.Generator,
    repeats: int = 10, freq: float = 1.0,
) -> tuple[float, float]:
    """Paper §4.2.1: measurements are repeated 10x; the median becomes the
    sample. Returns (median_us, coefficient_of_variation)."""
    xs = np.asarray([simulate_time_us(spec, device, rng, freq)
                     for _ in range(repeats)])
    return float(np.median(xs)), float(xs.std() / xs.mean())


def roofline_columns(X: np.ndarray) -> dict[str, np.ndarray]:
    """The feature columns every analytical (roofline-style) predictor
    consumes, extracted once by FEATURE_NAMES position. Shared by the
    static :class:`AnalyticalBaseline` and the hardware-FITTED model in
    ``core.transfer`` so the two can never disagree about which portable
    feature feeds which physical term."""
    from .features import FEATURE_NAMES
    X = np.asarray(X, dtype=np.float64)
    i = {n: j for j, n in enumerate(FEATURE_NAMES)}
    return {
        "arith": X[:, i["arith_ops"]],
        "special": X[:, i["special_ops"]],
        "control": X[:, i["control_ops"]],
        "gvol": X[:, i["global_mem_vol"]],
        "work": X[:, i["work_per_shard"]],
    }


class AnalyticalBaseline:
    """Static roofline predictor from the RF's own features (no learning).

    Features follow repro.core.features.FEATURE_NAMES ordering. This is the
    'AM' baseline: it knows the device peak numbers but none of the
    empirical non-linearities, so it underperforms the learned model on
    heterogeneous workloads — the paper's §7.2 observation.

    ``core.transfer.FittedAnalyticalModel`` is this model with the spec
    constants promoted to least-squares-fitted coefficients (plus occupancy
    terms) — the cold-start tier's day-zero prior reproduces this baseline.
    """

    def __init__(self, device: DeviceModel):
        self.device = device

    def predict(self, X: np.ndarray) -> np.ndarray:
        c = roofline_columns(X)
        t_comp = (c["arith"] + SPECIAL_OP_COST * c["special"]) \
            / self.device.peak_flops
        t_mem = c["gvol"] / self.device.hbm_bw
        return (np.maximum(t_comp, t_mem)) * 1e6 + self.device.latency_floor_us
