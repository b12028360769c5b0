"""Power-consumption model (SIMULATED HARDWARE GATE — DESIGN.md §6).

The paper measures board power via nvidia-smi while looping the kernel for
>= 1 s (its sensor sampling frequencies f_s are in Table 3). The simulated
devices have no power sensor, so ground-truth power is produced by a
utilization-mix model:

    P = P_idle + (P_peak - P_idle) * (a*u_compute + b*u_memory + c*mix) * f^α

plus small multiplicative noise (the paper observed CoV < 5 %, Fig. 4).
Power depends mostly on *utilization* (the paper's top features: threads/CTA,
CTAs, param vol) and only weakly on the exact op mix, which is why the paper
— and our reproduction — find power far easier to predict than time (MAPE
~2 % vs ~9-52 %). Note the DVFS device stays power-predictable: frequency
wander cancels in the utilization ratio, as the paper found for the GTX1650.

DVFS (``f`` above, an ``OperatingPoint`` on ``DeviceModel.freq_grid``): only
the DYNAMIC part of board power scales with the core clock, and the true
exponent ``DVFS_ALPHA`` is below the textbook cubic f·V² law — Wang & Chu
(arXiv:1701.05308) measured fitted exponents well under 3 on real GPUs, and
a large idle/static floor besides. ``PowerSplit`` is the predictor-side
model of that shape:

    P(f) / P(1) = idle_frac + (1 - idle_frac) * f^alpha

``fit_power_split`` FITS (idle_frac, alpha) from frequency-sweep samples of
the EDGE_DVFS device (``collect_dvfs_samples``) instead of assuming the
cubic law; ``CUBIC_SPLIT`` is the assumed-cubic baseline it must beat
(asserted in ``tests/test_dvfs.py``). The scheduler prices every operating
point through whichever split the caller wires in.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .devices import EDGE_DVFS, DeviceModel
from .simulate import SPECIAL_OP_COST, WorkloadSpec, utilization

W_COMPUTE = 0.58
W_MEMORY = 0.27
W_MIX = 0.15

#: Ground-truth dynamic-power frequency exponent. Deliberately NOT 3.0:
#: real boards show sub-cubic scaling (voltage does not track frequency
#: linearly over the whole DVFS range), which is exactly why a FITTED split
#: beats the assumed cubic law.
DVFS_ALPHA = 2.4


def simulate_power_w(
    spec: WorkloadSpec, device: DeviceModel, rng: np.random.Generator | None,
    freq: float = 1.0,
) -> float:
    per_shard = max(spec.n_shards, 1)
    flops = spec.flops / per_shard
    bts = spec.hbm_bytes / per_shard
    u = utilization(spec.work_items / per_shard, device)

    t_comp = (flops + SPECIAL_OP_COST * spec.special_ops / per_shard) / device.peak_flops
    t_mem = bts / device.hbm_bw
    t_tot = max(t_comp + 0.0, t_mem, 1e-12)
    u_compute = u * min(t_comp / max(t_comp, t_mem), 1.0)
    u_memory = min(t_mem / max(t_comp, t_mem), 1.0)
    # op-mix term: transcendental-heavy kernels burn hotter pipes
    mix = min(SPECIAL_OP_COST * spec.special_ops / max(flops, 1.0), 1.0)

    # only the dynamic part scales with the core clock (sub-cubic, see
    # DVFS_ALPHA); the idle/static floor does not
    p = device.idle_w + (device.peak_w - device.idle_w) * (
        W_COMPUTE * u_compute + W_MEMORY * u_memory + W_MIX * mix
    ) * freq ** DVFS_ALPHA

    if rng is not None:
        p *= float(np.exp(rng.normal(0.0, 0.015)))   # CoV ~1.5 % (paper Fig. 4)
    return float(min(max(p, device.idle_w), device.peak_w * 1.05))


def simulate_power_mean_w(
    spec: WorkloadSpec, device: DeviceModel, rng: np.random.Generator,
    repeats: int = 10, freq: float = 1.0,
) -> tuple[float, float]:
    """Paper §4.2.2: power measurements repeated 10x and averaged."""
    xs = np.asarray([simulate_power_w(spec, device, rng, freq)
                     for _ in range(repeats)])
    return float(xs.mean()), float(xs.std() / xs.mean())


# --------------------------------------------------------- DVFS power split

@dataclass(frozen=True)
class PowerSplit:
    """Predictor-side DVFS power model: P(f) = P(1) * scale(f).

    ``idle_frac`` is the share of nominal board power that does NOT scale
    with the core clock (static/idle); ``alpha`` is the dynamic exponent.
    ``CUBIC_SPLIT`` (idle_frac=0, alpha=3) reproduces the legacy assumed
    P ∝ f³ pricing exactly.
    """

    idle_frac: float
    alpha: float

    def scale(self, f):
        """Relative power at operating point ``f`` (scalar or array)."""
        return self.idle_frac + (1.0 - self.idle_frac) * f ** self.alpha

    def scale_power(self, p_nominal, f):
        return p_nominal * self.scale(f)


CUBIC_SPLIT = PowerSplit(idle_frac=0.0, alpha=3.0)


def split_rmse(split: PowerSplit, freqs: np.ndarray,
               ratios: np.ndarray) -> float:
    """RMSE of a split against observed P(f)/P(1) sweep samples."""
    freqs = np.asarray(freqs, dtype=np.float64)
    ratios = np.asarray(ratios, dtype=np.float64)
    return float(np.sqrt(np.mean((split.scale(freqs) - ratios) ** 2)))


def fit_power_split(freqs: np.ndarray, ratios: np.ndarray,
                    alphas: np.ndarray | None = None
                    ) -> tuple[PowerSplit, float]:
    """Fit (idle_frac, alpha) to frequency-sweep samples; returns
    (split, rmse).

    ``freqs``/``ratios`` are flat sample arrays of operating point f and
    observed P(f)/P(1). For each candidate alpha the idle fraction has a
    closed-form least-squares solution (the model is linear in idle_frac);
    alpha itself is swept over a grid. Idle is clamped to [0, 0.95] — a
    board whose power does not drop at all with frequency is a sensor
    artifact, not a model.
    """
    freqs = np.asarray(freqs, dtype=np.float64)
    ratios = np.asarray(ratios, dtype=np.float64)
    if freqs.shape != ratios.shape or freqs.size < 2:
        raise ValueError("need matched freq/ratio sample arrays (>= 2)")
    if alphas is None:
        alphas = np.linspace(1.0, 4.0, 61)
    best: tuple[float, PowerSplit] | None = None
    for a in alphas:
        fa = freqs ** a
        denom = float(np.sum((1.0 - fa) ** 2))
        if denom < 1e-12:            # all samples at f=1: idle unidentifiable
            idle = 0.0
        else:
            idle = float(np.sum((ratios - fa) * (1.0 - fa)) / denom)
        idle = min(max(idle, 0.0), 0.95)
        split = PowerSplit(idle_frac=idle, alpha=float(a))
        err = split_rmse(split, freqs, ratios)
        if best is None or err < best[0]:
            best = (err, split)
    return best[1], best[0]


def collect_dvfs_samples(specs: list[WorkloadSpec],
                         device: DeviceModel = EDGE_DVFS,
                         freqs: tuple[float, ...] | None = None,
                         seed: int = 0, repeats: int = 5
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Frequency-sweep power samples for ``fit_power_split``.

    Pins the device to each operating point of its ``freq_grid`` (or an
    explicit ``freqs``), measures mean power per spec (the §4.2.2 repeated
    measurement), and normalizes by the same spec's nominal-clock power.
    Returns flat (freqs, ratios) arrays — the "EDGE_DVFS samples" the
    fitted split is learned from.
    """
    if freqs is None:
        freqs = device.freq_grid
    rng = np.random.default_rng(seed)
    out_f, out_r = [], []
    for spec in specs:
        p1, _ = simulate_power_mean_w(spec, device, rng, repeats, freq=1.0)
        for f in freqs:
            pf, _ = simulate_power_mean_w(spec, device, rng, repeats, freq=f)
            out_f.append(f)
            out_r.append(pf / max(p1, 1e-9))
    return np.asarray(out_f), np.asarray(out_r)
