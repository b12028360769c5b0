"""Device models (paper Table 3 analogue).

A copy of ``repro.core.devices``: the simulated device zoo stays exactly
the reference's, so that simulated datasets and the forests fitted on them
match the reference byte for byte. The paper evaluates five physical NVIDIA
GPUs; the reference's device zoo is:

  * five *simulated* TPU-class device models (a SIMULATED HARDWARE GATE —
    see DESIGN.md §6), including one "edge-dvfs" device with uncontrolled
    frequency that mirrors the paper's consumer-class GTX 1650 finding, and
  * one *real* device, ``cpu-host``, whose execution times are genuinely
    measured wall-clock on the CPU backend.

Constants are modeling constants, documented here, not vendor claims. The
v5e entry matches the roofline constants mandated for §Roofline
(197 TFLOP/s bf16, 819 GB/s HBM, ~50 GB/s/link ICI).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class OperatingPoint:
    """One point on a device's DVFS grid: a core-clock frequency relative to
    the nominal clock the forests were trained at (1.0 = nominal). The
    scheduler chooses one PER ASSIGNMENT (``core/scheduler.schedule``), and
    the cluster tier reports the choice in dispatch results."""

    device: str
    freq: float

    def as_dict(self) -> dict:
        return {"device": self.device, "freq": self.freq}


@dataclass(frozen=True)
class DeviceModel:
    name: str
    clazz: str                 # "server" | "consumer" | "host"
    peak_flops: float          # FLOP/s (bf16 for TPUs, f32 for cpu-host)
    hbm_bw: float              # bytes/s
    ici_bw: float              # bytes/s per link (collectives)
    vmem_bytes: int            # on-chip fast memory per core
    hbm_bytes: int             # device memory capacity
    idle_w: float
    peak_w: float              # TDP analogue
    latency_floor_us: float    # fixed launch/dispatch overhead
    freq_jitter: float         # +- relative frequency wander (DVFS devices)
    sample_hz: float           # power-sensor sampling frequency (paper f_s)
    simulated: bool = True
    # Discrete DVFS operating points the device can be PINNED to, as core
    # clocks relative to nominal. (1.0,) = no frequency control exposed;
    # ``freq_jitter`` models UNCONTROLLED wander around whichever point is
    # chosen. The scheduler selects from this grid per assignment.
    freq_grid: tuple[float, ...] = (1.0,)

    def operating_points(self) -> list[OperatingPoint]:
        return [OperatingPoint(self.name, f) for f in self.freq_grid]


# Server parts expose a coarse power-management grid (a few P-state
# analogues); the consumer EDGE_DVFS part exposes the fine-grained grid a
# GTX-1650-class board would (the paper's DVFS finding, plus Wang & Chu's
# arXiv:1701.05308 frequency sweeps).
SERVER_FREQ_GRID = (0.7, 0.85, 1.0)
EDGE_FREQ_GRID = (0.5, 0.6, 0.7, 0.8, 0.9, 1.0)

TPU_V5E = DeviceModel(
    name="tpu-v5e", clazz="server",
    peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
    vmem_bytes=128 * 2**20, hbm_bytes=16 * 2**30,
    idle_w=55.0, peak_w=200.0, latency_floor_us=12.0,
    freq_jitter=0.0, sample_hz=50.0, freq_grid=SERVER_FREQ_GRID)

TPU_V4 = DeviceModel(
    name="tpu-v4", clazz="server",
    peak_flops=275e12, hbm_bw=1228e9, ici_bw=60e9,
    vmem_bytes=128 * 2**20, hbm_bytes=32 * 2**30,
    idle_w=90.0, peak_w=262.0, latency_floor_us=12.0,
    freq_jitter=0.0, sample_hz=50.0, freq_grid=SERVER_FREQ_GRID)

TPU_V5P = DeviceModel(
    name="tpu-v5p", clazz="server",
    peak_flops=459e12, hbm_bw=2765e9, ici_bw=90e9,
    vmem_bytes=128 * 2**20, hbm_bytes=95 * 2**30,
    idle_w=120.0, peak_w=350.0, latency_floor_us=10.0,
    freq_jitter=0.0, sample_hz=50.0, freq_grid=SERVER_FREQ_GRID)

TPU_V6E = DeviceModel(
    name="tpu-v6e", clazz="server",
    peak_flops=918e12, hbm_bw=1640e9, ici_bw=90e9,
    vmem_bytes=128 * 2**20, hbm_bytes=32 * 2**30,
    idle_w=100.0, peak_w=300.0, latency_floor_us=10.0,
    freq_jitter=0.0, sample_hz=50.0, freq_grid=SERVER_FREQ_GRID)

# Consumer-class analogue of the paper's GTX 1650: no fixed clock. The ±30 %
# frequency wander makes *time* hard to predict (paper: median MAPE 52 %)
# while *power* stays predictable (paper: 2.33 %).
EDGE_DVFS = DeviceModel(
    name="edge-dvfs", clazz="consumer",
    peak_flops=45e12, hbm_bw=128e9, ici_bw=8e9,
    vmem_bytes=32 * 2**20, hbm_bytes=8 * 2**30,
    idle_w=10.0, peak_w=75.0, latency_floor_us=25.0,
    freq_jitter=0.30, sample_hz=10.9, freq_grid=EDGE_FREQ_GRID)

# The one REAL device in this container: single-core x86. peak_flops/hbm_bw
# are used only by the analytical baseline; its times are measured, never
# simulated.
CPU_HOST = DeviceModel(
    name="cpu-host", clazz="host",
    peak_flops=50e9, hbm_bw=20e9, ici_bw=10e9,
    vmem_bytes=32 * 2**20, hbm_bytes=35 * 2**30,
    idle_w=15.0, peak_w=65.0, latency_floor_us=5.0,
    freq_jitter=0.0, sample_hz=1000.0, simulated=False)

DEVICE_MODELS: dict[str, DeviceModel] = {
    d.name: d for d in (TPU_V5E, TPU_V4, TPU_V5P, TPU_V6E, EDGE_DVFS, CPU_HOST)
}

SIMULATED_DEVICES = [d for d in DEVICE_MODELS.values() if d.simulated]

# §Roofline hardware constants (task spec): per-chip v5e numbers.
ROOFLINE_PEAK_FLOPS = 197e12     # bf16 FLOP/s per chip
ROOFLINE_HBM_BW = 819e9          # bytes/s per chip
ROOFLINE_ICI_BW = 50e9           # bytes/s per link
