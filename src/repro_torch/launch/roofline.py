"""Roofline terms of a counted cell (the port of ``repro.launch.roofline``).

    compute term    = counted FLOPs / peak FLOP/s
    memory term     = counted HBM bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

The counts come from ``core/hlo_analysis.py``'s counter, per rank (one run
counts the local ops of one rank), so dividing by one card's peaks gives
the cell's step-time lower bound. The report keeps the library's own count
(``FlopCounterMode``'s, which also counts DTensor's global-shape wrappers)
beside the counter's, as the reference keeps XLA's beside its own.

The constants are NVIDIA's H100 SXM5 data-sheet figures, for the "NVIDIA
H100 80GB HBM3" card at its 700 W limit (not measured): 989.4 TFLOP/s
dense bf16, 3.35 TB/s HBM, 450 GB/s of NVLink 4 in one direction.
``HBM_PER_CHIP`` is what ``torch.cuda.get_device_properties(0)
.total_memory`` reads on that card (``chip_smoke.py`` checks it there).
The reference's v5e constants stay in its ``core/devices.py``.

What the reference reads from XLA:CPU has no torch counterpart:
``cpu_upcast_bytes`` (XLA:CPU's bf16-to-f32 operand copies) is 0, so
``peak_bytes_tpu`` equals ``peak_bytes`` and ``fits_hbm_tpu`` equals
``fits_hbm``. The peak is the counter's live-bytes tally, and
``arg_bytes``, ``out_bytes`` and ``temp_bytes`` split it as
``memory_analysis`` does (peak = arguments + temporaries + outputs).
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass

ROOFLINE_PEAK_FLOPS = 989.4e12     # dense bf16 FLOP/s per card
ROOFLINE_HBM_BW = 3.35e12          # bytes/s per card
ROOFLINE_LINK_BW = 450e9           # bytes/s, NVLink 4, one direction
HBM_PER_CHIP = 85_017_493_504      # total_memory of an H100 80GB HBM3


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    strategy: str
    # per rank, every executed op counted
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collective_breakdown: dict
    # the library's own count (FlopCounterMode), for comparison
    xla_flops: float
    xla_bytes: float
    # the live-bytes tally
    arg_bytes: int
    out_bytes: int
    temp_bytes: int
    peak_bytes: int
    fits_hbm: bool
    # XLA:CPU artefacts, with no torch counterpart (module docstring)
    cpu_upcast_bytes: int = 0
    peak_bytes_tpu: int = 0
    fits_hbm_tpu: bool = True
    # terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    dominant: str = ""
    # usefulness
    model_flops: float = 0.0          # 6ND / 2ND analytic, GLOBAL
    useful_ratio: float = 0.0         # model_flops / (hlo_flops * chips)
    roofline_frac: float = 0.0        # t_ideal_compute / t_bound
    note: str = ""

    def finalize(self, peak_flops: float = ROOFLINE_PEAK_FLOPS,
                 hbm_bw: float = ROOFLINE_HBM_BW,
                 link_bw: float = ROOFLINE_LINK_BW):
        """The terms, the dominant one and the ratios, over the card's
        constants unless others are given."""
        self.t_compute = self.hlo_flops / peak_flops
        self.t_memory = self.hlo_bytes / hbm_bw
        self.t_collective = self.collective_bytes / link_bw
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.dominant = max(terms, key=terms.get)
        total_hlo_flops = self.hlo_flops * self.n_devices
        self.useful_ratio = (self.model_flops / total_hlo_flops
                             if total_hlo_flops else 0.0)
        # fraction of the compute roofline actually achievable given the
        # dominating term: t_useful_compute / max(all terms)
        t_useful = (self.model_flops / self.n_devices) / peak_flops
        bound = max(terms.values())
        self.roofline_frac = t_useful / bound if bound > 0 else 0.0
        return self

    @property
    def t_bound(self) -> float:
        """The step-time lower bound: the largest term, in seconds."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def row(self) -> str:
        return (f"{self.arch},{self.shape},{self.mesh},{self.strategy},"
                f"{self.t_compute*1e3:.2f}ms,{self.t_memory*1e3:.2f}ms,"
                f"{self.t_collective*1e3:.2f}ms,{self.dominant},"
                f"useful={self.useful_ratio:.2f},roofline={self.roofline_frac:.2f},"
                f"mem={self.peak_bytes/2**30:.1f}GiB,fits={self.fits_hbm},"
                f"mem_tpu={self.peak_bytes_tpu/2**30:.1f}GiB,"
                f"fits_tpu={self.fits_hbm_tpu}")


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (fwd+bwd), 2·N·D forward-only.
    MoE uses active params. D = tokens processed by the step."""
    n = cfg.params_active()
    if shape.kind == "train":
        return 6.0 * n * shape.tokens
    if shape.kind == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch          # decode: 1 token per seq


def analyze_cell(costs, *, peak_bytes: int, arg_bytes: int = 0,
                 out_bytes: int = 0, xla_flops: float = 0.0, arch: str,
                 shape, mesh_name: str, n_devices: int, strategy: str,
                 cfg) -> RooflineReport:
    """The report of a cell from the counter's per-rank ``costs``
    (``HloCosts``) and its live-bytes tally, in place of the reference's
    compiled module; ``xla_flops`` is the library's count of the same
    run."""
    peak = int(peak_bytes)
    rep = RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, n_devices=n_devices,
        strategy=strategy,
        hlo_flops=costs.flops, hlo_bytes=costs.hbm_bytes,
        collective_bytes=costs.collective_bytes,
        collective_breakdown=dict(costs.collective_bytes_by_op),
        xla_flops=float(xla_flops), xla_bytes=0.0,
        arg_bytes=int(arg_bytes), out_bytes=int(out_bytes),
        temp_bytes=max(peak - int(arg_bytes) - int(out_bytes), 0),
        peak_bytes=peak, fits_hbm=peak <= HBM_PER_CHIP,
        cpu_upcast_bytes=0, peak_bytes_tpu=peak,
        fits_hbm_tpu=peak <= HBM_PER_CHIP,
        model_flops=model_flops_for(cfg, shape),
    )
    return rep.finalize()


def save_report(rep: RooflineReport, path) -> None:
    from pathlib import Path
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "w") as f:
        json.dump(asdict(rep), f, indent=1)
