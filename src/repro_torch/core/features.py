"""The hardware-independent feature vector (paper §3.1/§3.2, Table 6).

The port serves the paper's model on features that the reference's
StableHLO walker (``repro.core.features``) extracted. This module holds only
the definitions the serving path needs, copied from there: the 12 feature
names in paper Table 6 order, the ``FeatureVector`` record and the
``LaunchConfig`` analogue. Extraction from a torch IR is a later port
slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FEATURE_NAMES: list[str] = [
    "work_per_shard",      # paper: threads per CTA
    "num_shards",          # paper: CTAs
    "total_instr",
    "arith_ops",
    "special_ops",
    "logic_ops",
    "control_ops",
    "sync_ops",
    "global_mem_vol",
    "param_mem_vol",
    "shared_mem_vol",
    "arith_intensity",
]

N_FEATURES = len(FEATURE_NAMES)


@dataclass
class LaunchConfig:
    """The kernel-launch-configuration analogue (paper §3.1): chosen by the
    caller, independent of hardware."""
    work_items: float = 1.0        # total parallel work items (tokens, rows..)
    n_shards: int = 1              # mesh size the program is launched on
    shared_mem_bytes: float = 0.0  # on-chip block bytes for kernel workloads


@dataclass
class FeatureVector:
    values: np.ndarray                # (N_FEATURES,) float64, paper Table 6 order
    aux: dict                         # exact counts for the simulator/roofline

    def __getitem__(self, name: str) -> float:
        return float(self.values[FEATURE_NAMES.index(name)])

    def as_dict(self) -> dict[str, float]:
        return {n: float(v) for n, v in zip(FEATURE_NAMES, self.values)}
