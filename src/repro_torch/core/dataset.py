"""Sample store for training/evaluating the predictor (paper §4).

A ``Sample`` is one (workload kernel, problem size, launch config) with its
hardware-independent feature vector (recorded ONCE — portability, paper §3.1)
and per-device ground-truth targets (time in us, power in W — re-measured per
device).

Includes the paper's §4.2.3 over-representation control: at most
``max_per_group`` samples per (application, kernel) group are kept, selected
randomly (the paper uses a threshold of 100). The selection is DETERMINISTIC
per group: each group's kept subset depends only on (seed, group name, the
group's members in arrival order) — never on other groups or on how the
samples were chunked into appends. That property is what lets the streaming
collector (``workloads/stream.py``) and the batch collector produce
byte-identical capped datasets, and lets every ``DatasetStore.snapshot()``
be reproducible from (seed, append history).

``Dataset`` is the plain in-memory list (training / benchmarks);
``DatasetStore`` is the thread-safe, versioned, append-only front the
streaming pipeline writes into and the serving refresher snapshots from.
"""
from __future__ import annotations

import json
import threading
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .features import FEATURE_NAMES, FeatureVector


@dataclass
class Sample:
    app: str                       # application/benchmark name (e.g. "gemm")
    kernel: str                    # kernel within the app
    variant: str                   # problem-size tag
    features: np.ndarray           # (N_FEATURES,)
    aux: dict = field(default_factory=dict)
    # per-device: {"tpu-v5e": {"time_us": .., "time_cov": .., "power_w": ..,
    #              "power_cov": ..}, ...}
    targets: dict = field(default_factory=dict)

    @property
    def group(self) -> str:
        return f"{self.app}/{self.kernel}"

    def to_json(self) -> dict:
        return dict(app=self.app, kernel=self.kernel, variant=self.variant,
                    features=self.features.tolist(), aux=self.aux,
                    targets=self.targets)

    @staticmethod
    def from_json(d: dict) -> "Sample":
        return Sample(app=d["app"], kernel=d["kernel"], variant=d["variant"],
                      features=np.asarray(d["features"], dtype=np.float64),
                      aux=d.get("aux", {}), targets=d.get("targets", {}))

    @staticmethod
    def from_feature_vector(app: str, kernel: str, variant: str,
                            fv: FeatureVector,
                            targets: dict | None = None) -> "Sample":
        return Sample(app=app, kernel=kernel, variant=variant,
                      features=np.asarray(fv.values, dtype=np.float64),
                      aux=dict(fv.aux), targets=targets or {})


def cap_overrepresented(samples: list[Sample], max_per_group: int = 100,
                        seed: int = 0) -> list[Sample]:
    """Paper §4.2.3 threshold with per-group deterministic selection.

    Each over-represented group draws its kept subset from an rng seeded by
    (seed, crc32(group name)), over the group's members in arrival order —
    independent of every other group and of append chunking. Kept members
    stay in arrival order.
    """
    by_group: dict[str, list[Sample]] = {}
    for s in samples:
        by_group.setdefault(s.group, []).append(s)
    out: list[Sample] = []
    for group, members in by_group.items():
        if len(members) > max_per_group:
            rng = np.random.default_rng(
                [seed, zlib.crc32(group.encode("utf-8"))])
            idx = rng.choice(len(members), size=max_per_group, replace=False)
            members = [members[i] for i in sorted(idx)]
        out.extend(members)
    return out


@dataclass
class Dataset:
    samples: list[Sample] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.samples)

    def add(self, app: str, kernel: str, variant: str, fv: FeatureVector,
            targets: dict | None = None) -> Sample:
        s = Sample.from_feature_vector(app, kernel, variant, fv, targets)
        self.samples.append(s)
        return s

    def devices(self) -> list[str]:
        devs: set[str] = set()
        for s in self.samples:
            devs.update(s.targets)
        return sorted(devs)

    def matrix(self, device: str, target: str = "time_us",
               ) -> tuple[np.ndarray, np.ndarray, list[Sample]]:
        """Feature matrix + target vector for one device. Drops samples
        without that device's measurement."""
        rows, ys, kept = [], [], []
        for s in self.samples:
            t = s.targets.get(device)
            if t is None or target not in t:
                continue
            rows.append(s.features)
            ys.append(t[target])
            kept.append(s)
        if not rows:
            return (np.zeros((0, len(FEATURE_NAMES))), np.zeros((0,)), [])
        return np.stack(rows), np.asarray(ys, dtype=np.float64), kept

    def reduce_overrepresented(self, max_per_group: int = 100,
                               seed: int = 0) -> "Dataset":
        """Paper §4.2.3: random threshold per (app, kernel) group
        (deterministic per group — see ``cap_overrepresented``)."""
        return Dataset(samples=cap_overrepresented(
            self.samples, max_per_group=max_per_group, seed=seed))

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump([s.to_json() for s in self.samples], f)
        tmp.replace(path)

    @staticmethod
    def load(path: str | Path) -> "Dataset":
        with open(path) as f:
            return Dataset(samples=[Sample.from_json(d) for d in json.load(f)])

    def stats(self, device: str) -> dict:
        """Dataset statistics (paper Fig. 2: execution-time histogram)."""
        _, y, _ = self.matrix(device, "time_us")
        if y.size == 0:
            return {}
        log_edges = np.logspace(0, 8, 17)
        hist, _ = np.histogram(y, bins=log_edges)
        return dict(
            n=int(y.size), min_us=float(y.min()), max_us=float(y.max()),
            median_us=float(np.median(y)),
            orders_of_magnitude=float(np.log10(y.max() / max(y.min(), 1e-9))),
            hist_log10_bins=hist.tolist(),
        )


# ---------------------------------------------------------- streaming store

@dataclass(frozen=True)
class DatasetSnapshot:
    """Immutable view handed to trainers/refreshers: the capped dataset plus
    the store version it was cut at (the serving generation's provenance)."""
    version: int
    dataset: Dataset
    n_total: int                   # samples in the store BEFORE the cap


class DatasetStore:
    """Thread-safe, versioned, append-only sample store.

    The streaming collector appends measured samples (each append bumps
    ``version``); the refresher cuts ``snapshot()``s — capped via
    ``cap_overrepresented`` so no group dominates no matter how long the
    stream runs. Snapshots at the same version are cached and shared
    (samples are treated as immutable once appended).
    """

    def __init__(self, max_per_group: int | None = 100, seed: int = 0,
                 samples: list[Sample] | None = None,
                 version: int | None = None):
        self.max_per_group = max_per_group
        self.seed = seed
        self._lock = threading.Lock()
        self._samples: list[Sample] = list(samples or [])
        # ``version`` restores a store to an EXACT historical version (the
        # durable-recovery path, cluster/persist.py): every version the
        # store ever reported stays valid after a crash+replay, so a
        # refresher's last_version bookkeeping survives the restart.
        if version is not None:
            if version < 0 or (version == 0 and self._samples):
                raise ValueError(f"invalid restore version {version} "
                                 f"for {len(self._samples)} samples")
            self._version = version
        else:
            self._version = 1 if self._samples else 0
        self._snap: DatasetSnapshot | None = None

    @classmethod
    def from_dataset(cls, ds: Dataset, *, max_per_group: int | None = 100,
                     seed: int = 0) -> "DatasetStore":
        return cls(max_per_group=max_per_group, seed=seed,
                   samples=list(ds.samples))

    @property
    def version(self) -> int:
        return self._version

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def append(self, sample: Sample) -> int:
        """Add one sample; returns the new store version."""
        return self.extend([sample])

    def raw(self) -> tuple[list[Sample], int]:
        """Atomic (uncapped samples copy, version) — the store's exact
        replayable state, what the durable tier checkpoints (the CAPPED
        view is ``snapshot()``; capping at persist time would lose samples
        a later, larger cap could legitimately keep)."""
        with self._lock:
            return list(self._samples), self._version

    def extend(self, samples: list[Sample]) -> int:
        samples = list(samples)
        with self._lock:
            if samples:
                self._samples.extend(samples)
                self._version += 1
            return self._version

    def snapshot(self) -> DatasetSnapshot:
        """Capped, immutable dataset at the current version. Deterministic:
        the same (seed, append history) always yields the same snapshot."""
        with self._lock:
            if self._snap is not None and self._snap.version == self._version:
                return self._snap
            version = self._version
            samples = list(self._samples)
        kept = (samples if self.max_per_group is None else
                cap_overrepresented(samples, max_per_group=self.max_per_group,
                                    seed=self.seed))
        snap = DatasetSnapshot(version=version, dataset=Dataset(samples=kept),
                               n_total=len(samples))
        with self._lock:
            # a concurrent append may have advanced the version; only cache
            # a snapshot that is still current
            if version == self._version:
                self._snap = snap
        return snap

    def save(self, path: str | Path) -> DatasetSnapshot:
        snap = self.snapshot()
        snap.dataset.save(path)
        return snap
