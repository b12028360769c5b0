"""Streaming ground-truth collection (the async half of the serving loop):
a copy of ``repro.workloads.stream`` over the port's ``collect`` and
``suite`` (whose default workloads live on the card).

``collect()`` is one-shot: measure everything, then fit, then serve. This
module turns collection into a STREAM so the predictor can refresh while it
serves (ROADMAP: "an async collection pipeline feeding the dataset while
serving"):

  * ``iter_samples`` — a generator yielding one measured ``Sample`` at a
    time. It drives the exact same ``measure_workload`` as the batch
    collector with the same rng discipline, so for a fixed (seed, workload
    order) the streamed samples are byte-identical to ``collect()``'s —
    snapshot determinism falls out for free.
  * ``StreamingCollector`` — a background thread pushing those samples into
    a versioned ``core.dataset.DatasetStore`` in chunks; the serving side
    (``serve/refresh.EngineRefresher``) cuts capped snapshots from the store
    and hot-swaps refreshed forests into the live engines.

    store = DatasetStore(max_per_group=100, seed=0)
    with StreamingCollector(store, suite(sizes=("s",)), chunk_size=8):
        ...  # engines keep serving; refresher keeps them fresh
"""
from __future__ import annotations

import threading
from typing import Callable, Iterator

import numpy as np

from ..core.dataset import DatasetStore, Sample
from .collect import measure_workload
from .suite import Workload, suite

__all__ = ["iter_samples", "StreamingCollector"]


def iter_samples(workloads: list[Workload] | None = None, *,
                 repeats: int = 10, measure_cpu: bool = True,
                 seed: int = 0) -> Iterator[Sample]:
    """Measure workloads one at a time, yielding each finished Sample."""
    workloads = workloads if workloads is not None else suite()
    rng = np.random.default_rng(seed)
    for w in workloads:
        fv, targets = measure_workload(w, rng, repeats, measure_cpu)
        yield Sample.from_feature_vector(w.app, w.kernel, w.variant, fv,
                                         targets)


class StreamingCollector:
    """Measures workloads on a background thread into a ``DatasetStore``.

    ``chunk_size`` batches appends (one store version bump per chunk) so the
    refresher isn't poked on every single measurement; ``throttle_s`` spaces
    measurements out (useful to demo steady-state refresh);
    ``on_chunk(version, n_appended)`` is an optional progress callback fired
    after each append, on the collector thread. ``add_on_chunk`` registers
    FURTHER listeners — one measurement campaign can feed a predictor's
    ``ingest_store`` AND poke a ``serve.supervise.TransferSupervisor``
    without wrapping callbacks by hand. Listeners run in registration
    order; an exception from any of them aborts collection (surfaced via
    ``.error`` / ``run_sync``), same as ``on_chunk`` always has.
    """

    def __init__(self, store: DatasetStore,
                 workloads: list[Workload] | None = None, *,
                 repeats: int = 10, measure_cpu: bool = False, seed: int = 0,
                 chunk_size: int = 1, throttle_s: float = 0.0,
                 on_chunk: Callable[[int, int], None] | None = None):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self.store = store
        self.workloads = workloads if workloads is not None else suite()
        self.repeats = repeats
        self.measure_cpu = measure_cpu
        self.seed = seed
        self.chunk_size = chunk_size
        self.throttle_s = throttle_s
        self.on_chunk = on_chunk
        self._chunk_listeners: list[Callable[[int, int], None]] = []
        self.collected = 0
        self.error: BaseException | None = None
        self.done = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ---------------------------------------------------------------- drive

    def run_sync(self) -> int:
        """Measure everything on the CALLER's thread (tests, scripts);
        returns the number of samples appended."""
        self._run()
        if self.error is not None:
            raise self.error
        return self.collected

    def start(self) -> "StreamingCollector":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self.done.clear()
        self._thread = threading.Thread(
            target=self._run, name="streaming-collector", daemon=True)
        self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        """Stop after the in-flight measurement; pending chunk is flushed."""
        self._stop.set()
        if join and self._thread is not None:
            self._thread.join(timeout=60.0)

    def wait(self, timeout: float | None = None) -> bool:
        return self.done.wait(timeout)

    def __enter__(self) -> "StreamingCollector":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ----------------------------------------------------------------- loop

    def add_on_chunk(self, fn: Callable[[int, int], None]
                     ) -> "StreamingCollector":
        """Register an extra ``(version, n_appended)`` listener (e.g.
        ``supervisor.on_chunk``) alongside the constructor's ``on_chunk``."""
        self._chunk_listeners.append(fn)
        return self

    def _flush(self, buf: list[Sample]) -> None:
        if not buf:
            return
        version = self.store.extend(buf)
        self.collected += len(buf)
        if self.on_chunk is not None:
            self.on_chunk(version, len(buf))
        for fn in self._chunk_listeners:
            fn(version, len(buf))
        buf.clear()

    def _run(self) -> None:
        buf: list[Sample] = []
        try:
            for s in iter_samples(self.workloads, repeats=self.repeats,
                                  measure_cpu=self.measure_cpu,
                                  seed=self.seed):
                if self._stop.is_set():
                    break
                buf.append(s)
                if len(buf) >= self.chunk_size:
                    self._flush(buf)
                if self.throttle_s > 0 and self._stop.wait(self.throttle_s):
                    break
            self._flush(buf)
        except BaseException as exc:     # surfaced via .error / run_sync
            self.error = exc
        finally:
            self.done.set()
