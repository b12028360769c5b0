"""Replica management for the cluster serving tier.

A *replica* is one live engine (``ForestEngine``, ``ShardedForestEngine``,
or a ``cluster.remote.RemoteReplica`` fronting an engine in ANOTHER process
or on another machine — anything satisfying ``serve.backend.ServingEngine``)
serving the same fitted forest. ``ReplicaPool`` keeps N of them behind one
routing surface:

  * **health checks** — a background thread periodically times a small probe
    ``predict`` on every replica. A probe failure counts against the
    replica; ``unhealthy_after`` consecutive failures DRAIN it (no new
    traffic). A drained replica keeps being probed and is revived after
    ``revive_after`` consecutive successes, so transient faults heal
    without operator action.
  * **latency-weighted routing** — every observed call (probe or frontend
    dispatch) feeds a bounded latency window per replica; ``pick()`` routes
    to the healthy replica with the lowest ``(in_flight + 1) * p50``
    score, i.e. weighted by observed p50 latency and current load. Ties
    break by name for determinism.
  * **failure reporting** — the frontend reports dispatch failures via
    ``report_failure``; the same consecutive-failure counter drives
    draining, so a replica that dies mid-dispatch stops receiving traffic
    immediately rather than at the next probe tick.
  * **shutdown propagation** — ``close()`` stops the health-check thread,
    stops (and joins) every attached ``EngineRefresher``, and closes every
    engine (which joins its micro-batch flush worker). One call tears the
    whole tier down with no dangling threads — the property
    ``tests/test_cluster.py`` asserts by enumerating live threads.

A copy of ``repro.cluster.replicas``, its imports pointed at the port.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..serve.backend import calibration_rows, supports_deadline

__all__ = ["PoolStats", "Replica", "ReplicaPool"]


@dataclass
class PoolStats:
    probes: int = 0                # health probes attempted
    probe_failures: int = 0
    drains: int = 0                # healthy -> drained transitions
    revivals: int = 0              # drained -> healthy transitions
    reported_failures: int = 0     # dispatch failures reported by callers
    picks: int = 0
    slot_swaps: int = 0            # engines replaced in-place (graduations)


@dataclass
class Replica:
    """One engine plus its observed health/latency state."""

    name: str
    engine: object                 # ServingEngine
    healthy: bool = True
    deadline_aware: bool = False   # predict accepts deadline_s (probes use it)
    slot_generation: int = 0       # bumps on every swap_engine into this slot
    in_flight: int = 0
    consecutive_failures: int = 0
    consecutive_successes: int = 0
    latencies_s: deque = field(default_factory=lambda: deque(maxlen=64))

    def p50_s(self) -> float:
        if not self.latencies_s:
            return 0.0             # unobserved replicas route first
        return float(np.median(self.latencies_s))

    def score(self) -> float:
        # the 1us floor keeps in_flight meaningful for unobserved replicas
        # (a true-zero p50 would tie every cold replica at 0 and pile
        # concurrent dispatches onto the lexicographically first one)
        return (self.in_flight + 1) * max(self.p50_s(), 1e-6)


class ReplicaPool:
    """N engine replicas behind health-checked, latency-weighted routing."""

    def __init__(self, engines: dict[str, object], *,
                 probe_X: np.ndarray | None = None,
                 check_interval_s: float = 0.25,
                 probe_deadline_s: float = 0.25,
                 unhealthy_after: int = 3, revive_after: int = 2):
        if not engines:
            raise ValueError("no replicas")
        if unhealthy_after < 1 or revive_after < 1:
            raise ValueError("unhealthy_after and revive_after must be >= 1")
        self._lock = threading.Lock()
        self.replicas = {
            name: Replica(name, eng,
                          deadline_aware=supports_deadline(
                              getattr(eng, "predict", eng)))
            for name, eng in engines.items()}
        self.check_interval_s = check_interval_s
        # probes against deadline-aware members (remote replicas) carry this
        # deadline so the serving side admits them at a deadlined priority —
        # without it the slack-derived default would queue probes at
        # BACKGROUND, starving the health signal exactly when the server is
        # loaded (and sticky-draining a healthy member under overload)
        self.probe_deadline_s = probe_deadline_s
        self.unhealthy_after = unhealthy_after
        self.revive_after = revive_after
        self.stats = PoolStats()
        self._refreshers: list = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._closed = False
        if probe_X is None:
            # first engine that KNOWS its feature width wins — a remote
            # member whose server is still down reports n_features=None and
            # must not mask an in-process sibling
            n_features = next(
                (eng.n_features for eng in engines.values()
                 if getattr(eng, "n_features", None) is not None), None)
            if n_features is None:
                # probes are the ONLY revival path: a pool that cannot
                # probe would drain replicas permanently and silently
                raise ValueError(
                    "health probing is impossible: no replica exposes "
                    "n_features and no probe_X was given — pass probe_X "
                    "explicitly (a drained replica only revives through "
                    "probes)")
            probe_X = calibration_rows(4, n_features)
        self.probe_X = np.ascontiguousarray(probe_X, dtype=np.float32)

    # ------------------------------------------------------------- routing

    @property
    def names(self) -> list[str]:
        return list(self.replicas)

    def healthy_names(self) -> list[str]:
        with self._lock:
            return [r.name for r in self.replicas.values() if r.healthy]

    def pick(self, exclude: set[str] | frozenset[str] = frozenset()
             ) -> Replica | None:
        """Healthy replica with the best (load x p50) score, or None.

        The caller owns the returned lease: ``in_flight`` is bumped here and
        MUST be released via ``observe`` (success) or ``report_failure``.
        """
        with self._lock:
            candidates = [r for r in self.replicas.values()
                          if r.healthy and r.name not in exclude]
            if not candidates:
                return None
            best = min(candidates, key=lambda r: (r.score(), r.name))
            best.in_flight += 1
            self.stats.picks += 1
            return best

    def observe(self, name: str, latency_s: float) -> None:
        """Record a successful call (releases the ``pick`` lease)."""
        with self._lock:
            r = self.replicas[name]
            r.in_flight = max(r.in_flight - 1, 0)
            r.latencies_s.append(latency_s)
            r.consecutive_failures = 0

    def release(self, name: str) -> None:
        """Release a ``pick`` lease WITHOUT judging the replica — for calls
        that failed for reasons that say nothing about its health (e.g. a
        remote member answering with backpressure: busy is not broken)."""
        with self._lock:
            r = self.replicas[name]
            r.in_flight = max(r.in_flight - 1, 0)

    def report_failure(self, name: str) -> bool:
        """Record a failed call; returns True if the replica was drained."""
        with self._lock:
            r = self.replicas[name]
            r.in_flight = max(r.in_flight - 1, 0)
            r.consecutive_successes = 0
            r.consecutive_failures += 1
            self.stats.reported_failures += 1
            if r.healthy and r.consecutive_failures >= self.unhealthy_after:
                r.healthy = False
                self.stats.drains += 1
                return True
            return False

    def swap_engine(self, name: str, engine) -> int:
        """Atomically replace the engine serving one slot; returns the new
        slot generation (monotone per slot, visible in
        ``slot_generations()`` / the ``pool.replica_slot_generation``
        gauge). This is the graduation path: ``TransferSupervisor`` fits a
        ``ForestEngine`` off the serving lock and swaps it in here.

        Zero dropped requests by construction: the swap commits under the
        routing lock, a dispatch that already read the old engine object
        finishes against it (engines stay answerable after being replaced
        — the caller decides when to ``close`` the old one), and every
        later ``pick``/dispatch sees the new engine. Latency history and
        health state carry over — the slot, not the engine object, is the
        unit the pool routes to."""
        with self._lock:
            if self._closed:
                raise RuntimeError("pool is closed")
            r = self.replicas[name]
            r.engine = engine
            r.deadline_aware = supports_deadline(
                getattr(engine, "predict", engine))
            r.slot_generation += 1
            self.stats.slot_swaps += 1
            return r.slot_generation

    def slot_generations(self) -> dict[str, int]:
        with self._lock:
            return {r.name: r.slot_generation
                    for r in self.replicas.values()}

    def drain(self, name: str) -> None:
        """Administratively drain a replica (health checks may revive it)."""
        with self._lock:
            r = self.replicas[name]
            if r.healthy:
                r.healthy = False
                r.consecutive_successes = 0
                self.stats.drains += 1

    def p50s_ms(self) -> dict[str, float]:
        with self._lock:
            return {r.name: r.p50_s() * 1e3 for r in self.replicas.values()}

    def stats_snapshot(self) -> PoolStats:
        """Atomic copy of the pool counters under the routing lock."""
        with self._lock:
            return PoolStats(**self.stats.__dict__)

    def register_metrics(self, registry) -> None:
        """Expose the pool through an ``obs.MetricsRegistry`` — all lazy
        callbacks evaluated at scrape time, nothing on the routing path."""
        for name in ("probes", "probe_failures", "drains", "revivals",
                     "reported_failures", "picks", "slot_swaps"):
            registry.register_fn(f"pool.{name}",
                                 lambda n=name: getattr(self.stats, n),
                                 kind="counter")
        registry.register_fn("pool.replicas", lambda: len(self.replicas))
        registry.register_fn("pool.healthy",
                             lambda: len(self.healthy_names()))
        for rname in self.replicas:
            registry.register_fn(
                "pool.replica_p50_s",
                lambda n=rname: self.replicas[n].p50_s(),
                replica=rname)
            registry.register_fn(
                "pool.replica_in_flight",
                lambda n=rname: self.replicas[n].in_flight,
                replica=rname)
            registry.register_fn(
                "pool.replica_slot_generation",
                lambda n=rname: self.replicas[n].slot_generation,
                kind="gauge", replica=rname)

    # ------------------------------------------------------------- probing

    def probe_once(self) -> dict[str, bool]:
        """One health-check sweep; returns {name: probe succeeded}.

        Called by the background thread every ``check_interval_s``, and
        directly by tests. Probes run OUTSIDE the pool lock (a wedged
        replica must not block routing); state transitions commit under it.
        """
        out: dict[str, bool] = {}
        for name in self.names:
            r = self.replicas.get(name)
            if r is None:
                continue
            t0 = time.perf_counter()
            try:
                if r.deadline_aware:
                    y = np.asarray(r.engine.predict(
                        self.probe_X, deadline_s=self.probe_deadline_s))
                else:
                    y = np.asarray(r.engine.predict(self.probe_X))
                ok = bool(np.all(np.isfinite(y)))
            except Exception:
                ok = False
            dt = time.perf_counter() - t0
            with self._lock:
                self.stats.probes += 1
                if ok:
                    r.latencies_s.append(dt)
                    r.consecutive_failures = 0
                    r.consecutive_successes += 1
                    if (not r.healthy
                            and r.consecutive_successes >= self.revive_after):
                        r.healthy = True
                        self.stats.revivals += 1
                else:
                    self.stats.probe_failures += 1
                    r.consecutive_successes = 0
                    r.consecutive_failures += 1
                    if (r.healthy
                            and r.consecutive_failures
                            >= self.unhealthy_after):
                        r.healthy = False
                        self.stats.drains += 1
            out[name] = ok
        return out

    def start(self) -> "ReplicaPool":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._probe_loop, name="replica-pool-health", daemon=True)
        self._thread.start()
        return self

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            self.probe_once()

    # ----------------------------------------------------------- lifecycle

    def attach_refresher(self, refresher) -> None:
        """Register an ``EngineRefresher`` so ``close()`` stops and joins it
        along with everything else (the shutdown-propagation contract)."""
        self._refreshers.append(refresher)

    def close(self) -> None:
        """Stop health checks, stop attached refreshers, close engines —
        joining every background thread. Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for refresher in self._refreshers:
            refresher.stop(join=True)
        for r in self.replicas.values():
            r.engine.close()

    def __enter__(self) -> "ReplicaPool":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
