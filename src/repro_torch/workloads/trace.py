"""Trace-replay load generation: recorded arrival traces + a replayer.

The saturation sweep in ``bench_latency`` drives the cluster with uniform
open-loop Poisson arrivals — traffic no production deployment sees. Ilager
et al. (arXiv 2004.08177) make the case that deadline-aware scheduling must
be evaluated under realistic, bursty load; this module supplies it as a
first-class, versioned artifact:

  * a **recorded-trace format** — JSONL, one CRC-tagged record per line —
    carrying timestamped arrival events (kernel id, feature vector, tenant,
    priority, deadline budget). Traces are byte-reproducible from a seed
    and survive corruption DETECTABLY (taxonomy below), mirroring the
    cluster transport's CRC-tagged frames;
  * **generators** for the load shapes the ROADMAP names: diurnal curves
    (non-homogeneous Poisson), correlated bursts (Markov-modulated
    Poisson), adversarial cache-busting feature streams, and mixed-tenant
    deadline mixes;
  * a **TraceReplayer** that drives any frontend-shaped target — an
    in-process ``ClusterFrontend`` or a ``RemoteReplica`` over the PR-4
    wire — at the recorded timestamps with open-loop pacing, honoring
    ``FrontendRejected.retry_after_s``, and keeping per-tenant outcome
    accounting.

Format (version 1)::

    line 0:  {"crc": C, "events": N, "kind": "trace-header",
              "n_features": F, "name": "...", "version": 1}
    line i:  {"crc": C, "deadline_s": D|null, "kernel": "...Wid",
              "kind": "event", "priority": P|null, "t_s": T,
              "tenant": "...", "x": [f0, ..., f(F-1)]}

``crc`` is the CRC32 of the record's CANONICAL serialization (sorted keys,
no whitespace, ``crc`` removed) — a bit flipped anywhere in a line either
breaks the JSON or changes the canonical bytes, so it cannot decode to a
different-but-valid event. ``t_s`` is seconds from trace start,
non-decreasing; ``deadline_s`` is the RELATIVE budget attached at replay
time (never absolute — the trace outlives any clock).

Failure taxonomy (property-tested in ``tests/test_trace.py``; decoding is
pure and never blocks or hangs):

  * ``TraceCorrupt``     — the bytes were damaged AFTER recording: CRC
    mismatch, a torn final line, or fewer events than the header promised.
    Re-fetch the trace.
  * ``TraceFormatError`` — this is not (or no longer parses as) a v1
    trace: bad header, unsupported version, malformed interior line,
    wrong feature width, non-monotonic timestamps, trailing data. Fix the
    producer; retrying cannot help.

Determinism contract: generators draw ONLY from ``numpy`` Generators
seeded by the caller (never the salted builtin ``hash``), serialization is
canonical, and ``ReplayReport.digest()`` covers the deterministic outcome
stream only — per-event outcome + prediction (the model's PREDICTED kernel
latency) and per-tenant counts + predicted-latency histograms. Wall-clock
timings are reported separately and never digested, so the same trace
replayed twice — in different processes, under different
``PYTHONHASHSEED`` — produces byte-identical digests (the golden-trace
regression test).

A copy of ``repro.workloads.trace``: the same trace replayed against the
same model gives the reference's digest, byte for byte.
"""
from __future__ import annotations

import hashlib
import heapq
import json
import threading
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = ["Trace", "TraceCorrupt", "TraceEvent", "TraceFormatError",
           "TraceError", "TraceReplayer", "ReplayReport", "EventOutcome",
           "TenantSummary", "TRACE_VERSION", "PRED_HIST_EDGES",
           "dump_trace", "dumps_trace", "gen_adversarial", "gen_bursts",
           "gen_diurnal", "gen_tenant_mix", "load_trace", "loads_trace",
           "synthetic_catalog"]

TRACE_VERSION = 1

_HEADER_KIND = "trace-header"
_EVENT_KIND = "event"

# predicted-latency histogram bucket edges (model output space, i.e.
# log(time_us) for the forest targets): fixed so two replays bucket
# identically — these counts ARE part of the golden digest
PRED_HIST_EDGES = np.linspace(-8.0, 32.0, 81)


class TraceError(RuntimeError):
    """Base class for recorded-trace codec failures."""


class TraceCorrupt(TraceError):
    """The trace bytes were damaged after recording (CRC mismatch, torn
    tail, fewer events than the header promised). Re-fetch the trace."""


class TraceFormatError(TraceError):
    """Not a v1 recorded trace (bad header / version / field types /
    ordering). Retrying the same bytes cannot help; fix the producer."""


# ---------------------------------------------------------------- data model

@dataclass(frozen=True)
class TraceEvent:
    """One recorded arrival: at ``t_s`` seconds from trace start, tenant
    ``tenant`` submits feature vector ``x`` for kernel ``kernel`` with an
    optional pinned ``priority`` and a relative ``deadline_s`` budget."""

    t_s: float
    kernel: str
    x: tuple[float, ...]
    tenant: str = "default"
    priority: int | None = None
    deadline_s: float | None = None


@dataclass
class Trace:
    name: str
    n_features: int
    events: list[TraceEvent]
    version: int = TRACE_VERSION

    def __len__(self) -> int:
        return len(self.events)

    def duration_s(self) -> float:
        return self.events[-1].t_s if self.events else 0.0

    def tenants(self) -> list[str]:
        seen: dict[str, None] = {}
        for ev in self.events:
            seen.setdefault(ev.tenant, None)
        return list(seen)

    def mean_rate(self) -> float:
        d = self.duration_s()
        return len(self.events) / d if d > 0 else float(len(self.events))


# --------------------------------------------------------------------- codec

def _canonical(record: dict) -> bytes:
    return json.dumps(record, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def _tagged_line(record: dict) -> bytes:
    crc = zlib.crc32(_canonical(record)) & 0xFFFFFFFF
    return _canonical({**record, "crc": crc})


def _check_line(obj: dict, where: str) -> dict:
    """Verify and strip the per-record CRC tag. Returns the bare record."""
    if "crc" not in obj or not isinstance(obj["crc"], int):
        raise TraceFormatError(f"{where}: missing integer crc tag")
    rec = {k: v for k, v in obj.items() if k != "crc"}
    actual = zlib.crc32(_canonical(rec)) & 0xFFFFFFFF
    if actual != obj["crc"]:
        raise TraceCorrupt(
            f"{where}: crc mismatch (tag {obj['crc']:#010x}, record is "
            f"{actual:#010x}) — corrupted after recording")
    return rec


def _num(rec: dict, key: str, where: str, *, optional: bool = False,
         minimum: float | None = None) -> float | None:
    v = rec.get(key)
    if v is None:
        if optional:
            return None
        raise TraceFormatError(f"{where}: missing {key!r}")
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise TraceFormatError(f"{where}: {key!r} must be a number, "
                               f"got {type(v).__name__}")
    v = float(v)
    if minimum is not None and v < minimum:
        raise TraceFormatError(f"{where}: {key!r}={v} below {minimum}")
    return v


def dumps_trace(trace: Trace) -> bytes:
    """Serialize to the CRC-tagged JSONL wire form (canonical: the same
    trace always produces the same bytes, on any machine)."""
    header = {"kind": _HEADER_KIND, "version": int(trace.version),
              "name": str(trace.name), "n_features": int(trace.n_features),
              "events": len(trace.events)}
    lines = [_tagged_line(header)]
    for i, ev in enumerate(trace.events):
        if len(ev.x) != trace.n_features:
            raise TraceFormatError(
                f"event {i}: {len(ev.x)} features, header says "
                f"{trace.n_features}")
        lines.append(_tagged_line({
            "kind": _EVENT_KIND, "t_s": float(ev.t_s),
            "kernel": str(ev.kernel), "tenant": str(ev.tenant),
            "x": [float(v) for v in ev.x],
            "priority": None if ev.priority is None else int(ev.priority),
            "deadline_s": (None if ev.deadline_s is None
                           else float(ev.deadline_s))}))
    return b"\n".join(lines) + b"\n"


def loads_trace(data: bytes | str) -> Trace:
    """Parse and fully validate a serialized trace. Raises the documented
    taxonomy (``TraceCorrupt`` / ``TraceFormatError``); never hangs."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    lines = data.split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()                      # the canonical trailing newline
    if not lines:
        raise TraceFormatError("empty input: not a recorded trace")

    def _parse(raw: bytes, where: str, *, torn_is_corrupt: bool) -> dict:
        try:
            obj = json.loads(raw.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as exc:
            # an unparseable FINAL line is the torn-tail signature (any
            # proper prefix of a canonical JSON object is invalid JSON);
            # an unparseable interior line means the producer is broken
            cls = TraceCorrupt if torn_is_corrupt else TraceFormatError
            raise cls(f"{where}: not JSON ({exc})") from exc
        if not isinstance(obj, dict):
            raise TraceFormatError(
                f"{where}: {type(obj).__name__}, expected object")
        return obj

    head = _check_line(_parse(lines[0], "header", torn_is_corrupt=False),
                       "header")
    if head.get("kind") != _HEADER_KIND:
        raise TraceFormatError(f"first record kind={head.get('kind')!r}, "
                               f"expected {_HEADER_KIND!r}")
    version = head.get("version")
    if version != TRACE_VERSION:
        raise TraceFormatError(f"unsupported trace version {version!r} "
                               f"(this reader speaks v{TRACE_VERSION})")
    n_features = head.get("n_features")
    n_events = head.get("events")
    name = head.get("name")
    if not isinstance(n_features, int) or n_features < 1:
        raise TraceFormatError(f"bad n_features {n_features!r}")
    if not isinstance(n_events, int) or n_events < 0:
        raise TraceFormatError(f"bad event count {n_events!r}")
    if not isinstance(name, str):
        raise TraceFormatError(f"bad trace name {name!r}")

    body = lines[1:]
    if len(body) > n_events:
        raise TraceFormatError(
            f"trailing data: {len(body)} lines after the header, header "
            f"promises {n_events} events")
    events: list[TraceEvent] = []
    prev_t = 0.0
    for i, raw in enumerate(body):
        where = f"event {i}"
        # the trailing-data check above guarantees len(body) <= n_events
        # here, so an unparseable FINAL line is always the torn-tail case
        last = i == len(body) - 1
        rec = _check_line(_parse(raw, where, torn_is_corrupt=last), where)
        if rec.get("kind") != _EVENT_KIND:
            raise TraceFormatError(
                f"{where}: kind={rec.get('kind')!r}, expected "
                f"{_EVENT_KIND!r}")
        t_s = _num(rec, "t_s", where, minimum=0.0)
        if t_s < prev_t:
            raise TraceFormatError(
                f"{where}: t_s={t_s} decreases (previous {prev_t})")
        prev_t = t_s
        kernel, tenant = rec.get("kernel"), rec.get("tenant")
        if not isinstance(kernel, str) or not isinstance(tenant, str):
            raise TraceFormatError(f"{where}: kernel/tenant must be strings")
        x = rec.get("x")
        if (not isinstance(x, list) or len(x) != n_features
                or any(isinstance(v, bool) or not isinstance(v, (int, float))
                       for v in x)):
            raise TraceFormatError(
                f"{where}: x must be a list of {n_features} numbers")
        prio = rec.get("priority")
        if prio is not None and (isinstance(prio, bool)
                                 or not isinstance(prio, int)):
            raise TraceFormatError(f"{where}: priority must be int or null")
        deadline = _num(rec, "deadline_s", where, optional=True)
        if deadline is not None and deadline <= 0:
            raise TraceFormatError(f"{where}: deadline_s={deadline} <= 0")
        events.append(TraceEvent(
            t_s=t_s, kernel=kernel, x=tuple(float(v) for v in x),
            tenant=tenant, priority=prio, deadline_s=deadline))
    if len(events) < n_events:
        raise TraceCorrupt(f"trace truncated: {len(events)}/{n_events} "
                           f"events present")
    return Trace(name=name, n_features=n_features, events=events,
                 version=version)


def dump_trace(trace: Trace, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(dumps_trace(trace))
    return path


def load_trace(path: str | Path) -> Trace:
    return loads_trace(Path(path).read_bytes())


# ---------------------------------------------------------------- generators

def synthetic_catalog(n_kernels: int, n_features: int,
                      seed: int = 0) -> tuple[list[str], np.ndarray]:
    """Deterministic (ids, X) kernel catalog for tests/fixtures: lognormal
    feature rows shaped like the real extracted features."""
    rng = np.random.default_rng(seed)
    X = rng.lognormal(1.0, 1.5, size=(n_kernels, n_features)).astype(
        np.float32)
    ids = [f"k{i:03d}" for i in range(n_kernels)]
    return ids, X


def _pick(rng: np.random.Generator, kernel_ids, X, t: float, tenant: str,
          priority, deadline_band) -> TraceEvent:
    k = int(rng.integers(len(kernel_ids)))
    deadline = None
    if deadline_band is not None:
        lo, hi = deadline_band
        deadline = float(rng.uniform(lo, hi))
    return TraceEvent(t_s=float(t), kernel=kernel_ids[k],
                      x=tuple(float(v) for v in X[k]), tenant=tenant,
                      priority=priority, deadline_s=deadline)


def gen_diurnal(kernel_ids, X, *, duration_s: float, mean_rate: float,
                peak_to_trough: float = 3.0, n_cycles: float = 1.0,
                seed: int = 0, tenant: str = "diurnal",
                deadline_band: tuple[float, float] | None = None) -> Trace:
    """Diurnal load curve: a non-homogeneous Poisson process whose rate
    follows a sinusoid through ``n_cycles`` day-cycles compressed into
    ``duration_s``, trough-to-peak ratio ``peak_to_trough`` around
    ``mean_rate`` (events/s). Generated by thinning, so arrivals are exact
    draws from the target intensity."""
    if peak_to_trough < 1.0:
        raise ValueError("peak_to_trough must be >= 1")
    rng = np.random.default_rng(seed)
    amp = (peak_to_trough - 1.0) / (peak_to_trough + 1.0)
    rate_max = mean_rate * (1.0 + amp)

    def rate(t: float) -> float:
        phase = 2.0 * np.pi * n_cycles * t / duration_s
        return mean_rate * (1.0 + amp * np.sin(phase - np.pi / 2.0))

    events, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / rate_max))
        if t >= duration_s:
            break
        if rng.uniform() <= rate(t) / rate_max:    # thinning acceptance
            events.append(_pick(rng, kernel_ids, X, t, tenant, None,
                                deadline_band))
    return Trace(name=f"diurnal-s{seed}", n_features=X.shape[1],
                 events=events)


def gen_bursts(kernel_ids, X, *, duration_s: float, rate_quiet: float,
               rate_burst: float, mean_quiet_s: float, mean_burst_s: float,
               seed: int = 0, tenant: str = "bursty",
               deadline_band: tuple[float, float] | None = None) -> Trace:
    """Correlated bursts: a 2-state Markov-modulated Poisson process.
    Sojourn times in the quiet/burst states are exponential with the given
    means; arrivals are Poisson at the state's rate — the arrival stream is
    over-dispersed (correlated) the way incident-driven traffic is, unlike
    the uniform open-loop sweep."""
    rng = np.random.default_rng(seed)
    events, t, burst = [], 0.0, False
    while t < duration_s:
        mean_s = mean_burst_s if burst else mean_quiet_s
        rate = rate_burst if burst else rate_quiet
        t_leave = t + float(rng.exponential(mean_s))
        while True:
            t += float(rng.exponential(1.0 / rate))
            if t >= min(t_leave, duration_s):
                break
            events.append(_pick(rng, kernel_ids, X, t, tenant, None,
                                deadline_band))
        t = min(t_leave, duration_s)
        burst = not burst
    return Trace(name=f"bursts-s{seed}", n_features=X.shape[1],
                 events=events)


def gen_adversarial(kernel_ids, X, *, duration_s: float, rate: float,
                    seed: int = 0, tenant: str = "adversary",
                    jitter: float = 0.1,
                    deadline_band: tuple[float, float] | None = None
                    ) -> Trace:
    """Adversarial cache-busting stream: kernels cycle in a freshly
    shuffled order each sweep (an LRU smaller than the catalog never hits)
    and every feature vector carries a unique multiplicative perturbation,
    so feature-hash caches see NO repeats at all. Arrivals are evenly
    spaced at ``rate`` with ``jitter`` fractional noise — sustained
    worst-case pressure rather than Poisson lulls."""
    rng = np.random.default_rng(seed)
    n = max(int(duration_s * rate), 1)
    step = duration_s / n
    events, order, pos = [], rng.permutation(len(kernel_ids)), 0
    t = 0.0
    for i in range(n):
        t += step * float(1.0 + jitter * (rng.uniform() - 0.5))
        if t >= duration_s:
            break
        if pos >= len(order):
            order, pos = rng.permutation(len(kernel_ids)), 0
        k = int(order[pos])
        pos += 1
        x = X[k] * (1.0 + 1e-3 * rng.standard_normal(X.shape[1]))
        deadline = None
        if deadline_band is not None:
            deadline = float(rng.uniform(*deadline_band))
        events.append(TraceEvent(
            t_s=float(t), kernel=kernel_ids[k],
            x=tuple(float(v) for v in x), tenant=tenant,
            priority=None, deadline_s=deadline))
    return Trace(name=f"adversarial-s{seed}", n_features=X.shape[1],
                 events=events)


def gen_tenant_mix(kernel_ids, X, *, duration_s: float,
                   tenants: dict[str, dict], seed: int = 0) -> Trace:
    """Mixed-tenant deadline mix: one Poisson stream per tenant, merged in
    time order. Each tenant spec is ``{"rate": events/s,
    "deadline_band": (lo, hi) | None, "priority": int | None}`` — e.g. an
    interactive tenant with tight deadlines next to a batch tenant with
    none, the mix the slack-derived admission priorities exist for."""
    rng = np.random.default_rng(seed)
    events: list[TraceEvent] = []
    for tenant in sorted(tenants):               # deterministic order
        spec = tenants[tenant]
        t = 0.0
        while True:
            t += float(rng.exponential(1.0 / spec["rate"]))
            if t >= duration_s:
                break
            events.append(_pick(rng, kernel_ids, X, t, tenant,
                                spec.get("priority"),
                                spec.get("deadline_band")))
    events.sort(key=lambda ev: (ev.t_s, ev.tenant))
    return Trace(name=f"tenant-mix-s{seed}", n_features=X.shape[1],
                 events=events)


# ----------------------------------------------------------------- replaying

#: stable outcome labels (the digest vocabulary)
SERVED, SHED, EXPIRED, FAILED = "served", "shed", "expired", "failed"


@dataclass
class EventOutcome:
    idx: int
    tenant: str
    kernel: str
    outcome: str                       # served | shed | expired | failed
    prediction: float | None = None    # the model's predicted latency
    retries: int = 0                   # resubmits after FrontendRejected
    wall_s: float | None = None        # submit -> resolve (NOT digested)


@dataclass
class TenantSummary:
    submitted: int = 0
    served: int = 0
    shed: int = 0
    expired: int = 0
    failed: int = 0
    retries: int = 0
    pred_hist: list[int] = field(
        default_factory=lambda: [0] * (len(PRED_HIST_EDGES) + 1))
    wall_s: list[float] = field(default_factory=list, repr=False)

    def shed_fraction(self) -> float:
        return self.shed / self.submitted if self.submitted else 0.0

    def wall_percentile_ms(self, p: float) -> float:
        return (float(np.percentile(self.wall_s, p)) * 1e3
                if self.wall_s else 0.0)


@dataclass
class ReplayReport:
    trace_name: str
    pacing: str
    speed: float
    outcomes: list[EventOutcome]
    per_tenant: dict[str, TenantSummary]
    wall_s: float

    @property
    def n_events(self) -> int:
        return len(self.outcomes)

    def count(self, outcome: str) -> int:
        return sum(1 for o in self.outcomes if o.outcome == outcome)

    def shed_fraction(self) -> float:
        return self.count(SHED) / max(self.n_events, 1)

    def served_wall_ms(self, p: float) -> float:
        xs = [o.wall_s for o in self.outcomes
              if o.outcome == SERVED and o.wall_s is not None]
        return float(np.percentile(xs, p)) * 1e3 if xs else 0.0

    def digest(self) -> str:
        """sha256 over the DETERMINISTIC outcome stream: per-event
        (tenant, kernel, outcome, prediction-as-hex-float) in trace order,
        plus per-tenant admission/shed/completion counts and
        predicted-latency histogram bucket counts. Wall-clock timings are
        excluded by construction — two replays of the same trace against
        the same model digest identically, in any process, under any
        ``PYTHONHASHSEED``."""
        payload = {
            "trace": self.trace_name,
            "version": TRACE_VERSION,
            "events": [
                [o.idx, o.tenant, o.kernel, o.outcome,
                 None if o.prediction is None else float(o.prediction).hex()]
                for o in sorted(self.outcomes, key=lambda o: o.idx)],
            "tenants": {
                t: {"submitted": s.submitted, "served": s.served,
                    "shed": s.shed, "expired": s.expired,
                    "failed": s.failed, "pred_hist": list(s.pred_hist)}
                for t, s in sorted(self.per_tenant.items())},
        }
        return hashlib.sha256(_canonical(payload)).hexdigest()


class TraceReplayer:
    """Replays a recorded trace against a frontend-shaped target.

    ``target`` is duck-typed: anything with
    ``submit(x, priority=, deadline_s=) -> Future`` (an in-process
    ``ClusterFrontend``) is driven asynchronously; anything with only
    ``predict(X, deadline_s=, priority=) -> array`` (a ``RemoteReplica``
    over the PR-4 wire, or a bare engine) is driven through a small worker
    pool. Backpressure semantics are identical either way:
    ``FrontendRejected`` re-queues the event after (a capped slice of) the
    server's ``retry_after_s`` hint, up to ``max_retries`` times, after
    which the event counts as SHED for its tenant. When the target's
    ``submit`` accepts a ``tenant`` kwarg (``ClusterFrontend``), each
    event's recorded tenant is forwarded so per-tenant admission quotas
    apply during replay.

    ``pacing="open"`` submits each event at ``t_s / speed`` on the real
    clock, open-loop — arrivals never wait for completions, exactly like
    recorded production traffic. ``pacing="sequential"`` ignores
    timestamps and awaits each event before the next: the deterministic
    mode golden-trace tests replay in (no queue contention, so outcomes
    and the digest depend only on trace + model).
    """

    def __init__(self, target, *, speed: float = 1.0,
                 pacing: str = "open", max_retries: int = 2,
                 honor_retry_after: bool = True, retry_cap_s: float = 0.25,
                 timeout_s: float = 60.0, workers: int = 8,
                 obs=None, observer=None):
        if pacing not in ("open", "sequential"):
            raise ValueError(f"unknown pacing {pacing!r}")
        if speed <= 0:
            raise ValueError("speed must be > 0")
        self.target = target
        self.speed = float(speed)
        self.pacing = pacing
        self.max_retries = int(max_retries)
        self.honor_retry_after = honor_retry_after
        self.retry_cap_s = float(retry_cap_s)
        self.timeout_s = float(timeout_s)
        self.workers = int(workers)
        # observability hooks — both run AFTER the replay loop, off the
        # submit path, so neither can perturb outcomes or the digest.
        # ``obs`` (an ``repro_torch.obs.Observability``) gets replay.* counters
        # + a wall-clock histogram; ``observer(event, outcome)`` is called
        # once per SERVED event in trace order (how examples/tests feed a
        # CalibrationMonitor with predicted-vs-measured pairs).
        self.obs = obs
        self.observer = observer
        # forward each event's tenant when the target can charge it to a
        # quota (ClusterFrontend.submit) — duck-typed targets without the
        # kwarg keep working unchanged
        submit = getattr(target, "submit", None)
        try:
            import inspect
            self._submit_takes_tenant = (
                submit is not None
                and "tenant" in inspect.signature(submit).parameters)
        except (TypeError, ValueError):
            self._submit_takes_tenant = False

    # lazy: the codec half of this module stays importable without the
    # cluster tier
    def _errors(self):
        from ..cluster.frontend import DeadlineExceeded, FrontendRejected
        return FrontendRejected, DeadlineExceeded

    def replay(self, trace: Trace) -> ReplayReport:
        outcomes: list[EventOutcome | None] = [None] * len(trace.events)
        per_tenant: dict[str, TenantSummary] = {}
        for ev in trace.events:
            per_tenant.setdefault(ev.tenant, TenantSummary())
        t0 = time.perf_counter()
        if self.pacing == "sequential":
            self._replay_sequential(trace, outcomes)
        else:
            self._replay_open(trace, outcomes)
        wall = time.perf_counter() - t0
        done = [o for o in outcomes if o is not None]
        for o in done:
            s = per_tenant[o.tenant]
            s.submitted += 1
            s.retries += o.retries
            setattr(s, o.outcome, getattr(s, o.outcome) + 1)
            if o.outcome == SERVED and o.prediction is not None:
                bucket = int(np.searchsorted(PRED_HIST_EDGES, o.prediction,
                                             side="right"))
                s.pred_hist[bucket] += 1
            if o.wall_s is not None:
                s.wall_s.append(o.wall_s)
        report = ReplayReport(trace_name=trace.name, pacing=self.pacing,
                              speed=self.speed, outcomes=done,
                              per_tenant=per_tenant, wall_s=wall)
        self._publish(trace, report)
        return report

    def _publish(self, trace: Trace, report: ReplayReport) -> None:
        """Post-replay observability: counters/histogram into the unified
        registry + per-SERVED ``observer(event, outcome)`` callbacks, all in
        trace order. Runs after every outcome is final, so it cannot perturb
        pacing, retries, or the report digest."""
        if self.obs is not None:
            reg = self.obs.registry
            by_outcome: dict[str, int] = {}
            hist = reg.histogram("replay.wall_s")
            for o in report.outcomes:
                by_outcome[o.outcome] = by_outcome.get(o.outcome, 0) + 1
                if o.wall_s is not None:
                    hist.observe(o.wall_s)
            for outcome, n in sorted(by_outcome.items()):
                reg.counter("replay.events", outcome=outcome).inc(n)
            reg.counter("replay.retries").inc(
                sum(o.retries for o in report.outcomes))
            reg.counter("replay.runs").inc()
        if self.observer is not None:
            for o in sorted(report.outcomes, key=lambda o: o.idx):
                if o.outcome == SERVED:
                    self.observer(trace.events[o.idx], o)

    # ------------------------------------------------------------- plumbing

    def _call_sync(self, ev: TraceEvent) -> float:
        """One synchronous prediction for ``ev`` on either target shape."""
        x = np.asarray(ev.x, dtype=np.float32)
        if hasattr(self.target, "submit"):
            kw = {"tenant": ev.tenant} if self._submit_takes_tenant else {}
            fut = self.target.submit(x, priority=ev.priority,
                                     deadline_s=ev.deadline_s, **kw)
            return float(fut.result(timeout=self.timeout_s))
        y = self.target.predict(x[None, :], deadline_s=ev.deadline_s,
                                priority=ev.priority)
        return float(np.asarray(y).reshape(-1)[0])

    def _retry_sleep(self, exc) -> None:
        if self.honor_retry_after:
            time.sleep(min(max(exc.retry_after_s, 0.0), self.retry_cap_s))

    def _run_one(self, ev: TraceEvent, idx: int) -> EventOutcome:
        """Synchronous submit/predict with the shed/expiry taxonomy and the
        retry-after loop — the sequential path, and the worker body for
        predict-shaped targets in open-loop mode."""
        FrontendRejected, DeadlineExceeded = self._errors()
        retries = 0
        t_submit = time.perf_counter()
        while True:
            try:
                pred = self._call_sync(ev)
                return EventOutcome(idx, ev.tenant, ev.kernel, SERVED,
                                    prediction=pred, retries=retries,
                                    wall_s=time.perf_counter() - t_submit)
            except FrontendRejected as rej:
                if retries >= self.max_retries:
                    return EventOutcome(idx, ev.tenant, ev.kernel, SHED,
                                        retries=retries)
                retries += 1
                self._retry_sleep(rej)
            except DeadlineExceeded:
                return EventOutcome(idx, ev.tenant, ev.kernel, EXPIRED,
                                    retries=retries,
                                    wall_s=time.perf_counter() - t_submit)
            except Exception:
                return EventOutcome(idx, ev.tenant, ev.kernel, FAILED,
                                    retries=retries)

    def _replay_sequential(self, trace: Trace, outcomes: list) -> None:
        for idx, ev in enumerate(trace.events):
            outcomes[idx] = self._run_one(ev, idx)

    def _replay_open(self, trace: Trace, outcomes: list) -> None:
        FrontendRejected, DeadlineExceeded = self._errors()
        submit_style = hasattr(self.target, "submit")
        if not submit_style:
            self._replay_open_workers(trace, outcomes)
            return
        lock = threading.Lock()
        pending = 0

        def record(idx: int, ev: TraceEvent, retries: int, t_submit: float):
            def cb(fut):
                nonlocal pending
                if fut.cancelled():
                    out = EventOutcome(idx, ev.tenant, ev.kernel, FAILED,
                                       retries=retries)
                else:
                    exc = fut.exception()
                    wall = time.perf_counter() - t_submit
                    if exc is None:
                        out = EventOutcome(idx, ev.tenant, ev.kernel, SERVED,
                                           prediction=float(fut.result()),
                                           retries=retries, wall_s=wall)
                    elif isinstance(exc, DeadlineExceeded):
                        out = EventOutcome(idx, ev.tenant, ev.kernel,
                                           EXPIRED, retries=retries,
                                           wall_s=wall)
                    else:
                        out = EventOutcome(idx, ev.tenant, ev.kernel, FAILED,
                                           retries=retries)
                with lock:
                    outcomes[idx] = out
                    pending -= 1
            return cb

        # (due_time, seq, idx, event, retries): arrivals AND re-queued
        # rejections share one time-ordered heap — open-loop pacing with
        # the retry-after hint honored as a recorded-time offset
        t_start = time.perf_counter()
        heap: list[tuple[float, int, int, TraceEvent, int]] = []
        for idx, ev in enumerate(trace.events):
            heapq.heappush(heap, (t_start + ev.t_s / self.speed, idx, idx,
                                  ev, 0))
        seq = len(trace.events)
        while heap:
            due, _, idx, ev, retries = heapq.heappop(heap)
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            x = np.asarray(ev.x, dtype=np.float32)
            t_submit = time.perf_counter()
            kw = {"tenant": ev.tenant} if self._submit_takes_tenant else {}
            try:
                fut = self.target.submit(x, priority=ev.priority,
                                         deadline_s=ev.deadline_s, **kw)
            except FrontendRejected as rej:
                if retries >= self.max_retries:
                    with lock:
                        outcomes[idx] = EventOutcome(
                            idx, ev.tenant, ev.kernel, SHED, retries=retries)
                    continue
                hint = (min(max(rej.retry_after_s, 0.0), self.retry_cap_s)
                        if self.honor_retry_after else 0.0)
                heapq.heappush(heap, (time.perf_counter() + hint, seq, idx,
                                      ev, retries + 1))
                seq += 1
                continue
            except Exception:
                with lock:
                    outcomes[idx] = EventOutcome(idx, ev.tenant, ev.kernel,
                                                 FAILED, retries=retries)
                continue
            with lock:
                pending += 1
            fut.add_done_callback(record(idx, ev, retries, t_submit))
        give_up = time.monotonic() + self.timeout_s
        while time.monotonic() < give_up:
            with lock:
                if pending == 0:
                    return
            time.sleep(0.005)

    def _replay_open_workers(self, trace: Trace, outcomes: list) -> None:
        """Open-loop pacing for predict-shaped targets (RemoteReplica over
        the wire): a bounded worker pool runs the synchronous calls so
        arrivals keep to the recorded clock while requests overlap. With
        the PR-7 pipelined client every worker's request rides the SAME
        socket concurrently (out-of-order reply matching), so the bench
        measures protocol cost, not per-event connection churn or
        one-request-per-RTT serialization."""
        from concurrent.futures import ThreadPoolExecutor, wait

        t_start = time.perf_counter()
        futs = []
        with ThreadPoolExecutor(max_workers=self.workers,
                                thread_name_prefix="trace-replay") as pool:
            for idx, ev in enumerate(trace.events):
                delay = t_start + ev.t_s / self.speed - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                futs.append(pool.submit(self._run_one, ev, idx))
            wait(futs, timeout=self.timeout_s)
        for f in futs:
            if f.done() and not f.cancelled():
                out = f.result()
                outcomes[out.idx] = out


# ------------------------------------------------------------------ selftest

def _selftest() -> int:
    """CI trace-replay smoke lane: codec round-trip + taxonomy spot checks,
    then the SAME short tenant-mix trace replayed twice (sequentially)
    through fresh in-process frontends must produce identical digests."""
    from ..cluster.remote import demo_frontend

    ids, X = synthetic_catalog(12, 6, seed=7)
    trace = gen_tenant_mix(
        ids, X, duration_s=2.0, seed=11,
        tenants={"interactive": {"rate": 30.0, "deadline_band": (0.5, 2.0)},
                 "batch": {"rate": 20.0, "deadline_band": None},
                 "best-effort": {"rate": 10.0, "deadline_band": (2.0, 5.0),
                                 "priority": 9}})
    data = dumps_trace(trace)
    back = loads_trace(data)
    assert dumps_trace(back) == data, "codec round-trip not canonical"
    for mangle, expect in ((data[:len(data) - 7], TraceError),
                           (data[:1] + b"X" + data[2:], TraceError),
                           (b"not a trace\n", TraceError)):
        try:
            loads_trace(mangle)
        except expect:
            pass
        else:
            raise AssertionError("mangled trace did not raise")

    digests = []
    for _ in range(2):
        fe = demo_frontend(seed=3, n_features=6).start()
        try:
            rep = TraceReplayer(fe, pacing="sequential").replay(back)
        finally:
            fe.close()
        assert rep.count(SERVED) == len(back), (
            f"{rep.count(SERVED)}/{len(back)} served")
        digests.append(rep.digest())
    assert digests[0] == digests[1], "replay digest not deterministic"
    print(f"TRACE-SELFTEST OK events={len(back)} "
          f"tenants={len(back.tenants())} digest={digests[0][:16]}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(_selftest())
