"""RPC-style cluster frontend: admission control in front of a replica pool.

The paper's deployment argument (§6.1/§7.1) is that predictions are cheap
enough (15–108 ms single, far less batched) to sit on a scheduler's hot
path. ``ClusterFrontend`` is the piece that lets that run as a shared
service rather than a library call:

  * **bounded admission queue** — ``submit`` enqueues one request (and
    ``submit_batch`` enqueues a whole batch as ONE entry — the protocol-v3
    server fast path); the bound is counted in ROWS, so when the queued
    rows would exceed ``max_queue`` the request is REJECTED with
    ``FrontendRejected(retry_after_s)`` — explicit backpressure for the
    caller's retry loop instead of unbounded memory growth. With
    ``tenant_quotas`` configured, each tenant additionally gets its own
    queued-rows ceiling, so one saturating tenant exhausts its OWN share
    of the queue, not its neighbors' (the fairness half of the per-tenant
    auth model — see ``cluster/remote.py`` and docs/transport.md).
  * **deadline/priority-aware dequeue** — the queue is a heap ordered by
    ``(priority, deadline, arrival)``: lower priority values dispatch
    first, earliest deadline first within a priority, FIFO within a tie.
    A request whose deadline has already passed at dispatch time fails
    fast with ``DeadlineExceeded`` — its slot is not wasted on an answer
    nobody is waiting for.
  * **routing** — a dispatcher thread pops up to ``dispatch_batch``
    requests (one batched engine call amortizes exactly like the engine's
    own micro-batching) and hands them to the ``ReplicaPool``'s best
    replica (healthy, lowest ``(in_flight + 1) * p50`` score). At most
    one dispatch per HEALTHY replica is in flight, so the ADMISSION queue
    is where requests wait — which is what makes its ordering and its
    bound meaningful, even when failures shrink the pool to one survivor.
  * **failover** — a dispatch that raises reports the failure to the pool
    (driving the drain counter) and retries the batch on another replica;
    only when every healthy replica has been tried do the waiters see the
    error.
  * **asyncio surface** — ``submit`` returns a ``concurrent.futures``
    Future; ``rpc`` is the coroutine adapter (``await frontend.rpc(x)``)
    for asyncio servers; ``predict`` is the synchronous batch convenience
    that honors backpressure by sleeping out ``retry_after_s``.

``close()`` tears down the whole tier: dispatcher joined, in-flight
dispatches drained, queued futures failed, and (by default) the pool —
with its health thread, attached refreshers, and engines — closed too.

A copy of ``repro.cluster.frontend``, its imports pointed at the port.
"""
from __future__ import annotations

import heapq
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field, replace

import numpy as np

from ..core.scheduler import slack_priority
from ..obs import Observability, Reservoir, Span, TraceContext
from .replicas import ReplicaPool

__all__ = ["ClusterFrontend", "DeadlineExceeded", "FrontendConfig",
           "FrontendRejected", "FrontendStats"]


class FrontendRejected(RuntimeError):
    """Backpressure: the admission queue is full. Retry after
    ``retry_after_s`` (the frontend's drain-time estimate)."""

    def __init__(self, retry_after_s: float):
        super().__init__(f"admission queue full; retry after "
                         f"{retry_after_s * 1e3:.0f} ms")
        self.retry_after_s = retry_after_s


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it could be dispatched."""


@dataclass
class FrontendConfig:
    max_queue: int = 256           # admission-queue bound in ROWS
    dispatch_batch: int = 64       # queue entries per batched replica call
    max_retries: int = 2           # replica failovers per dispatch
    retry_after_s: float = 0.05    # floor for the backpressure hint
    no_replica_wait_s: float = 2.0 # wait for a revival before failing
    latency_window: int = 2048     # waits/engine-times kept for percentiles
    # per-tenant queued-rows ceilings: {"tenant": rows, ..., "*": rows}.
    # "*" caps tenants not named explicitly; unnamed tenants with no "*"
    # are bounded only by max_queue. None disables quota accounting.
    tenant_quotas: dict[str, int] | None = None


@dataclass
class FrontendStats:
    submitted: int = 0             # rows admitted
    rejected: int = 0              # backpressure rejections (incl. quota)
    quota_rejected: int = 0        # rejections charged to a tenant quota
    cancelled: int = 0             # futures cancelled while still queued
    expired: int = 0               # DeadlineExceeded at dispatch time
    served: int = 0                # rows answered
    failed: int = 0                # rows failed by replica errors
    dispatches: int = 0            # successful batched replica calls
    retries: int = 0               # failovers to another replica
    deadlines_forwarded: int = 0   # dispatches carrying a member deadline
    schedules: int = 0             # DVFS schedule() calls answered
    by_replica: dict = field(default_factory=dict)  # name -> rows served
    # tenant -> {"submitted": rows, "rejected": count, "served": rows}
    by_tenant: dict = field(default_factory=dict)


@dataclass
class _Request:
    x: np.ndarray                  # (F,) single row or (B, F) batch
    future: Future                 # resolves to float (single) / (B,) array
    priority: int
    deadline: float | None         # absolute monotonic, or None
    t_submit: float
    rows: int = 1
    tenant: str = "default"
    # distributed tracing: the caller's context plus the server-side spans
    # opened on this request's behalf (all None on untraced requests — the
    # hot path pays one is-None check)
    ctx: TraceContext | None = None
    queue_span: Span | None = None
    dispatch_span: Span | None = None


class ClusterFrontend:
    """Bounded, deadline-aware request funnel over a ``ReplicaPool``."""

    def __init__(self, pool: ReplicaPool, config: FrontendConfig | None = None,
                 *, devices=None, auto_start: bool = True,
                 obs: Observability | None = None, **overrides):
        cfg = config or FrontendConfig()
        # optional scheduling surface: a serve.MultiDeviceEngine (or
        # DevicePredictor list) this tier can run deadline-aware per-kernel
        # DVFS selection against — see ``schedule``. The caller owns its
        # lifecycle (the pool only closes its own members).
        self.devices = devices
        if overrides:
            cfg = FrontendConfig(**{**cfg.__dict__, **overrides})
        if cfg.max_queue < 1 or cfg.dispatch_batch < 1:
            raise ValueError("max_queue and dispatch_batch must be >= 1")
        self.config = cfg
        self.pool = pool
        self.stats = FrontendStats()
        self.obs = obs
        self._tracer = obs.tracer if obs is not None else None
        self._wait_hist = self._engine_hist = None
        # first replica that KNOWS its width wins: a RemoteReplica that has
        # not completed its hello yet reports n_features=None and must not
        # mask an in-process sibling
        self.n_features = next(
            (r.engine.n_features for r in pool.replicas.values()
             if getattr(r.engine, "n_features", None) is not None), None)
        self._cond = threading.Condition()
        self._queue: list[tuple[int, float, int, _Request]] = []
        self._queued_rows = 0      # max_queue is a ROW bound (batch entries)
        self._tenant_rows: dict[str, int] = {}   # queued rows per tenant
        self._seq = 0
        self._dispatching = 0      # batches currently out with a replica
        # Algorithm-R reservoirs: bounded memory forever, percentiles
        # representative of the WHOLE run, not just the last window
        self._waits_s = Reservoir(cfg.latency_window, seed=0)
        self._engine_s = Reservoir(cfg.latency_window, seed=1)
        self._closed = False
        self._thread: threading.Thread | None = None
        # one in-flight dispatch per replica: requests WAIT in the ordered
        # admission queue, not in an unordered executor backlog
        self._max_out = max(len(pool.replicas), 1)
        self._executor = ThreadPoolExecutor(
            max_workers=self._max_out,
            thread_name_prefix="cluster-dispatch")
        if obs is not None:
            self._register_obs(obs)
        if auto_start:
            self.start()

    def _register_obs(self, obs: Observability) -> None:
        """Expose the frontend through the metrics registry.  Counters are
        LAZY (evaluated at scrape time from the stats object — zero added
        hot-path work); only the wait/engine histograms observe live."""
        reg = obs.registry
        for name in ("submitted", "rejected", "quota_rejected", "cancelled",
                     "expired", "served", "failed", "dispatches", "retries",
                     "deadlines_forwarded", "schedules"):
            reg.register_fn(f"frontend.{name}",
                            lambda n=name: getattr(self.stats, n),
                            kind="counter")
        reg.register_fn("frontend.queue_depth", self.queue_len)
        reg.register_fn("frontend.queued_rows", lambda: self._queued_rows)
        reg.register_fn("frontend.healthy_replicas",
                        lambda: len(self.pool.healthy_names()))
        self._wait_hist = reg.histogram("frontend.wait_s")
        self._engine_hist = reg.histogram("frontend.engine_s")
        self.pool.register_metrics(reg)

    # ------------------------------------------------------------ admission

    def submit(self, x: np.ndarray, *, priority: int | None = None,
               deadline_s: float | None = None,
               tenant: str | None = None,
               trace_ctx: TraceContext | None = None) -> Future:
        """Enqueue one feature vector; resolves to float.

        ``priority``: lower dispatches first; the DEFAULT (``None``) derives
        it from the deadline slack via ``core.scheduler.slack_priority`` —
        tight deadlines jump the queue, no-deadline requests run as
        background — so callers (local or remote: the transport forwards
        ``priority=None`` untouched) never pick magic ints. ``deadline_s``:
        seconds from now; a request not dispatched by then fails with
        ``DeadlineExceeded``. ``tenant``: the quota bucket this row is
        charged to (the v3 handshake binds it per connection; ``None``
        means the ``"default"`` bucket). Raises ``FrontendRejected`` when
        the admission queue — or the tenant's quota slice of it — is full,
        the RPC error a remote caller would see as HTTP 429 + Retry-After.
        """
        x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
        if self.n_features is not None and x.shape[0] != self.n_features:
            raise ValueError(f"expected {self.n_features} features, "
                             f"got {x.shape[0]}")
        return self._enqueue(x, 1, priority, deadline_s, tenant, trace_ctx)

    def submit_batch(self, X: np.ndarray, *, priority: int | None = None,
                     deadline_s: float | None = None,
                     tenant: str | None = None,
                     trace_ctx: TraceContext | None = None) -> Future:
        """Enqueue a whole (B, F) batch as ONE queue entry; resolves to a
        (B,) float64 array.

        This is the protocol-v3 server fast path: one admission decision,
        one heap entry, one future, one engine call for the whole frame —
        no per-row Python work between the wire and the engine. The batch
        shares one priority/deadline (the v2 JSON path keeps per-row
        submits with per-row deadline burn-down). Admission is atomic: a
        batch that does not fit — queue-wise or quota-wise — is rejected
        whole, never half-admitted, so there are no orphaned sibling rows
        to cancel. A batch of more than ``max_queue`` rows can never be
        admitted; split it client-side.
        """
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim != 2:
            raise ValueError(f"expected (B, F) batch, got shape {X.shape}")
        if self.n_features is not None and X.shape[1] != self.n_features:
            raise ValueError(f"expected {self.n_features} features, "
                             f"got {X.shape[1]}")
        if X.shape[0] == 0:                      # nothing to queue
            fut: Future = Future()
            fut.set_result(np.empty(0, dtype=np.float64))
            return fut
        return self._enqueue(X, X.shape[0], priority, deadline_s, tenant,
                             trace_ctx)

    def _enqueue(self, x: np.ndarray, rows: int, priority: int | None,
                 deadline_s: float | None, tenant: str | None,
                 trace_ctx: TraceContext | None = None) -> Future:
        if priority is None:
            priority = slack_priority(deadline_s)
        tenant = tenant or "default"
        tracer = self._tracer if trace_ctx is not None else None
        admit = (tracer.start("admit", parent=trace_ctx, rows=rows,
                              tenant=tenant) if tracer else None)
        now = time.monotonic()
        deadline = None if deadline_s is None else now + deadline_s
        fut: Future = Future()
        with self._cond:
            if self._closed:
                raise RuntimeError("frontend is closed")
            tstats = self.stats.by_tenant.setdefault(
                tenant, {"submitted": 0, "rejected": 0, "served": 0})
            if self._queued_rows + rows > self.config.max_queue:
                self.stats.rejected += rows
                tstats["rejected"] += rows
                if admit:
                    tracer.finish(admit, outcome="rejected")
                raise FrontendRejected(self._retry_after_locked())
            quota = self._quota_for(tenant)
            if (quota is not None
                    and self._tenant_rows.get(tenant, 0) + rows > quota):
                self.stats.rejected += rows
                self.stats.quota_rejected += rows
                tstats["rejected"] += rows
                if admit:
                    tracer.finish(admit, outcome="quota_rejected")
                # the hint reflects the TENANT's drain, not the whole
                # queue's: its own queued share must shrink first
                raise FrontendRejected(self._retry_after_locked())
            req = _Request(x, fut, priority, deadline, now, rows, tenant,
                           ctx=trace_ctx)
            if admit:
                tracer.finish(admit, outcome="admitted")
                req.queue_span = tracer.start("queue", parent=trace_ctx)
            key = deadline if deadline is not None else math.inf
            heapq.heappush(self._queue, (priority, key, self._seq, req))
            self._seq += 1
            self._queued_rows += rows
            self._tenant_rows[tenant] = (
                self._tenant_rows.get(tenant, 0) + rows)
            self.stats.submitted += rows
            tstats["submitted"] += rows
            self._cond.notify()
        return fut

    def _quota_for(self, tenant: str) -> int | None:
        quotas = self.config.tenant_quotas
        if quotas is None:
            return None
        return quotas.get(tenant, quotas.get("*"))

    async def rpc(self, x: np.ndarray, *, priority: int | None = None,
                  deadline_s: float | None = None) -> float:
        """Coroutine adapter for asyncio servers: ``await frontend.rpc(x)``.
        Backpressure (``FrontendRejected``) propagates to the caller like
        any RPC error."""
        import asyncio
        return await asyncio.wrap_future(
            self.submit(x, priority=priority, deadline_s=deadline_s))

    def predict(self, X: np.ndarray, *, priority: int | None = None,
                deadline_s: float | None = None) -> np.ndarray:
        """Synchronous batch convenience: submits every row, honoring
        backpressure by sleeping out ``retry_after_s``, and gathers."""
        X = np.ascontiguousarray(X, dtype=np.float32)
        if X.ndim == 1:
            X = X[None, :]
        futs = []
        for row in X:
            while True:
                try:
                    futs.append(self.submit(row, priority=priority,
                                            deadline_s=deadline_s))
                    break
                except FrontendRejected as rej:
                    time.sleep(rej.retry_after_s)
        return np.array([f.result() for f in futs], dtype=np.float64)

    def schedule(self, X: np.ndarray, *, objective: str = "energy",
                 deadline_s: float | None = None) -> dict:
        """Deadline-aware per-kernel DVFS scheduling as a tier surface.

        Runs ``core.scheduler.schedule`` over the attached ``devices``
        (a ``serve.MultiDeviceEngine`` or DevicePredictor list) and returns
        a wire-friendly dispatch result: one row per assignment carrying
        the CHOSEN OPERATING POINT (device, freq) next to its predicted
        time/power/start, plus makespan, energy, and whether the deadline
        is met — what ``examples/`` and ``bench_scheduler.py`` turn into
        energy-vs-deadline Pareto rows, and what ``op="schedule"`` ships
        over the wire (``cluster/remote.py``).
        """
        if self.devices is None:
            raise RuntimeError(
                "no devices attached: construct ClusterFrontend(pool, "
                "devices=MultiDeviceEngine(...)) to serve schedules")
        from ..core.scheduler import schedule as _schedule
        X = np.atleast_2d(np.ascontiguousarray(X, dtype=np.float32))
        sched = _schedule(X, self.devices, objective,
                          deadline_s=deadline_s)
        with self._cond:
            self.stats.schedules += 1
        return {
            "objective": objective,
            "deadline_s": deadline_s,
            "assignments": [
                {"kernel": int(a.kernel), "device": a.device,
                 "queue_slot": int(a.queue_slot), "freq": float(a.freq),
                 "t_us": float(a.t_us), "power_w": float(a.power_w),
                 "start_us": float(a.start_us)}
                for a in sched.assignments],
            "makespan_us": sched.makespan_us,
            "energy_j": sched.energy_j,
            "meets_deadline": sched.meets_deadline,
            "predict_seconds": sched.predict_seconds,
        }

    def _retry_after_locked(self) -> float:
        """Drain-time estimate for a full queue: batches ahead x observed
        p50 batch time, split across healthy replicas."""
        healthy = max(len(self.pool.healthy_names()), 1)
        batch_s = (self._engine_s.percentile(50.0) if len(self._engine_s)
                   else self.config.retry_after_s)
        batches = math.ceil(self._queued_rows / self.config.dispatch_batch)
        return max(self.config.retry_after_s, batch_s * batches / healthy)

    # ------------------------------------------------------------- dispatch

    def start(self) -> "ClusterFrontend":
        self.pool.start()
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._dispatch_loop, name="cluster-frontend-dispatch",
                daemon=True)
            self._thread.start()
        return self

    def _release_rows_locked(self, req: _Request) -> None:
        """A request leaving the queue (dispatch, expiry, cancel, close)
        frees its rows from the global bound and its tenant's quota."""
        self._queued_rows -= req.rows
        left = self._tenant_rows.get(req.tenant, 0) - req.rows
        if left > 0:
            self._tenant_rows[req.tenant] = left
        else:
            self._tenant_rows.pop(req.tenant, None)

    def _dispatch_slots(self) -> int:
        """One in-flight dispatch per HEALTHY replica (drained replicas
        hold no slot): with a single survivor, batches leave the ordered
        queue strictly one at a time, preserving dispatch order."""
        return min(self._max_out, max(len(self.pool.healthy_names()), 1))

    def _dispatch_loop(self) -> None:
        while True:
            with self._cond:
                while (not self._closed
                       and (not self._queue
                            or self._dispatching >= self._dispatch_slots())):
                    # the timeout re-checks slot count after probe-driven
                    # revivals, which do not notify this condition
                    self._cond.wait(timeout=0.05)
                if self._closed:
                    return
                batch = []
                for _ in range(min(len(self._queue),
                                   self.config.dispatch_batch)):
                    req = heapq.heappop(self._queue)[3]
                    self._release_rows_locked(req)
                    batch.append(req)
                now = time.monotonic()
                live, expired = [], []
                for req in batch:
                    # claims the future (PENDING -> RUNNING); a future the
                    # caller cancelled while it queued (e.g. the server
                    # abandoning a half-submitted batch) is dropped here —
                    # no engine work for an answer nobody will read
                    if not req.future.set_running_or_notify_cancel():
                        self.stats.cancelled += req.rows
                        self._finish_span(req.queue_span,
                                          outcome="cancelled")
                    elif req.deadline is not None and now > req.deadline:
                        self.stats.expired += req.rows
                        expired.append(req)
                        self._finish_span(req.queue_span, outcome="expired")
                    else:
                        wait = now - req.t_submit
                        self._waits_s.offer(wait)
                        if self._wait_hist is not None:
                            self._wait_hist.observe(wait)
                        if req.queue_span is not None:
                            self._tracer.finish(req.queue_span)
                            req.dispatch_span = self._tracer.start(
                                "dispatch", parent=req.ctx)
                        live.append(req)
                if live:
                    self._dispatching += 1
            # fail expired futures OUTSIDE the lock: set_exception runs
            # user done-callbacks synchronously, and a callback that
            # re-enters submit() would deadlock on the non-reentrant _cond
            for req in expired:
                req.future.set_exception(DeadlineExceeded(
                    f"deadline passed {now - req.deadline:.3f}s "
                    f"before dispatch"))
            if live:
                self._executor.submit(self._dispatch, live)

    def _dispatch(self, reqs: list[_Request]) -> None:
        try:
            self._dispatch_inner(reqs)
        finally:
            with self._cond:
                self._dispatching -= 1
                self._cond.notify_all()

    def _finish_span(self, span: Span | None, **tags) -> None:
        if span is not None:
            self._tracer.finish(span, **tags)

    @staticmethod
    def _stack(reqs: list[_Request]) -> np.ndarray:
        """Rows + batches -> one (N, F) engine call (batch entries keep
        their block contiguous, so results split back by row counts)."""
        return np.concatenate([r.x[None, :] if r.x.ndim == 1 else r.x
                               for r in reqs])

    def _dispatch_inner(self, reqs: list[_Request]) -> None:
        X = self._stack(reqs)
        # the batch inherits its TIGHTEST member deadline: a deadline-aware
        # pool member (remote replica fronting another frontend) re-anchors
        # the remaining budget on its side and orders its own admission
        # queue by it — without this, a dispatched batch silently dropped
        # its requests' deadlines at the pool boundary
        deadlines = [r.deadline for r in reqs if r.deadline is not None]
        tightest = min(deadlines) if deadlines else None
        tried: set[str] = set()
        give_up = time.monotonic() + self.config.no_replica_wait_s
        last_exc: Exception | None = None
        retries_left = self.config.max_retries
        while True:
            replica = self.pool.pick(exclude=tried)
            if replica is None:
                if tried:
                    tried = set()  # all tried failed; allow revived ones
                if time.monotonic() > give_up or self._closed:
                    break
                time.sleep(0.01)   # wait out a probe-driven revival
                continue
            remaining = (None if tightest is None
                         else tightest - time.monotonic())
            t0 = time.perf_counter()
            try:
                if (replica.deadline_aware and remaining is not None
                        and remaining > 0):
                    with self._cond:
                        self.stats.deadlines_forwarded += 1
                    y = np.asarray(
                        replica.engine.predict(X, deadline_s=remaining),
                        dtype=np.float64)
                else:
                    # a burned budget degrades to the plain call — the
                    # dispatcher already failed requests it SAW expire;
                    # late-but-complete beats a guaranteed remote expiry
                    y = np.asarray(replica.engine.predict(X),
                                   dtype=np.float64)
            except DeadlineExceeded as exc:
                # the member expired the TIGHTEST deadline — that tells us
                # nothing about siblings with budget left. Fail only the
                # requests whose own deadline has actually passed, shed the
                # burned deadline, and retry the survivors (the member is
                # busy/honest, not broken — lease released, no drain)
                self.pool.release(replica.name)
                last_exc = exc
                now = time.monotonic()
                dead = [r for r in reqs
                        if r.deadline is not None and r.deadline <= now]
                if dead:
                    with self._cond:
                        self.stats.expired += sum(r.rows for r in dead)
                    for r in dead:
                        self._finish_span(r.dispatch_span,
                                          outcome="expired")
                        r.future.set_exception(exc)
                    gone = {id(r) for r in dead}
                    reqs = [r for r in reqs if id(r) not in gone]
                    if not reqs:
                        return
                    X = self._stack(reqs)
                    deadlines = [r.deadline for r in reqs
                                 if r.deadline is not None]
                    tightest = min(deadlines) if deadlines else None
                else:
                    # the member's own queueing burned the budget before
                    # our clock agrees it is gone: a retry elsewhere may
                    # still make it, but bound the attempts like any
                    # other failure
                    if retries_left <= 0:
                        break
                    retries_left -= 1
                    tried.add(replica.name)
                continue
            except FrontendRejected as exc:
                # a REMOTE member's admission queue is full: busy is not
                # broken — release the lease without feeding the drain
                # counter, honor (a slice of) the retry hint, and try
                # another member; draining a healthy-but-loaded replica
                # would dump its traffic on the survivors and amplify the
                # overload
                self.pool.release(replica.name)
                tried.add(replica.name)
                last_exc = exc
                time.sleep(min(exc.retry_after_s, 0.05))
                continue
            except Exception as exc:
                self.pool.report_failure(replica.name)
                tried.add(replica.name)
                last_exc = exc
                if retries_left <= 0:
                    break
                retries_left -= 1
                with self._cond:
                    self.stats.retries += 1
                continue
            dt = time.perf_counter() - t0
            self.pool.observe(replica.name, dt)
            n_rows = sum(r.rows for r in reqs)
            if self._engine_hist is not None:
                self._engine_hist.observe(dt)
            with self._cond:
                self._engine_s.offer(dt)
                self.stats.dispatches += 1
                self.stats.served += n_rows
                by = self.stats.by_replica
                by[replica.name] = by.get(replica.name, 0) + n_rows
                for req in reqs:
                    t = self.stats.by_tenant.setdefault(
                        req.tenant,
                        {"submitted": 0, "rejected": 0, "served": 0})
                    t["served"] += req.rows
            off = 0
            for req in reqs:
                if req.dispatch_span is not None:
                    # the engine call was timed once for the whole stacked
                    # batch: record that measured duration as each traced
                    # request's engine span
                    self._tracer.record(
                        "engine", parent=req.dispatch_span.ctx, dur_s=dt,
                        replica=replica.name, rows=n_rows)
                    self._finish_span(req.dispatch_span,
                                      replica=replica.name)
                if req.x.ndim == 1:
                    req.future.set_result(float(y[off]))
                else:
                    req.future.set_result(
                        np.asarray(y[off:off + req.rows], dtype=np.float64))
                off += req.rows
            return
        exc = last_exc or RuntimeError("no healthy replicas")
        with self._cond:
            self.stats.failed += sum(r.rows for r in reqs)
        for req in reqs:
            self._finish_span(req.dispatch_span, outcome="failed")
            req.future.set_exception(exc)

    # ---------------------------------------------------------- observability

    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue)

    def queued_rows(self, tenant: str | None = None) -> int:
        """Rows currently queued (what ``max_queue`` bounds); with
        ``tenant``, that tenant's share (what its quota bounds)."""
        with self._cond:
            if tenant is None:
                return self._queued_rows
            return self._tenant_rows.get(tenant, 0)

    def stats_snapshot(self) -> FrontendStats:
        """Atomic copy of the stats under the dispatch lock.

        Individual fields are mutated one at a time during dispatch, so
        reading ``.stats`` field-by-field from another thread can observe
        torn totals (e.g. ``served`` incremented but ``by_replica`` not
        yet).  This is the consistent read everything downstream (tests,
        benches, exposition) should use."""
        with self._cond:
            s = self.stats
            return replace(
                s, by_replica=dict(s.by_replica),
                by_tenant={k: dict(v) for k, v in s.by_tenant.items()})

    def latency_summary(self) -> dict[str, float]:
        """Queue-wait and engine-time percentiles (ms) from the bounded
        reservoirs — the bench_latency frontend rows.  Stable on long
        runs: Algorithm R keeps the sample representative of the whole
        run in O(latency_window) memory."""
        out = {}
        for label, res in (("wait", self._waits_s),
                           ("engine", self._engine_s)):
            empty = len(res) == 0
            for p in (50, 99):
                out[f"{label}_p{p}_ms"] = (
                    0.0 if empty else res.percentile(p) * 1e3)
        return out

    # ------------------------------------------------------------- lifecycle

    def close(self, *, close_pool: bool = True) -> None:
        """Shut the tier down: dispatcher joined, in-flight dispatches
        drained, queued futures failed, and (default) the pool — health
        thread, attached refreshers, engines — closed too. Idempotent."""
        with self._cond:
            first = not self._closed
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        self._executor.shutdown(wait=True)
        if first:
            with self._cond:
                leftovers = [req for _, _, _, req in self._queue]
                self._queue.clear()
                self._queued_rows = 0
                self._tenant_rows.clear()
            for req in leftovers:
                # still-queued futures are PENDING; claim each one first so
                # a caller's concurrent cancel cannot race set_exception
                if req.future.set_running_or_notify_cancel():
                    req.future.set_exception(RuntimeError("frontend closed"))
            if close_pool:
                self.pool.close()

    def __enter__(self) -> "ClusterFrontend":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
