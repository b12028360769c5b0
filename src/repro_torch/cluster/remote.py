"""Cross-host serving: ``PredictionServer`` + ``RemoteReplica``.

This is the piece that takes the cluster tier across the host boundary —
the ROADMAP's "real network transport". The paper's deployment argument
(§7.1: predictions cheap enough to sit inline in a scheduler's dispatch
loop) only becomes a SYSTEM claim when the scheduler does not live on the
machine that fitted the model; related cross-machine work (Stevens &
Klöckner, arXiv:1904.09538; Ilager et al., arXiv:2004.08177) assumes
exactly that split.

Two halves, one protocol (``transport.py``):

  * ``PredictionServer`` exposes a ``ClusterFrontend`` on a TCP socket: a
    BOUNDED accept loop (at most ``max_connections`` live connections —
    admission control at the socket layer, mirroring the frontend's bounded
    queue), one handler thread per connection, and a graceful drain on
    ``close()`` — in-flight requests finish, laggards are cut after
    ``drain_s``.
  * ``RemoteReplica`` is the client side, shaped like an ENGINE: it
    implements the ``serve.backend.ServingEngine`` surface (``predict`` /
    ``close`` / ``n_features`` / ``stats``) so a ``ReplicaPool`` can hold
    remote pool members next to in-process ones. Health probes,
    consecutive-failure draining, probe-driven revival, and p50-weighted
    routing all work unchanged: a dead server makes ``predict`` raise a
    retryable ``TransportError``, which the pool counts exactly like any
    dispatch failure; when the server returns, probes revive the member.

Handshake (protocol v3). A new connection opens with a ``hello`` op inside
a plain v2 JSON frame carrying ``max_v`` (and, for multi-tenant servers,
``tenant`` + ``token``). A v3-capable server answers ``accept_v =
min(max_v, 3)`` — after that reply BOTH ends switch to the binary framing
(``transport.send_frame_v3``): features as raw ``<f4`` payload bytes,
predictions as raw ``<f8``, zero per-element Python work. A legacy server
answers ``BadRequest: unknown op 'hello'`` and KEEPS the connection open,
so the client falls back to v2 JSON on the same socket — mixed fleets
interoperate per connection and rolling upgrades work in both directions.

Pipelining. One connection carries MANY in-flight request ids at once:
``RemoteReplica`` sends under a lock and a dedicated reader thread matches
replies (out of order) back to waiters by id, so concurrent ``predict``
calls share one socket instead of serializing on round-trips. The server
answers v3 predicts ASYNCHRONOUSLY — the frame becomes one
``ClusterFrontend.submit_batch`` entry and the reply is written from the
future's done-callback — so a slow batch does not head-of-line-block the
frames behind it. Per-request deadline budgets ride along unchanged.

Auth. ``PredictionServer(tenants={"name": "token"})`` requires every
connection to authenticate at the hello (``hmac.compare_digest``; wire
error ``Unauthorized`` -> client-side ``AuthError``); the authenticated
tenant binds the connection and every row it submits is charged to that
tenant's ``ClusterFrontend`` admission quota (``tenant_quotas``). Works
for v2-pinned peers too: a hello with ``max_v=2`` authenticates and stays
on JSON framing.

Deadline/priority end-to-end: ``predict(X, deadline_s=..., priority=None)``
ships the REMAINING budget as ``deadline_ms``; the server re-anchors it on
arrival and (when ``priority`` is None) lets the frontend derive the
admission priority from the remaining slack (``core.scheduler.slack_priority``)
— a remote scheduler's tight-deadline requests jump the queue end to end
without the caller choosing magic ints.

CLI (used by the CI transport smoke step, tests, and the two-host runbook
in ``docs/transport.md``)::

    PYTHONPATH=src python -m repro_torch.cluster --port 7571   # serve
    PYTHONPATH=src python -m repro_torch.cluster --selftest    # smoke

A copy of ``repro.cluster.remote``: the wire format, protocol versions and
auth are the reference's byte for byte. What differs is the device: the
demo server's forest is served on the card by the CUDA forest kernel
(``--device cuda``, the default; ``ForestEngine``'s ``hopper`` backend),
or on the host by the reference's ``flat-numpy`` path (``--device cpu``).
"""
from __future__ import annotations

import hmac
import math
import os
import socket
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..obs import Observability, TraceContext, ctx_from_meta, ctx_to_meta
from .frontend import ClusterFrontend
from .transport import (PROTOCOL_V3, PROTOCOL_VERSION, AuthError,
                        ProtocolError, TransportError, decode_error,
                        encode_error, pack_array, recv_frame, recv_frame_v3,
                        request_id, send_frame, send_frame_v3, unpack_array)

__all__ = ["PredictionServer", "RemoteReplica", "RemoteStats",
           "demo_estimator", "demo_frontend", "spawn_demo_server"]

DEFAULT_PORT = 7571


# -------------------------------------------------------------------- server

class _ConnState:
    """Per-connection negotiation + auth state. ``mode`` flips from
    ``"json"`` to ``"v3"`` only AFTER the hello reply went out in the old
    framing (``next_mode`` staging), so both ends switch on the same frame
    boundary. ``send_lock`` serializes the out-of-order async replies."""

    __slots__ = ("conn", "mode", "next_mode", "tenant", "authed",
                 "send_lock")

    def __init__(self, conn: socket.socket):
        self.conn = conn
        self.mode = "json"
        self.next_mode: str | None = None
        self.tenant: str | None = None
        self.authed = False
        self.send_lock = threading.Lock()

    @property
    def wire_v(self) -> int:
        return PROTOCOL_V3 if self.mode == "v3" else PROTOCOL_VERSION

class PredictionServer:
    """Serve a ``ClusterFrontend`` on a TCP socket (see module docstring)."""

    def __init__(self, frontend: ClusterFrontend, host: str = "127.0.0.1",
                 port: int = 0, *, max_connections: int = 32,
                 backlog: int = 16, drain_s: float = 5.0,
                 result_timeout_s: float = 30.0,
                 tenants: dict[str, str] | None = None,
                 obs: Observability | None = None,
                 metrics_port: int | None = None):
        if max_connections < 1:
            raise ValueError("max_connections must be >= 1")
        self.frontend = frontend
        self.tenants = dict(tenants) if tenants is not None else None
        self.host, self.port = host, port
        self.backlog = backlog
        self.drain_s = drain_s
        self.result_timeout_s = result_timeout_s
        self.requests_served = 0
        self.requests_failed = 0
        # observability is OPT-IN: obs=None costs nothing on the serving
        # path. metrics_port (0 = ephemeral) additionally starts a
        # Prometheus-text HTTP endpoint at start(); it implies obs.
        if obs is None and metrics_port is not None:
            obs = Observability.default()
        self.obs = obs
        self.metrics_port = metrics_port
        self.metrics_address: tuple[str, int] | None = None
        self._metrics_httpd = None
        if obs is not None:
            reg = obs.registry
            reg.register_fn("server.requests_served",
                            lambda: self.requests_served, kind="counter")
            reg.register_fn("server.requests_failed",
                            lambda: self.requests_failed, kind="counter")
            reg.register_fn("server.connections", lambda: len(self._conns))
            reg.register_fn("server.in_flight", lambda: self._in_flight)
        self._sem = threading.BoundedSemaphore(max_connections)
        self._lock = threading.Lock()
        self._conns: set[socket.socket] = set()
        self._handlers: list[threading.Thread] = []
        self._in_flight = 0
        self._listener: socket.socket | None = None
        self._accept_thread: threading.Thread | None = None
        self._closing = threading.Event()

    @property
    def address(self) -> tuple[str, int]:
        """(host, port) actually bound — port 0 resolves at ``start``."""
        return self.host, self.port

    def start(self) -> "PredictionServer":
        if self._listener is not None:
            return self
        self.frontend.start()
        lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        lst.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        lst.bind((self.host, self.port))
        lst.listen(self.backlog)
        self.host, self.port = lst.getsockname()
        self._listener = lst
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="prediction-server-accept",
            daemon=True)
        self._accept_thread.start()
        if self.metrics_port is not None:
            self._start_metrics_endpoint()
        return self

    def _start_metrics_endpoint(self) -> None:
        """Prometheus text exposition on a plain stdlib HTTP server
        (``GET /metrics``); scrape-only, never on the predict path."""
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        registry = self.obs.registry

        class _MetricsHandler(BaseHTTPRequestHandler):
            def do_GET(handler):            # noqa: N805 - stdlib signature
                if handler.path.split("?")[0] not in ("/metrics", "/"):
                    handler.send_error(404)
                    return
                body = registry.render_prometheus().encode()
                handler.send_response(200)
                handler.send_header("Content-Type",
                                    "text/plain; version=0.0.4")
                handler.send_header("Content-Length", str(len(body)))
                handler.end_headers()
                handler.wfile.write(body)

            def log_message(self, *args):   # quiet: no per-scrape stderr
                pass

        httpd = ThreadingHTTPServer((self.host, self.metrics_port),
                                    _MetricsHandler)
        httpd.daemon_threads = True
        self._metrics_httpd = httpd
        self.metrics_address = httpd.server_address[:2]
        threading.Thread(target=httpd.serve_forever,
                         name="prediction-server-metrics",
                         daemon=True).start()

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            # the semaphore BOUNDS the accept loop: at max_connections live
            # connections we stop accepting, and the kernel backlog (then
            # connection refusal) pushes back on new clients
            if not self._sem.acquire(timeout=0.1):
                continue
            try:
                conn, _peer = self._listener.accept()
            except OSError:                      # listener closed: drain
                self._sem.release()
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.add(conn)
                handler = threading.Thread(
                    target=self._serve_conn, args=(conn,),
                    name="prediction-server-conn", daemon=True)
                # prune finished handlers so a long-lived server does not
                # accumulate dead Thread objects
                self._handlers = [h for h in self._handlers if h.is_alive()]
                self._handlers.append(handler)
            handler.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        state = _ConnState(conn)
        try:
            while not self._closing.is_set():
                try:
                    if state.mode == "v3":
                        got = recv_frame_v3(conn)
                        frame, payload = (None, b"") if got is None else got
                    else:
                        frame, payload = recv_frame(conn), b""
                except TransportError:
                    return                       # peer died mid-frame
                except ProtocolError as exc:
                    # a peer not speaking the protocol gets one explanatory
                    # error frame, then the connection is dropped
                    self._respond_state(
                        state, {"v": state.wire_v, "id": None, "ok": False,
                                "error": encode_error(exc)})
                    return
                if frame is None:
                    return                       # clean EOF
                with self._lock:
                    self._in_flight += 1
                try:
                    # the reply send counts as in-flight too: the graceful
                    # drain must not cut a connection between computing a
                    # result and writing it back
                    reply, keep_open = self._handle(state, frame, payload)
                    sent = (True if reply is None     # async v3 reply pending
                            else self._respond_state(state, *reply))
                finally:
                    with self._lock:
                        self._in_flight -= 1
                if not sent or not keep_open:
                    return
                if state.next_mode is not None:
                    # the hello reply went out in the OLD framing; every
                    # frame after it is binary on both ends
                    state.mode, state.next_mode = state.next_mode, None
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._conns.discard(conn)
            self._sem.release()

    def _respond_state(self, state: _ConnState, reply: dict,
                       payload: bytes = b"") -> bool:
        """Send one reply in the connection's CURRENT framing. The send
        lock serializes inline replies with async v3 done-callbacks."""
        try:
            with state.send_lock:
                if state.mode == "v3":
                    send_frame_v3(state.conn, reply, payload)
                else:
                    send_frame(state.conn, reply)
            return True
        except (TransportError, ProtocolError):
            return False                         # peer gone mid-reply

    # ------------------------------------------------------------- handlers

    def _handle(self, state: _ConnState, frame: dict,
                payload: bytes) -> tuple[tuple[dict, bytes] | None, bool]:
        """One request frame -> ((reply meta, reply payload) | None, keep
        connection open). ``None`` means the reply is ASYNC (v3 predict):
        the frontend future's done-callback writes it later."""
        rid = frame.get("id")
        version = frame.get("v")
        expected = state.wire_v
        if version != expected:
            # ProtocolMismatch closes the connection: the peer cannot get
            # luckier on its next frame, and the error names both versions
            return (({"v": expected, "id": rid, "ok": False,
                      "error": {"type": "ProtocolMismatch",
                                "message": f"server speaks protocol "
                                           f"v{expected} on this "
                                           f"connection, request "
                                           f"was v{version}",
                                "server_version": PROTOCOL_VERSION}}, b""),
                    False)
        op = frame.get("op")
        try:
            if (self.tenants is not None and not state.authed
                    and op != "hello"):
                raise AuthError("authentication required: send a 'hello' "
                                "with tenant and token before any other op")
            if op == "predict":
                if state.mode == "v3":
                    self._op_predict_v3(state, frame, payload)
                    return None, True            # reply from done-callback
                body = self._op_predict(frame, tenant=state.tenant)
            elif op == "schedule":
                X = (self._peer_array(frame, payload)
                     if state.mode == "v3" else self._peer_x(frame))
                body = self._op_schedule(frame, X)
            elif op == "hello":
                body = self._op_hello(state, frame)
            elif op == "info":
                body = self._op_info()
            elif op == "metrics":
                body = self._op_metrics()
            elif op == "ping":
                body = {}
            else:
                raise ProtocolError(f"unknown op {op!r}")
        except Exception as exc:                 # mapped onto the wire
            self.requests_failed += 1
            # a failed auth closes the connection; everything else leaves
            # the peer free to try again on the same socket
            keep = not isinstance(exc, AuthError)
            return (({"v": expected, "id": rid, "ok": False,
                      "error": encode_error(exc)}, b""), keep)
        self.requests_served += 1
        return ({"v": expected, "id": rid, "ok": True, **body}, b""), True

    def _op_hello(self, state: _ConnState, frame: dict) -> dict:
        """Version negotiation (+ tenant auth when configured). The reply
        carries ``accept_v = min(client max_v, 3)``; at accept_v >= 3 the
        NEXT frame in both directions is binary (``next_mode`` staging)."""
        max_v = frame.get("max_v")
        if not isinstance(max_v, int) or max_v < PROTOCOL_VERSION:
            raise ProtocolError(f"bad 'max_v': {max_v!r} (int >= "
                                f"{PROTOCOL_VERSION})")
        tenant = frame.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise ProtocolError(f"bad 'tenant': {tenant!r} (str or absent)")
        if self.tenants is not None:
            token = frame.get("token")
            if not isinstance(tenant, str) or not isinstance(token, str):
                raise AuthError("server requires tenant auth: hello must "
                                "carry 'tenant' and 'token'")
            want = self.tenants.get(tenant)
            # compare_digest against a dummy on unknown tenants keeps the
            # rejection path constant-time-ish either way
            if want is None or not hmac.compare_digest(want, token):
                raise AuthError(f"bad credentials for tenant {tenant!r}")
            state.authed = True
        state.tenant = tenant
        accept = min(max_v, PROTOCOL_V3)
        if accept >= PROTOCOL_V3:
            state.next_mode = "v3"
        return {"accept_v": accept, "server_version": PROTOCOL_VERSION,
                "n_features": self.frontend.n_features, "tenant": tenant}

    @staticmethod
    def _peer_x(frame: dict) -> np.ndarray:
        """PEER-CONTROLLED batch field, validated before it reaches any
        shared frontend state."""
        try:
            return np.atleast_2d(np.asarray(frame["x"], dtype=np.float32))
        except (KeyError, TypeError, ValueError) as exc:
            raise ProtocolError(f"bad 'x' field: {exc}") from exc

    @staticmethod
    def _peer_array(frame: dict, payload: bytes) -> np.ndarray:
        """v3 twin of ``_peer_x``: features arrive as the raw binary
        payload described by the frame's ``array`` descriptor."""
        X = unpack_array(frame.get("array"), payload)
        if X.dtype != np.float32:
            raise ProtocolError(
                f"feature payload must be <f4, got {X.dtype.str!r}")
        return np.atleast_2d(X)

    @staticmethod
    def _peer_deadline_s(frame: dict) -> float | None:
        """Remaining-budget ``deadline_ms`` -> seconds (None when absent).
        An already-spent budget fails fast BEFORE the admission queue —
        the wire twin of the dispatcher's expiry check."""
        from .frontend import DeadlineExceeded

        if frame.get("deadline_ms") is None:
            return None
        try:
            budget_s = float(frame["deadline_ms"]) / 1e3
        except (TypeError, ValueError) as exc:
            raise ProtocolError(
                f"bad 'deadline_ms': {frame['deadline_ms']!r}") from exc
        if budget_s <= 0:
            raise DeadlineExceeded(
                f"deadline expired {-budget_s:.3f}s before arrival")
        return budget_s

    @staticmethod
    def _peer_priority(frame: dict) -> int | None:
        priority = frame.get("priority")
        if priority is not None and not isinstance(priority, int):
            raise ProtocolError(f"bad 'priority': {priority!r} (int or "
                                f"absent)")
        return priority

    def _peer_trace(self, frame: dict) -> TraceContext | None:
        """Trace context from the frame meta (``"trace"`` key) — only
        honored when this server carries an observability bundle; always
        tolerant (a malformed or absent context means 'untraced')."""
        if self.obs is None:
            return None
        return ctx_from_meta(frame.get("trace"))

    def _reply_spans(self, ctx: TraceContext | None, t0: float,
                     body: dict) -> dict:
        """Close the server-side story of a traced request: record the
        ``reply`` span (result -> frame assembly; the socket write itself
        cannot be included, its bytes ARE the reply) and attach every
        span of the trace so the client reconstructs the full tree."""
        if ctx is not None:
            tracer = self.obs.tracer
            tracer.record("reply", parent=ctx,
                          dur_s=time.perf_counter() - t0)
            body["spans"] = tracer.export(ctx.trace_id)
        return body

    def _op_predict(self, frame: dict, tenant: str | None = None) -> dict:
        X = self._peer_x(frame)
        t_arrival = time.monotonic()
        budget_s = self._peer_deadline_s(frame)
        priority = self._peer_priority(frame)
        ctx = self._peer_trace(frame)
        futures = []
        try:
            for row in X:
                remaining = (None if budget_s is None
                             else budget_s - (time.monotonic() - t_arrival))
                futures.append(self.frontend.submit(
                    row, priority=priority, deadline_s=remaining,
                    tenant=tenant, trace_ctx=ctx))
            timeout = (self.result_timeout_s if budget_s is None
                       else budget_s + 1.0)
            y = [f.result(timeout=timeout) for f in futures]
        except Exception:
            # a mid-batch failure (rejection, expiry, timeout) fails the
            # whole frame — cancel the queued siblings so an overloaded
            # frontend is not also dispatching answers nobody will read
            for f in futures:
                f.cancel()
            raise
        return self._reply_spans(ctx, time.perf_counter(), {"y": y})

    def _op_predict_v3(self, state: _ConnState, frame: dict,
                       payload: bytes) -> None:
        """v3 predict: the whole (B, F) payload becomes ONE
        ``submit_batch`` entry and the reply is written from the future's
        done-callback — the connection loop is already reading the next
        frame while this one computes (no head-of-line blocking).

        Synchronous failures (bad payload, rejection at admission) raise
        back into ``_handle`` and go out as an inline error reply."""
        X = self._peer_array(frame, payload)
        budget_s = self._peer_deadline_s(frame)
        priority = self._peer_priority(frame)
        ctx = self._peer_trace(frame)
        rid = frame.get("id")
        fut = self.frontend.submit_batch(X, priority=priority,
                                         deadline_s=budget_s,
                                         tenant=state.tenant,
                                         trace_ctx=ctx)
        # count the pending reply as in-flight so a graceful drain waits
        # for the done-callback's send, not just the recv loop
        with self._lock:
            self._in_flight += 1
        fut.add_done_callback(
            lambda f: self._finish_v3(state, rid, f, ctx))

    def _finish_v3(self, state: _ConnState, rid, fut,
                   ctx: TraceContext | None = None) -> None:
        """Done-callback for an async v3 predict: ship result or error."""
        t0 = time.perf_counter()
        try:
            try:
                y = np.asarray(fut.result(), dtype=np.float64).reshape(-1)
            except BaseException as exc:         # incl. CancelledError
                self.requests_failed += 1
                self._respond_state(
                    state, {"v": PROTOCOL_V3, "id": rid, "ok": False,
                            "error": encode_error(exc),
                            **self._reply_spans(ctx, t0, {})})
                return
            desc, pl = pack_array(y)
            self.requests_served += 1
            self._respond_state(
                state, {"v": PROTOCOL_V3, "id": rid, "ok": True,
                        "array": desc,
                        **self._reply_spans(ctx, t0, {})}, pl)
        finally:
            with self._lock:
                self._in_flight -= 1

    def _op_schedule(self, frame: dict, X: np.ndarray) -> dict:
        """Deadline-aware DVFS scheduling over the wire: the frontend picks
        (device, frequency) per kernel and the dispatch result carries the
        chosen operating points back to the remote caller."""
        objective = frame.get("objective", "energy")
        if objective not in ("makespan", "energy", "edp"):
            # core schedule() would reject it too, but a peer's typo is a
            # BadRequest, not an Internal
            raise ProtocolError(f"bad 'objective': {objective!r} "
                                f"(makespan | energy | edp)")
        budget_s = self._peer_deadline_s(frame)
        return self.frontend.schedule(X, objective=objective,
                                      deadline_s=budget_s)

    def _op_info(self) -> dict:
        return {"server_version": PROTOCOL_VERSION,
                "n_features": self.frontend.n_features,
                "replicas": self.frontend.pool.names,
                "healthy": self.frontend.pool.healthy_names(),
                "queue_len": self.frontend.queue_len()}

    def _op_metrics(self) -> dict:
        """Scrape over the existing socket: the registry snapshot (plus
        slow-request samples) as plain JSON.  A server without an
        observability bundle answers honestly rather than erroring, so
        ``--stats`` against any server degrades instead of failing."""
        if self.obs is None:
            return {"enabled": False, "metrics": []}
        rows = self.obs.registry.snapshot()
        for row in rows:         # NaN (empty histogram) is not valid JSON
            for k, v in row.items():
                if isinstance(v, float) and not math.isfinite(v):
                    row[k] = None
        body: dict = {"enabled": True, "metrics": rows,
                      "slow": list(self.obs.tracer.slow)}
        cal = self.obs.calibration
        if cal is not None:
            body["calibration"] = [
                {"device": d, "target": t, "mape_pct": m, "n": n}
                for (d, t), (m, n) in sorted(cal.series().items())]
        return body

    # ------------------------------------------------------------ lifecycle

    def close(self, *, close_frontend: bool = True) -> None:
        """Graceful drain: stop accepting, let in-flight requests finish
        (up to ``drain_s``), then cut remaining connections. Idempotent."""
        if self._closing.is_set():
            return
        self._closing.set()
        if self._metrics_httpd is not None:
            self._metrics_httpd.shutdown()
            self._metrics_httpd.server_close()
            self._metrics_httpd = None
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        give_up = time.monotonic() + self.drain_s
        while time.monotonic() < give_up:
            with self._lock:
                if self._in_flight == 0:
                    break
            time.sleep(0.01)
        with self._lock:
            conns = list(self._conns)
        for conn in conns:                       # unblock handler recv()s
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
            self._accept_thread = None
        # close the frontend BEFORE joining handlers: it fails every queued
        # future, unblocking any handler cut mid-request out of its result()
        if close_frontend:
            self.frontend.close()
        with self._lock:
            handlers = list(self._handlers)
            self._handlers.clear()
        for handler in handlers:
            handler.join(timeout=5.0)

    def __enter__(self) -> "PredictionServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()


# -------------------------------------------------------------------- client

@dataclass
class RemoteStats:
    calls: int = 0                 # predict round-trips attempted
    rows: int = 0                  # rows answered
    connects: int = 0              # connections established (1 = no faults)
    resends: int = 0               # send-side retries on a stale connection
    transport_errors: int = 0      # retryable failures surfaced to the pool
    remote_errors: int = 0         # server-mapped errors (rejected/expired/…)
    max_in_flight: int = 0         # peak concurrent requests on one socket
    rtt_s: deque = field(default_factory=lambda: deque(maxlen=256))


class _Pending:
    """One awaited reply: the sender parks on ``event``; the reader thread
    fills ``meta``/``payload`` (or ``error``) and sets it. ``sock`` tags
    which connection the request went out on, so a dying reader only fails
    ITS OWN pendings — not ones already resent on a fresh connection."""

    __slots__ = ("event", "meta", "payload", "error", "sock")

    def __init__(self, sock: socket.socket):
        self.event = threading.Event()
        self.meta: dict | None = None
        self.payload: bytes = b""
        self.error: Exception | None = None
        self.sock = sock


class RemoteReplica:
    """Engine-shaped client for a ``PredictionServer`` (see module doc).

    Satisfies ``serve.backend.ServingEngine`` so a ``ReplicaPool`` can hold
    it: ``predict`` raises retryable ``TransportError`` while the server is
    unreachable (driving drain + failover) and works again as soon as it is
    back (probes revive the member). One socket carries MANY in-flight
    requests: senders register a pending entry by request id, a dedicated
    reader thread matches replies back (out of order), so concurrent
    ``predict`` calls pipeline instead of serializing on round-trips.

    ``protocol`` pins the wire dialect: 3 (default) negotiates the binary
    zero-copy framing at the hello and falls back to v2 JSON against
    legacy servers; 2 skips negotiation entirely and speaks JSON — how a
    not-yet-upgraded peer in a rolling deploy behaves. ``tenant``/``token``
    authenticate against a multi-tenant server at either protocol.
    """

    def __init__(self, host: str | tuple[str, int] = "127.0.0.1",
                 port: int | None = None, *, timeout_s: float = 30.0,
                 connect_timeout_s: float = 2.0,
                 n_features: int | None = None, name: str | None = None,
                 protocol: int = PROTOCOL_V3, tenant: str | None = None,
                 token: str | None = None,
                 obs: Observability | None = None):
        if protocol not in (PROTOCOL_VERSION, PROTOCOL_V3):
            raise ValueError(f"protocol must be {PROTOCOL_VERSION} or "
                             f"{PROTOCOL_V3}, got {protocol!r}")
        if isinstance(host, tuple):
            host, port = host
        self.host = host
        self.port = DEFAULT_PORT if port is None else int(port)
        self.name = name or f"{self.host}:{self.port}"
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.n_features = n_features
        self.protocol = protocol
        self.tenant = tenant
        self.token = token
        self.server_info: dict = {}
        self.negotiated_version: int | None = None
        self.obs = obs
        self.stats = RemoteStats()
        if obs is not None:
            reg = obs.registry
            for sname in ("calls", "rows", "connects", "resends",
                          "transport_errors", "remote_errors"):
                reg.register_fn(f"remote.{sname}",
                                lambda n=sname: getattr(self.stats, n),
                                kind="counter", replica=self.name)
            reg.register_fn("remote.max_in_flight",
                            lambda: self.stats.max_in_flight,
                            replica=self.name)
        self._conn_lock = threading.Lock()       # connection lifecycle
        self._send_lock = threading.Lock()       # frame writes interleave
        self._pend_lock = threading.Lock()       # pending-reply table
        self._pending: dict[str, _Pending] = {}
        self._sock: socket.socket | None = None
        self._mode_v3 = False
        self._reader: threading.Thread | None = None
        self._closed = False

    # ---------------------------------------------------------- connection

    def _connect_locked(self) -> None:
        """Dial + handshake (holds ``_conn_lock``). Synchronous round-trips
        are safe here: the reader thread starts only after negotiation."""
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout_s)
        except OSError as exc:
            raise TransportError(
                f"connect to {self.host}:{self.port} failed: {exc}") from exc
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self.timeout_s)
        self.stats.connects += 1
        negotiated = PROTOCOL_VERSION
        info: dict | None = None
        try:
            if self.protocol >= PROTOCOL_V3 or self.token is not None:
                hello: dict = {"v": PROTOCOL_VERSION, "id": request_id(),
                               "op": "hello", "max_v": self.protocol}
                if self.tenant is not None:
                    hello["tenant"] = self.tenant
                if self.token is not None:
                    hello["token"] = self.token
                try:
                    resp = self._sync_roundtrip(sock, hello)
                except AuthError:
                    raise                        # bad creds: NOT retryable
                except ProtocolError:
                    # legacy server: BadRequest on the unknown op, but the
                    # connection stays open — fall back to v2 JSON on it
                    resp = None
                if resp is not None:
                    negotiated = min(int(resp.get("accept_v",
                                                  PROTOCOL_VERSION)),
                                     self.protocol)
                    info = resp
            if negotiated < PROTOCOL_V3 and (
                    info is None or info.get("n_features") is None):
                # pre-v3 path: one info round-trip pins the server version
                # and feature width before any prediction traffic
                info = self._sync_roundtrip(
                    sock, {"v": PROTOCOL_VERSION, "id": request_id(),
                           "op": "info"})
            self.server_info = info or {}
            if info and info.get("n_features") is not None:
                if (self.n_features is not None
                        and self.n_features != info["n_features"]):
                    raise ProtocolError(
                        f"server serves {info['n_features']} features, "
                        f"client configured for {self.n_features}")
                self.n_features = info["n_features"]
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        sock.settimeout(None)                    # reader blocks; waiters time
        self._sock = sock
        self._mode_v3 = negotiated >= PROTOCOL_V3
        self.negotiated_version = negotiated
        self._reader = threading.Thread(
            target=self._read_loop, args=(sock, self._mode_v3),
            name=f"remote-replica-reader-{self.name}", daemon=True)
        self._reader.start()

    @staticmethod
    def _sync_roundtrip(sock: socket.socket, req: dict) -> dict:
        """One JSON round-trip on a not-yet-pipelined socket (handshake
        only). Raises the decoded error on a failure frame — counting is
        the caller's concern, not this helper's."""
        send_frame(sock, req)
        while True:
            try:
                resp = recv_frame(sock)
            except TransportError as exc:
                raise TransportError(f"awaiting {req['id']}: {exc}") from exc
            if resp is None:
                raise TransportError(
                    "server closed the connection mid-request")
            if resp.get("id") in (req["id"], None):
                break                            # None: pre-parse error frame
        if resp.get("ok"):
            return resp
        raise decode_error(resp.get("error", {}))

    def _read_loop(self, sock: socket.socket, v3: bool) -> None:
        """Reader thread: match replies (out of order) to pending waiters.
        Any failure fails every pending request ON THIS SOCKET and exits —
        the next call reconnects."""
        try:
            while True:
                if v3:
                    got = recv_frame_v3(sock)
                    if got is None:
                        raise TransportError("server closed the connection")
                    meta, payload = got
                else:
                    meta = recv_frame(sock)
                    if meta is None:
                        raise TransportError("server closed the connection")
                    payload = b""
                rid = meta.get("id")
                if rid is None:
                    # pre-parse error frame: poisons the whole connection
                    exc = decode_error(meta.get("error", {}))
                    if not isinstance(exc, (TransportError, ProtocolError)):
                        exc = ProtocolError(f"unaddressed error frame: "
                                            f"{exc}")
                    raise exc
                with self._pend_lock:
                    pend = self._pending.get(rid)
                    if pend is not None and pend.sock is sock:
                        del self._pending[rid]
                    else:
                        pend = None              # stale/unknown id: skip
                if pend is not None:
                    pend.meta, pend.payload = meta, payload
                    pend.event.set()
        except (TransportError, ProtocolError) as exc:
            self._teardown(sock, exc)
        except OSError as exc:
            self._teardown(sock, TransportError(f"recv failed: {exc}"))

    def _teardown(self, sock: socket.socket, exc: Exception) -> None:
        """Kill one connection: detach it (if still current), close it,
        fail every pending request that went out on it. Lock order is
        always ``_conn_lock`` -> ``_pend_lock``."""
        with self._conn_lock:
            if self._sock is sock:
                self._sock = None
                self._mode_v3 = False
            try:
                sock.close()
            except OSError:
                pass
            with self._pend_lock:
                mine = [rid for rid, p in self._pending.items()
                        if p.sock is sock]
                for rid in mine:
                    p = self._pending.pop(rid)
                    p.error = exc
                    p.event.set()

    def _ensure_connected(self) -> tuple[socket.socket, bool, bool]:
        """-> (sock, v3 framing, fresh). ``fresh`` gates the one-resend
        retry: a request that failed on a brand-new connection does not
        get a second attempt (the server is really down)."""
        with self._conn_lock:
            if self._closed:
                raise TransportError("replica is closed")
            if self._sock is not None:
                return self._sock, self._mode_v3, False
            self._connect_locked()
            return self._sock, self._mode_v3, True

    # ------------------------------------------------------------ calls

    def _call_op(self, op: str, fields: dict | None = None,
                 X: np.ndarray | None = None, *,
                 timeout: float | None = None) -> tuple[dict, bytes]:
        """One pipelined request -> (reply meta, reply payload).

        Retry discipline (same as the pre-pipelining client): a
        ``TransportError`` on a STALE pooled connection gets ONE resend on
        a fresh one (the server may simply have restarted between calls —
        predictions are idempotent); a failure on a fresh connection
        raises immediately.
        """
        for attempt in (0, 1):
            fresh = True                         # a failed DIAL never retries
            try:
                sock, v3, fresh = self._ensure_connected()
                return self._attempt(sock, v3, op, fields, X,
                                     timeout=timeout)
            except TransportError:
                if attempt or fresh or self._closed:
                    raise
                self.stats.resends += 1

    def _attempt(self, sock: socket.socket, v3: bool, op: str,
                 fields: dict | None, X: np.ndarray | None, *,
                 timeout: float | None) -> tuple[dict, bytes]:
        rid = request_id()
        payload = b""
        meta: dict = {"v": PROTOCOL_V3 if v3 else PROTOCOL_VERSION,
                      "id": rid, "op": op, **(fields or {})}
        if X is not None:
            if v3:
                desc, payload = pack_array(X)
                meta["array"] = desc
            else:
                meta["x"] = X.tolist()
        pend = _Pending(sock)
        with self._pend_lock:
            self._pending[rid] = pend
            n = len(self._pending)
            if n > self.stats.max_in_flight:
                self.stats.max_in_flight = n
        try:
            try:
                with self._send_lock:
                    if v3:
                        send_frame_v3(sock, meta, payload)
                    else:
                        send_frame(sock, meta)
            except (TransportError, ProtocolError) as exc:
                err = (exc if isinstance(exc, TransportError)
                       else TransportError(f"send failed: {exc}"))
                self._teardown(sock, err)
                raise err from exc
            if not pend.event.wait(timeout if timeout is not None
                                   else self.timeout_s):
                err = TransportError(f"awaiting {rid}: timed out")
                self._teardown(sock, err)
                raise err
        finally:
            with self._pend_lock:
                self._pending.pop(rid, None)
        if pend.error is not None:
            raise pend.error
        resp = pend.meta
        if resp.get("ok"):
            return resp, pend.payload
        exc = decode_error(resp.get("error", {}))
        if isinstance(exc, (TransportError, ProtocolError)):
            # draining / mismatched peer: the connection is done for
            self._teardown(sock, exc if isinstance(exc, TransportError)
                           else TransportError(str(exc)))
        if not isinstance(exc, TransportError):
            # transport-mapped frames (Unavailable) are counted once, as
            # transport_errors, by the caller — not as server-side errors
            self.stats.remote_errors += 1
        raise exc

    # -------------------------------------------------------------- engine

    def predict(self, X: np.ndarray, *, deadline_s: float | None = None,
                priority: int | None = None,
                trace_ctx: TraceContext | None = None) -> np.ndarray:
        """(B, F) -> (B,) float64 over the wire.

        ``deadline_s`` ships as the remaining-budget ``deadline_ms`` frame
        field; ``priority=None`` lets the server derive admission priority
        from the remaining slack on arrival. On a v3 connection the batch
        travels as one raw ``<f4`` payload and comes back as raw ``<f8``
        — no per-element JSON work on either end.

        ``trace_ctx`` joins this call to a distributed trace: a client
        ``wire`` span brackets the round-trip, its context rides the frame
        meta (``"trace"`` — both v2 JSON and v3 binary, no version bump),
        and server-side spans returned in the reply (``"spans"``) are
        ingested into this replica's tracer.  A peer that strips unknown
        meta simply yields a local-only trace — never an error.
        """
        X = np.atleast_2d(np.ascontiguousarray(X, dtype=np.float32))
        fields: dict = {}
        if deadline_s is not None:
            fields["deadline_ms"] = deadline_s * 1e3
        if priority is not None:
            fields["priority"] = int(priority)
        wire = None
        if trace_ctx is not None:
            if self.obs is not None:
                wire = self.obs.tracer.start("wire", parent=trace_ctx,
                                             replica=self.name)
                fields["trace"] = ctx_to_meta(wire.ctx)
            else:
                fields["trace"] = ctx_to_meta(trace_ctx)
        self.stats.calls += 1
        t0 = time.perf_counter()
        try:
            meta, payload = self._call_op("predict", fields, X=X)
        except TransportError:
            self.stats.transport_errors += 1
            if wire is not None:
                self.obs.tracer.finish(wire, outcome="transport_error")
            raise
        except Exception:
            if wire is not None:
                self.obs.tracer.finish(wire, outcome="error")
            raise
        self.stats.rtt_s.append(time.perf_counter() - t0)
        if wire is not None:
            self.obs.tracer.finish(wire)
        if self.obs is not None and meta.get("spans"):
            self.obs.tracer.ingest(meta["spans"])
        try:
            if "array" in meta:
                y = unpack_array(meta["array"], payload).astype(
                    np.float64, copy=False)
            else:
                y = np.asarray(meta["y"], dtype=np.float64)
        except (KeyError, TypeError, ValueError) as exc:
            raise ProtocolError(f"bad predict reply: {exc}") from exc
        if y.shape != (X.shape[0],):
            raise ProtocolError(f"server returned {y.shape} for "
                                f"{X.shape[0]} rows")
        self.stats.rows += len(y)
        return y

    def schedule(self, X: np.ndarray, *, objective: str = "energy",
                 deadline_s: float | None = None) -> dict:
        """Remote deadline-aware DVFS scheduling (``op="schedule"``): the
        server's frontend chooses (device, frequency) per kernel; the
        returned dispatch result carries the chosen operating points,
        makespan, energy, and whether the deadline is met."""
        X = np.atleast_2d(np.ascontiguousarray(X, dtype=np.float32))
        fields: dict = {"objective": objective}
        if deadline_s is not None:
            fields["deadline_ms"] = deadline_s * 1e3
        self.stats.calls += 1
        try:
            meta, _ = self._call_op("schedule", fields, X=X)
        except TransportError:
            self.stats.transport_errors += 1
            raise
        return {k: v for k, v in meta.items() if k not in ("v", "id", "ok")}

    def info(self) -> dict:
        meta, _ = self._call_op("info")
        return meta

    def metrics(self) -> dict:
        """Scrape the server's metrics registry over the existing socket
        (``op="metrics"``): ``{"enabled", "metrics", "slow",
        "calibration"}``."""
        meta, _ = self._call_op("metrics")
        return {k: v for k, v in meta.items() if k not in ("v", "id", "ok")}

    def ping(self) -> bool:
        try:
            self._call_op("ping")
            return True
        except (TransportError, ProtocolError):
            return False

    def swap_estimator(self, est) -> int:
        raise NotImplementedError(
            "the model lives on the serving host — swap it there (e.g. via "
            "its EngineRefresher); RemoteReplica is a routing client")

    def close(self) -> None:
        with self._conn_lock:
            self._closed = True
            sock, self._sock = self._sock, None
            self._mode_v3 = False
            reader, self._reader = self._reader, None
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
            with self._pend_lock:
                for rid in list(self._pending):
                    p = self._pending.pop(rid)
                    p.error = TransportError("replica closed")
                    p.event.set()
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=2.0)

    def __enter__(self) -> "RemoteReplica":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------- demo + CLI

def demo_estimator(seed: int = 0, n_features: int = 6, n_trees: int = 24,
                   n_samples: int = 160):
    """Deterministic fitted forest: the SAME (seed, shape) args produce the
    same model in any process — how tests and the selftest compare remote
    answers against an in-process twin to <=1e-6."""
    from ..core.forest import ExtraTreesRegressor

    rng = np.random.default_rng(seed)
    X = rng.lognormal(1.0, 1.5, size=(n_samples, n_features)).astype(
        np.float32)
    y = np.log(2.0 * X[:, 0] + X[:, 2] + 1.0)
    return ExtraTreesRegressor(n_estimators=n_trees, max_depth=6,
                               seed=seed).fit(X, y)


def demo_frontend(seed: int = 0, n_features: int = 6, n_trees: int = 24,
                  *, max_queue: int = 256,
                  obs: Observability | None = None,
                  device: str = "cuda") -> ClusterFrontend:
    """One-replica frontend over ``demo_estimator`` (CLI + selftest),
    served on ``device``: the CUDA forest kernel on the card, ``flat-numpy``
    on the CPU."""
    from ..serve import ForestEngine
    from .replicas import ReplicaPool

    est = demo_estimator(seed=seed, n_features=n_features, n_trees=n_trees)
    engine = ForestEngine(est, cache_size=0, device=device,
                          backend="flat-numpy" if device == "cpu" else None)
    pool = ReplicaPool({"local": engine}, check_interval_s=1.0)
    if obs is not None:
        engine.register_metrics(obs.registry, replica="local")
    return ClusterFrontend(pool, max_queue=max_queue, auto_start=False,
                           obs=obs)


def spawn_demo_server(port: int = 0, *, seed: int = 0, trees: int = 24,
                      n_features: int = 6, metrics_port: int | None = None,
                      device: str = "cuda"):
    """Spawn ``python -m repro_torch.cluster`` as a SUBPROCESS and wait for its
    ``LISTENING host port`` line. Returns ``(proc, host, bound_port)`` —
    or ``(proc, host, bound_port, metrics_host, metrics_port)`` when
    ``metrics_port`` is given (0 = ephemeral; the server then also prints
    a ``METRICS host port`` line for its Prometheus endpoint).

    The one place that knows the CLI flags, the PYTHONPATH wiring, and the
    startup handshake — shared by the ``--selftest`` smoke, the transport
    tests' kill/restart drills, and ``examples/remote_serve.py``.
    """
    import subprocess
    import sys
    from pathlib import Path

    cmd = [sys.executable, "-m", "repro_torch.cluster", "--port", str(port),
           "--seed", str(seed), "--trees", str(trees),
           "--n-features", str(n_features), "--device", device]
    if metrics_port is not None:
        cmd += ["--metrics-port", str(metrics_port)]
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    line = proc.stdout.readline().strip()
    if not line.startswith("LISTENING"):
        proc.kill()
        proc.wait(timeout=10)
        raise RuntimeError(f"server did not come up: {line!r}")
    _, host, bound = line.split()
    if metrics_port is None:
        return proc, host, int(bound)
    mline = proc.stdout.readline().strip()
    if not mline.startswith("METRICS"):
        proc.kill()
        proc.wait(timeout=10)
        raise RuntimeError(f"metrics endpoint did not come up: {mline!r}")
    _, mhost, mport = mline.split()
    return proc, host, int(bound), mhost, int(mport)


def _selftest(args) -> int:
    """CI transport smoke: spawn a server SUBPROCESS, then check a v3
    (binary, pipelined) peer AND a v2-pinned JSON peer against the
    in-process twin on the same server — the rolling-upgrade interop
    matrix in one process."""
    from concurrent.futures import ThreadPoolExecutor

    proc, host, port = spawn_demo_server(
        0, seed=args.seed, trees=args.trees, n_features=args.n_features,
        device=args.device)
    try:
        est = demo_estimator(seed=args.seed, n_features=args.n_features,
                             n_trees=args.trees)
        rng = np.random.default_rng(123)
        X = rng.lognormal(1.0, 1.5, size=(4, args.n_features)).astype(
            np.float32)
        want = est.predict(X)

        v3 = RemoteReplica(host, port, timeout_s=20.0)
        got3 = v3.predict(X, deadline_s=10.0)
        if v3.negotiated_version != PROTOCOL_V3:
            raise RuntimeError(
                f"expected v3 negotiation, got {v3.negotiated_version}")
        err3 = float(np.max(np.abs(got3 - want)))
        # pipelined burst: 8 threads share the one v3 socket
        with ThreadPoolExecutor(max_workers=8) as ex:
            rows = list(ex.map(
                lambda i: float(v3.predict(X[i % len(X)])[0]), range(16)))
        if not np.allclose(rows, [want[i % len(X)] for i in range(16)],
                           atol=1e-6):
            raise RuntimeError("pipelined burst answers diverged")
        max_in_flight = v3.stats.max_in_flight
        v3.close()

        v2 = RemoteReplica(host, port, timeout_s=20.0,
                           protocol=PROTOCOL_VERSION)
        got2 = v2.predict(X, deadline_s=10.0)
        if v2.negotiated_version != PROTOCOL_VERSION:
            raise RuntimeError(
                f"expected v2 pin, got {v2.negotiated_version}")
        err2 = float(np.max(np.abs(got2 - want)))
        v2.close()

        err = max(err3, err2)
        if err > 1e-6:
            raise RuntimeError(f"remote != in-process: max abs err {err}")
        print(f"TRANSPORT_SMOKE_OK host={host} port={port} rows={len(got3)} "
              f"max_abs_err={err:.2e} v3_err={err3:.2e} v2_err={err2:.2e} "
              f"max_in_flight={max_in_flight}")
        return 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _print_stats(args) -> int:
    """``--stats``: scrape a running server over the wire
    (``op="metrics"``) and pretty-print the registry, the live
    calibration MAPE gauges, and any sampled slow requests."""
    replica = RemoteReplica(args.host, args.port, timeout_s=10.0)
    try:
        body = replica.metrics()
    except TransportError as exc:
        print(f"cannot scrape {args.host}:{args.port}: {exc}")
        return 1
    finally:
        replica.close()
    if not body.get("enabled", False):
        print("observability disabled on this server")
        return 1
    for row in body.get("metrics", []):
        labels = row.get("labels") or {}
        lbl = ("{" + ",".join(f"{k}={v}"
                              for k, v in sorted(labels.items())) + "}"
               if labels else "")
        if row.get("kind") == "histogram":
            parts = [f"count={row.get('count', 0)}"]
            for p in ("p50", "p95", "p99"):
                v = row.get(p)
                if v is not None:
                    parts.append(f"{p}={v:.6g}")
            print(f"{row['name']}{lbl} {' '.join(parts)}")
        else:
            v = row.get("value")
            print(f"{row['name']}{lbl} "
                  f"{'nan' if v is None else f'{v:.6g}'}")
    for entry in body.get("calibration", []):
        print(f"calibration {entry['device']}/{entry['target']}: "
              f"MAPE {entry['mape_pct']:.2f}% over {entry['n']} samples")
    slow = body.get("slow", [])
    if slow:
        print(f"# {len(slow)} sampled slow request(s); slowest root "
              f"{max(s['dur_s'] for s in slow) * 1e3:.1f}ms")
    return 0


#: metric names the obs smoke (and CI) require from a live demo server —
#: one per instrumented layer.
REQUIRED_METRICS = ("frontend.submitted", "frontend.served",
                    "frontend.wait_s", "engine.predictions",
                    "pool.probes", "server.requests_served")


def _obs_smoke(args) -> int:
    """CI observability smoke: spawn a demo server with a Prometheus
    endpoint, drive a few predictions, scrape BOTH exposition surfaces
    (``op="metrics"`` on the predict socket, HTTP text endpoint), and
    assert the per-layer metric names are present and counting."""
    import urllib.request

    proc, host, port, mhost, mport = spawn_demo_server(
        0, seed=args.seed, trees=args.trees, n_features=args.n_features,
        metrics_port=0, device=args.device)
    try:
        rng = np.random.default_rng(7)
        X = rng.lognormal(1.0, 1.5, size=(8, args.n_features)).astype(
            np.float32)
        obs = Observability.default()
        root = obs.tracer.start("smoke.request")
        replica = RemoteReplica(host, port, timeout_s=20.0, obs=obs)
        replica.predict(X, trace_ctx=root.ctx)
        obs.tracer.finish(root)
        body = replica.metrics()
        replica.close()

        names = {row["name"] for row in body.get("metrics", [])}
        missing = [n for n in REQUIRED_METRICS if n not in names]
        if not body.get("enabled") or missing:
            raise RuntimeError(f"op=metrics scrape missing {missing} "
                               f"(enabled={body.get('enabled')})")
        served = next(row for row in body["metrics"]
                      if row["name"] == "frontend.served")
        if not served["value"] or served["value"] < len(X):
            raise RuntimeError(f"frontend.served did not count: {served}")

        with urllib.request.urlopen(
                f"http://{mhost}:{mport}/metrics", timeout=10) as resp:
            text = resp.read().decode()
        want_prom = [n.replace(".", "_") for n in REQUIRED_METRICS]
        missing_prom = [n for n in want_prom
                        if f"repro_{n}" not in text]
        if missing_prom:
            raise RuntimeError(
                f"prometheus endpoint missing {missing_prom}")

        # the cross-process trace came back: server spans joined the
        # client's tree (wire -> admit/queue/dispatch/engine/reply)
        got = {s.name for s in obs.tracer.spans(root.trace_id)}
        need = {"smoke.request", "wire", "admit", "queue", "dispatch",
                "engine", "reply"}
        if not need <= got:
            raise RuntimeError(f"span tree incomplete: {sorted(got)}")
        print(f"OBS_SMOKE_OK metrics={len(names)} "
              f"served={served['value']:.0f} spans={sorted(got)}")
        return 0
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Serve a demo ClusterFrontend over TCP (see "
                    "docs/transport.md)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=DEFAULT_PORT,
                    help="0 picks a free port (printed on the LISTENING line)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", type=int, default=24)
    ap.add_argument("--n-features", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="where the demo forest is served: 'cuda' (the "
                         "forest kernel on the card) or 'cpu'")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="also serve Prometheus text on this port (0 picks "
                         "a free one, printed on the METRICS line)")
    ap.add_argument("--selftest", action="store_true",
                    help="spawn a server subprocess, answer one remote "
                         "request, exit 0 on success (the CI smoke step)")
    ap.add_argument("--obs-smoke", action="store_true",
                    help="spawn a server subprocess, scrape op='metrics' + "
                         "the Prometheus endpoint, assert the per-layer "
                         "metric names (the CI observability smoke step)")
    ap.add_argument("--stats", action="store_true",
                    help="scrape a RUNNING server at --host/--port over "
                         "op='metrics' and pretty-print its registry")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest(args)
    if args.obs_smoke:
        return _obs_smoke(args)
    if args.stats:
        return _print_stats(args)

    obs = Observability.default()
    frontend = demo_frontend(seed=args.seed, n_features=args.n_features,
                             n_trees=args.trees, obs=obs, device=args.device)
    server = PredictionServer(frontend, host=args.host, port=args.port,
                              obs=obs, metrics_port=args.metrics_port)
    server.start()
    print(f"LISTENING {server.host} {server.port}", flush=True)
    if server.metrics_address is not None:
        print(f"METRICS {server.metrics_address[0]} "
              f"{server.metrics_address[1]}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
