"""Distributed request tracing over the existing wire protocol.

A trace is a tree of spans identified by a 16-hex ``trace_id``; each span
has its own ``span_id`` and a ``parent_id``.  The context travels in the
ordinary v2 JSON frame / v3 binary frame *meta* under the ``"trace"`` key
— **no protocol-version bump**: both frame codecs already round-trip
unknown meta keys, and peers that don't know the key simply ignore it
(the trace degrades to local-only spans, never an error).

Span stages across a remote predict::

    client.request                  (client root)
      wire                          (client: serialize + RTT + deserialize)
        admit                       (server: frontend admission)
        queue                       (server: heap wait until dispatch pop)
        dispatch                    (server: pop -> engine hand-off)
          engine                    (server: replica predict)
        reply                       (server: result -> frame on the socket)

    The server ships its finished spans back in the reply meta
    (``"spans"``) so the client's :class:`Tracer` can ``ingest`` them and
    reconstruct the full cross-process tree without a collector service.

A slow-request sampler logs a structured one-line JSON span dump for any
root span slower than ``slow_threshold_s`` (bounded ring of recent dumps
kept for ``--stats``/examples).

A copy of ``repro.obs.tracing``; its logger is ``repro_torch.obs.trace``.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field

__all__ = ["Span", "TraceContext", "Tracer",
           "new_trace_id", "new_span_id", "ctx_to_meta", "ctx_from_meta"]

log = logging.getLogger("repro_torch.obs.trace")


def new_trace_id() -> str:
    return os.urandom(8).hex()


def new_span_id() -> str:
    return os.urandom(4).hex()


@dataclass(frozen=True)
class TraceContext:
    """What travels on the wire: which trace, and which span is parent."""

    trace_id: str
    span_id: str


def ctx_to_meta(ctx: TraceContext | None) -> dict | None:
    """Frame-meta encoding (compact keys; lives under meta[\"trace\"])."""
    if ctx is None:
        return None
    return {"tid": ctx.trace_id, "sid": ctx.span_id}


def ctx_from_meta(meta: object) -> TraceContext | None:
    """Tolerant decode: anything malformed means 'no trace context'."""
    if not isinstance(meta, dict):
        return None
    tid, sid = meta.get("tid"), meta.get("sid")
    if not (isinstance(tid, str) and isinstance(sid, str) and tid and sid):
        return None
    return TraceContext(trace_id=tid, span_id=sid)


@dataclass
class Span:
    trace_id: str
    name: str
    span_id: str = field(default_factory=new_span_id)
    parent_id: str | None = None
    t_wall: float = field(default_factory=time.time)
    t_start: float = field(default_factory=time.perf_counter)
    dur_s: float | None = None
    tags: dict = field(default_factory=dict)

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        return {"tid": self.trace_id, "sid": self.span_id,
                "parent": self.parent_id, "name": self.name,
                "wall": self.t_wall, "dur": self.dur_s,
                "tags": self.tags}

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        return cls(trace_id=str(d["tid"]), name=str(d.get("name", "?")),
                   span_id=str(d.get("sid", "")) or new_span_id(),
                   parent_id=d.get("parent"),
                   t_wall=float(d.get("wall", 0.0)),
                   dur_s=(None if d.get("dur") is None
                          else float(d["dur"])),
                   tags=dict(d.get("tags") or {}))


class Tracer:
    """Bounded per-trace span store with a slow-request sampler.

    Holds the ``max_traces`` most recent traces (LRU by trace creation);
    ``finish`` on a *root* span slower than ``slow_threshold_s`` emits a
    structured JSON log line and keeps the dump in a bounded ring.
    """

    def __init__(self, *, max_traces: int = 256,
                 slow_threshold_s: float | None = None,
                 max_slow: int = 32) -> None:
        self.max_traces = int(max_traces)
        self.slow_threshold_s = slow_threshold_s
        self._traces: "OrderedDict[str, list[Span]]" = OrderedDict()
        self._lock = threading.Lock()
        self.slow: list[dict] = []
        self._max_slow = int(max_slow)
        self.n_started = 0
        self.n_ingested = 0
        self.n_slow = 0

    # --------------------------------------------------------- recording

    def start(self, name: str, *, parent: TraceContext | None = None,
              trace_id: str | None = None, **tags) -> Span:
        """Open a span.  With ``parent``, joins that trace as a child;
        otherwise opens a new trace (``trace_id`` override for tests)."""
        if parent is not None:
            span = Span(trace_id=parent.trace_id, name=name,
                        parent_id=parent.span_id, tags=dict(tags))
        else:
            span = Span(trace_id=trace_id or new_trace_id(), name=name,
                        tags=dict(tags))
        self._store(span)
        self.n_started += 1
        return span

    def finish(self, span: Span, **tags) -> float:
        """Close a span; returns its duration.  Root spans over the slow
        threshold are sampled into a structured log dump."""
        if span.dur_s is None:
            span.dur_s = time.perf_counter() - span.t_start
        if tags:
            span.tags.update(tags)
        thr = self.slow_threshold_s
        if (thr is not None and span.parent_id is None
                and span.dur_s >= thr):
            self._sample_slow(span)
        return span.dur_s

    def record(self, name: str, *, parent: TraceContext,
               dur_s: float, t_wall: float | None = None,
               **tags) -> Span:
        """Store an already-measured span (e.g. an engine call timed with
        its own ``perf_counter`` pair) without the start/finish dance."""
        span = Span(trace_id=parent.trace_id, name=name,
                    parent_id=parent.span_id, dur_s=float(dur_s),
                    tags=dict(tags))
        if t_wall is not None:
            span.t_wall = float(t_wall)
        self._store(span)
        self.n_started += 1
        return span

    def ingest(self, spans: list[dict] | None) -> int:
        """Adopt peer-produced span dicts (the reply-meta ``"spans"``
        list).  Malformed entries are dropped, never raised."""
        n = 0
        for d in spans or ():
            try:
                self._store(Span.from_dict(d))
                n += 1
            except (KeyError, TypeError, ValueError):
                continue
        self.n_ingested += n
        return n

    def _store(self, span: Span) -> None:
        with self._lock:
            bucket = self._traces.get(span.trace_id)
            if bucket is None:
                while len(self._traces) >= self.max_traces:
                    self._traces.popitem(last=False)
                bucket = self._traces[span.trace_id] = []
            bucket.append(span)

    def _sample_slow(self, span: Span) -> None:
        dump = {"trace_id": span.trace_id, "root": span.name,
                "dur_s": span.dur_s, "tags": span.tags,
                "spans": [s.to_dict() for s in self.spans(span.trace_id)]}
        self.n_slow += 1
        with self._lock:
            self.slow.append(dump)
            del self.slow[:-self._max_slow]
        log.warning("SLOW %s", json.dumps(dump, sort_keys=True,
                                          default=str))

    # --------------------------------------------------------- reading

    def spans(self, trace_id: str) -> list[Span]:
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def export(self, trace_id: str) -> list[dict]:
        """Wire form of a trace's spans — what a server attaches to the
        reply meta for the client to ``ingest``."""
        return [s.to_dict() for s in self.spans(trace_id)]

    def tree(self, trace_id: str) -> list[dict]:
        """Nested ``{"span": Span, "children": [...]}`` forest, children
        ordered by wall-clock start."""
        spans = sorted(self.spans(trace_id), key=lambda s: s.t_wall)
        nodes = {s.span_id: {"span": s, "children": []} for s in spans}
        roots: list[dict] = []
        for s in spans:
            node = nodes[s.span_id]
            parent = nodes.get(s.parent_id) if s.parent_id else None
            (parent["children"] if parent else roots).append(node)
        return roots

    def render_tree(self, trace_id: str) -> str:
        """Human-readable indented tree for ``--stats`` and examples."""
        lines = [f"trace {trace_id}"]

        def walk(node: dict, depth: int) -> None:
            s: Span = node["span"]
            dur = "...running" if s.dur_s is None else f"{s.dur_s*1e3:.3f}ms"
            tags = (" " + json.dumps(s.tags, sort_keys=True, default=str)
                    if s.tags else "")
            lines.append(f"{'  ' * depth}- {s.name} [{dur}]{tags}")
            for child in node["children"]:
                walk(child, depth + 1)

        for root in self.tree(trace_id):
            walk(root, 1)
        return "\n".join(lines)
