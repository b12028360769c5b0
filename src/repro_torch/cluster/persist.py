"""Durability for the streaming ``DatasetStore``: WAL + snapshots + recovery.

The streaming pipeline (collector -> store -> refresher -> hot-swap) keeps
its ground truth only in memory; a crash loses every measurement since
boot and the refresher restarts from nothing. ``PersistentDatasetStore``
makes the store crash-safe with the classic two-piece design:

  * **write-ahead log** — every ``extend`` first appends one JSONL record
    ``{"v": version, "samples": [...]}`` to ``wal.jsonl`` (flush + fsync)
    and only then mutates memory. An append is acknowledged iff it is
    durable; a crash mid-write leaves at most one TORN TAIL record, which
    recovery truncates — exactly the batch that was never acknowledged.
  * **periodic snapshots** — every ``snapshot_every`` versions the RAW
    store state (uncapped samples + exact version, via
    ``DatasetStore.raw()``) is written atomically (tmp + fsync + rename)
    to ``snapshot-<version>.json`` and the WAL is reset; the log stays
    short no matter how long the stream runs. The §4.2.3 capped view
    (``snapshot()``) is intentionally NOT what is persisted — capping is a
    function of (seed, arrival order), so it re-derives bit-identically
    from the raw state.
  * **recovery** — opening a directory loads the newest readable snapshot
    and replays WAL records with ``v > snapshot.version`` in order. The
    store comes back at the EXACT pre-crash version with the exact sample
    list, so ``DatasetStore.snapshot()`` is byte-identical to the
    pre-crash one and an ``EngineRefresher``'s ``last_version`` semantics
    survive the restart: it refits from the recovered snapshot while the
    engines keep serving their last good generation — no refit downtime.

Opening is recovering: ``PersistentDatasetStore(dir)`` on an empty
directory is a fresh store; on a populated one it is the pre-crash store.

A copy of ``repro.cluster.persist``: the same writes give the same bytes
on disk.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path

from ..core.dataset import DatasetStore, Sample

__all__ = ["PersistentDatasetStore", "WriteAheadLog"]


class WriteAheadLog:
    """Append-only JSONL log with fsync'd appends and torn-tail recovery.

    Records are ``{"v": int, "samples": [Sample.to_json(), ...]}``, one per
    line. Opening scans the existing file: complete records are returned by
    ``recovered``; a torn tail (interrupted final write) is truncated so
    the file ends on a record boundary before any new append lands. A
    corrupt record that is NOT the tail means real damage (not a crash
    artifact) and raises.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.recovered, good_bytes = self._scan()
        self._f = open(self.path, "ab")
        if self._f.tell() != good_bytes:      # torn tail: cut to the last
            self._f.truncate(good_bytes)      # complete record
            self._f.seek(good_bytes)

    def _scan(self) -> tuple[list[tuple[int, list[dict]]], int]:
        if not self.path.exists():
            return [], 0
        data = self.path.read_bytes()
        records: list[tuple[int, list[dict]]] = []
        good = 0
        while good < len(data):
            nl = data.find(b"\n", good)
            line = data[good:nl] if nl >= 0 else data[good:]
            try:
                rec = json.loads(line)
                version, samples = int(rec["v"]), list(rec["samples"])
            except (ValueError, KeyError, TypeError) as exc:
                # a torn write truncates the FINAL record before its
                # trailing newline; a parse failure on a newline-terminated
                # record is real damage, not a crash artifact
                if nl < 0:
                    break                     # torn tail — never acked
                raise ValueError(
                    f"corrupt WAL record at byte {good} of {self.path} "
                    f"(not a torn tail)") from exc
            if nl < 0:
                # record parsed but unterminated: the trailing newline —
                # hence the fsync and the ack — never landed; drop it
                break
            records.append((version, samples))
            good = nl + 1
        return records, good

    def append(self, version: int, samples: list[dict]) -> None:
        line = json.dumps({"v": version, "samples": samples},
                          separators=(",", ":")) + "\n"
        self._f.write(line.encode("utf-8"))
        self._f.flush()
        os.fsync(self._f.fileno())

    @property
    def closed(self) -> bool:
        return self._f.closed

    def reset(self) -> None:
        """Empty the log (its records are covered by a durable snapshot)."""
        self._f.truncate(0)
        self._f.seek(0)
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class PersistentDatasetStore(DatasetStore):
    """Crash-safe ``DatasetStore``: WAL-first appends, periodic snapshots,
    and open-time recovery to the exact pre-crash version."""

    WAL_NAME = "wal.jsonl"
    SNAP_GLOB = "snapshot-*.json"

    def __init__(self, path: str | Path, *, max_per_group: int | None = 100,
                 seed: int = 0, snapshot_every: int = 8,
                 keep_snapshots: int = 2):
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, "
                             f"got {snapshot_every}")
        self.dir = Path(path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.snapshot_every = snapshot_every
        self.keep_snapshots = max(keep_snapshots, 1)
        self._write_lock = threading.Lock()   # serializes WAL + memory

        samples, version = self._load_latest_snapshot()
        self._last_snap_version = version
        self._wal = WriteAheadLog(self.dir / self.WAL_NAME)
        replayed = 0
        for v, sample_dicts in self._wal.recovered:
            if v <= version:                  # already baked into the
                continue                      # snapshot; WAL not yet reset
            samples.extend(Sample.from_json(d) for d in sample_dicts)
            version = v
            replayed += 1
        super().__init__(max_per_group=max_per_group, seed=seed,
                         samples=samples, version=version)
        self.recovered_version = version
        self.replayed_records = replayed

    # ------------------------------------------------------------- recovery

    def _snapshot_files(self) -> list[Path]:
        return sorted(self.dir.glob(self.SNAP_GLOB))

    def _load_latest_snapshot(self) -> tuple[list[Sample], int]:
        for path in reversed(self._snapshot_files()):
            try:
                with open(path) as f:
                    payload = json.load(f)
                return ([Sample.from_json(d) for d in payload["samples"]],
                        int(payload["version"]))
            except (OSError, ValueError, KeyError):
                continue                      # unreadable: fall back older
        return [], 0

    # -------------------------------------------------------------- writes

    def extend(self, samples: list[Sample]) -> int:
        samples = list(samples)
        if not samples:
            return self.version
        with self._write_lock:
            if self._wal.closed:
                raise RuntimeError("store is closed")
            # WAL first: the batch is durable BEFORE memory acknowledges
            # it, so every version the store ever reports is recoverable
            version = self._version + 1
            self._wal.append(version, [s.to_json() for s in samples])
            got = super().extend(samples)
            assert got == version, (got, version)
            if version - self._last_snap_version >= self.snapshot_every:
                self._checkpoint_locked()
            return version

    def checkpoint(self) -> int:
        """Force a durable snapshot now; returns the version written."""
        with self._write_lock:
            return self._checkpoint_locked()

    def _checkpoint_locked(self) -> int:
        samples, version = self.raw()
        payload = {"version": version,
                   "samples": [s.to_json() for s in samples]}
        path = self.dir / f"snapshot-{version:010d}.json"
        tmp = path.with_suffix(".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        tmp.replace(path)                     # atomic publish
        # the rename is directory metadata: it must be durable BEFORE the
        # WAL reset below, or a power loss could leave the old snapshot
        # with an already-empty log — losing acknowledged versions
        dir_fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        self._wal.reset()                     # log is now redundant
        self._last_snap_version = version
        for old in self._snapshot_files()[:-self.keep_snapshots]:
            old.unlink(missing_ok=True)
        return version

    # ----------------------------------------------------------- lifecycle

    def close(self) -> None:
        with self._write_lock:
            self._wal.close()

    def __enter__(self) -> "PersistentDatasetStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
