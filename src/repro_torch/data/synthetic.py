"""Synthetic LM data pipeline (the port of ``repro.data.synthetic``).

``SyntheticLM`` is the reference's numpy token stream, copied: a Zipfian
unigram distribution plus an induced short-range structure (a token is
often a function of its predecessor), so a small model has something to
learn. Its batches are bitwise equal to the reference's for the same seed
and index.

``DataPipeline`` is the host-side loader: a background thread builds the
next batches (prefetch), pins them and copies them to the device with
``non_blocking=True``. Batch i depends only on (seed, i), so resuming from a
checkpoint replays the exact stream without state files. Per-process
slicing and the extra inputs of the multi-modal families come with the
multi-device and family slices.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class SyntheticLM:
    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.2,
                 structure: float = 0.7):
        self.vocab = vocab
        self.seed = seed
        self.zipf_a = zipf_a
        self.structure = structure
        # stationary unigram table
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** zipf_a
        self.p = p / p.sum()
        # deterministic successor map: the "grammar"
        rng = np.random.default_rng(seed ^ 0x5EED)
        self.successor = rng.integers(0, vocab, size=vocab)

    def batch(self, index: int, batch: int, seq_len: int) -> dict:
        """Batch ``index`` of the stream: (tokens, labels) already shifted."""
        rng = np.random.default_rng((self.seed, index))
        iid = rng.choice(self.vocab, size=(batch, seq_len + 1), p=self.p)
        toks = iid.copy()
        follow = rng.random((batch, seq_len + 1)) < self.structure
        for t in range(1, seq_len + 1):
            toks[:, t] = np.where(follow[:, t],
                                  self.successor[toks[:, t - 1]], iid[:, t])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class DataPipeline:
    """Host loader with background prefetch; hands out (index, batch) with
    the batch's tensors on ``device``. ``extra_fn(index, batch)`` adds
    arrays to each batch (a VLM's patches, an enc-dec's frames) and
    ``transform`` rewrites the host batch last, as in the reference."""

    def __init__(self, gen: SyntheticLM, batch: int, seq_len: int,
                 device: str | torch.device = "cuda", prefetch: int = 2,
                 start_index: int = 0, extra_fn=None, transform=None):
        self.gen = gen
        self.batch = batch
        self.seq_len = seq_len
        self.device = torch.device(device)
        self.extra_fn = extra_fn
        self.transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._index = start_index
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self, index: int) -> dict:
        host = self.gen.batch(index, self.batch, self.seq_len)
        if self.extra_fn is not None:
            host.update(self.extra_fn(index, self.batch))
        if self.transform is not None:
            host = self.transform(host)
        out = {}
        for name, arr in host.items():
            t = torch.from_numpy(arr)
            if self.device.type == "cuda":
                # from pinned host memory the copy runs asynchronously; the
                # caching host allocator keeps the buffer until it is done
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[name] = t.to(self.device)
        return out

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        i = self._index
        try:
            while self._put((i, self._make(i))):
                i += 1
        except Exception as exc:          # handed to the consumer, raised there
            self._put((i, exc))

    def __next__(self) -> tuple[int, dict]:
        index, batch = self._q.get()
        if isinstance(batch, Exception):
            raise RuntimeError(f"building batch {index} failed") from batch
        return index, batch

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
