"""Fault-tolerant checkpointing (the port of
``repro.checkpoint.manager``):

  * ATOMIC: a state is written into ``step_N.tmp/`` and then ``os.replace``d
    to ``step_N/``, so a crash mid-write never corrupts the newest
    checkpoint;
  * ASYNC: ``save`` copies every tensor to host memory before it returns
    (training may then update the device tensors in place) and hands the
    writing to a background thread, joined before the next save and by
    ``wait``;
  * RETENTION: the newest ``keep`` checkpoints stay, plus every
    ``keep_every`` milestone;
  * SELF-DESCRIBING: a manifest records the step, each leaf's shape and
    dtype, the state's device and the caller's metadata; ``latest_step``
    scans the directory, so a restart needs no other state. ``restore``
    puts the tensors back on that device, or on the device asked for;
  * MESH-AGNOSTIC: ``save`` gathers a DTensor leaf whole (``full_tensor``,
    a collective every rank of its mesh calls) and the mesh's first rank
    writes; ``restore`` can distribute every leaf onto a mesh by a tree of
    placements, the reference's ``shardings=``, so a restart lands on a
    new plan.

Leaves are torch tensors or numpy arrays, saved as numpy (bfloat16, which
numpy lacks, as its 16-bit pattern) and restored as tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..sharding.rules import distribute_tree


def _flatten(tree, prefix=""):
    """dict/list/tuple tree -> {path: leaf}; round-trips with _unflatten."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}d:{k}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{tag}:{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def build(node):
        if not isinstance(node, dict):
            return node
        kinds = {k.split(":", 1)[0] for k in node}
        if len(kinds) != 1:
            raise ValueError(f"mixed container kinds in {sorted(node)}")
        kind = kinds.pop()
        if kind == "d":
            return {k.split(":", 1)[1]: build(v) for k, v in node.items()}
        items = sorted(node.items(), key=lambda kv: int(kv[0].split(":", 1)[1]))
        seq = [build(v) for _, v in items]
        return seq if kind == "l" else tuple(seq)

    return build(root)


def _writer(flat: dict) -> bool:
    """Whether this rank writes: the first rank of the state's mesh (mesh
    coordinate all zeros), or rank 0 for a state of plain tensors."""
    for v in flat.values():
        if isinstance(v, DTensor):
            coord = v.device_mesh.get_coordinate()
            return coord is not None and not any(coord)
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(a numpy copy of ``leaf``, its dtype name)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).split(".")[-1]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy(), name
    a = np.array(leaf)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, name: str, device) -> torch.Tensor:
    # ascontiguousarray alone would make a 0-d array 1-d
    t = torch.from_numpy(np.ascontiguousarray(a).reshape(a.shape))
    if name == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3,
                 keep_every: int = 0, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.keep_every = keep_every
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state, metadata: dict | None = None) -> None:
        """Every rank of the state's mesh calls ``save`` (DTensor leaves
        are gathered collectively); its first rank writes."""
        self.wait()
        # snapshot to host SYNCHRONOUSLY: the caller may update the tensors
        # in place as soon as this returns
        host, dtypes = {}, {}
        flat = _flatten(state)
        for k, v in flat.items():
            host[k], dtypes[k] = _to_host(v)
        if not _writer(flat):
            return
        devices = {str(v.device.type) for v in flat.values()
                   if isinstance(v, torch.Tensor)}
        meta = {"step": int(step), "time": time.time(),
                "metadata": metadata or {},
                "device": devices.pop() if len(devices) == 1 else "cpu",
                "leaves": {k: [list(v.shape), dtypes[k]]
                           for k, v in host.items()}}
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write_logged, args=(step, host, meta),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write_logged(self, step: int, host: dict, meta: dict) -> None:
        try:
            self._write(step, host, meta)
        except Exception as exc:          # re-raised by wait()
            self._error = exc

    def _write(self, step: int, host: dict, meta: dict) -> None:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz",
                 **{k.replace("/", "|"): v for k, v in host.items()})
        with open(tmp / "manifest.json", "w") as f:
            json.dump(meta, f)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join the pending write; raise what it raised. Only one rank
        writes: another rank that reads the directory next waits for it
        (a barrier) itself."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        victims = steps[:-self.keep] if self.keep else []
        for s in victims:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, placements=None, mesh=None,
                device: str | torch.device | None = None):
        """(step, state) with every leaf a tensor on ``device`` (by default
        the device the state was saved from). With ``placements`` (a tree of
        placements matching the state, ``sharding.tree_shardings``'s) every
        leaf becomes a DTensor on ``mesh``, each rank keeping its shards."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:010d}"
        with open(path / "manifest.json") as f:
            meta = json.load(f)
        with np.load(path / "arrays.npz") as z:
            host = {k.replace("|", "/"): z[k] for k in z.files}
        device = meta.get("device", "cpu") if device is None else device
        state = _unflatten({k: _from_host(a, meta["leaves"][k][1], device)
                            for k, a in host.items()})
        if placements is not None:
            if mesh is None:
                raise ValueError("placements need the mesh they refer to")
            state = distribute_tree(state, mesh, placements)
        return int(meta["step"]), state
