#!/usr/bin/env python3
"""The counted live-bytes peak a rank of dry-run cells on a fake mesh, and
what is live at it: each cell's step (``launch/cells.py``, the
``core/autotune.py::strategy_costs`` run the dry-run counts) on meta
tensors over a ``fake`` process group, under torch 2.11's DTensor view rule
(``tests/_mesh_cells.py::view_rule_2_11``), on the host's CPU.

    python3 tools/mesh_peaks.py [--mesh 16x16 | --multipod] [--shape S]
        [--strategy 2d] [--tally N] [--sites N]
        smollm-360m:4 qwen2.5-14b:6 zamba2-2.7b:6

``--shape`` names the cell's input shape: ``train_4k`` (the default, a
train step), ``prefill_32k`` (a prefill), ``decode_32k`` or ``long_500k``
(a decode step). ``--multipod`` counts on the multi-pod mesh, (2, 16, 16)
("pod", "data", "model"), in place of ``--mesh``.

Each ARCH:LAYERS cell (the arch's config with its depth cut to LAYERS;
ARCH alone keeps the whole depth) prints one JSON line: the torch version,
the peak in bytes and GiB, the counted FLOPs, bytes and collective bytes
by op, the seconds; with ``--tally N`` also the N largest groups of live
storages at the peak, each by the shape, dtype and op of the last tensor
made on it; with ``--sites N`` the N call sites that move the most
collective bytes, each with its op, count and bytes: the innermost frame of
the port's model or training code (``via``: the innermost frame of the
port, where that is another, such as a route in ``sharding/context.py``).
A collective of the backward that DTensor runs itself has the
``torch.autograd.grad`` call as its site. The numbers are counts, not
times: nothing runs on a card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from collections import Counter
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
# frames of the port that route a collective rather than ask for one
ROUTES = ("sharding", "core")


def _site() -> tuple:
    """(site, via) of the running collective: the innermost frame under
    the port but not under ROUTES, and the innermost under the port, each
    as path:line relative to the port (None where there is none); the
    counter's own frames are skipped."""
    site = via = None
    for frame in reversed(traceback.extract_stack()):
        path = Path(frame.filename)
        if PORT not in path.parents or path.name == "hlo_analysis.py":
            continue
        rel = path.relative_to(PORT)
        here = f"{rel}:{frame.lineno}"
        via = via or here
        if rel.parts[0] not in ROUTES:
            site = here
            break
    return site, (None if via == site else via)


def count_cell(arch: str, layers: int | None, mesh_shape: tuple,
               strategy: str, tally: int, sites: int = 0,
               shape: str = "train_4k") -> dict:
    import torch

    from _mesh_cells import fake_mesh, view_rule_2_11
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core import hlo_analysis
    from repro_torch.core.autotune import strategy_costs
    from repro_torch.models.registry import build_model

    made: dict = {}                     # storage key -> (shape, dtype, op)
    at_peak: list = []
    moved: Counter = Counter()          # (site, via, op) -> bytes
    calls: Counter = Counter()
    counter = hlo_analysis.CostCounter
    count, track = counter._count, counter.track

    def counting(self, func, args, kwargs, out):
        if tally:
            for t in hlo_analysis._tensors(out):
                key = hlo_analysis._local(t).untyped_storage()._cdata
                made[key] = (tuple(t.shape), str(t.dtype), func._opname)
        if not sites:
            return count(self, func, args, kwargs, out)
        before = dict(self.costs.collective_bytes_by_op)
        count(self, func, args, kwargs, out)
        for op, b in self.costs.collective_bytes_by_op.items():
            if b != before.get(op, 0):
                key = (*_site(), op)
                moved[key] += b - before.get(op, 0)
                calls[key] += 1

    def tracking(self, tensors):
        before = self.peak_bytes
        track(self, tensors)
        if self.peak_bytes > before:
            at_peak[:] = [(n, made.get(k)) for k, (n, _) in self._live.items()]

    cfg = ARCHS[arch] if layers is None else replace(ARCHS[arch],
                                                     n_layers=layers)
    t0 = time.perf_counter()
    try:
        if tally or sites:
            counter._count = counting
        if tally:
            counter.track = tracking
        with fake_mesh(mesh_shape) as mesh, view_rule_2_11():
            run = strategy_costs(build_model(cfg), SHAPES[shape], mesh,
                                 strategy)
    finally:
        counter._count, counter.track = count, track
    out = {"arch": arch, "layers": cfg.n_layers, "mesh": list(mesh_shape),
           **({} if shape == "train_4k" else {"shape": shape}),
           "strategy": strategy, "torch": torch.__version__,
           "peak_bytes": run.peak_bytes, "peak_gib": run.peak_bytes / 2 ** 30,
           "flops": run.costs.flops, "bytes": run.costs.hbm_bytes,
           "collective_bytes": dict(run.costs.collective_bytes_by_op),
           "seconds": time.perf_counter() - t0}
    if tally:
        size, n = Counter(), Counter()
        for nbytes, what in at_peak:
            size[what] += nbytes
            n[what] += 1
        out["tally"] = [{"bytes": b, "count": n[w], "made_as": w}
                        for w, b in size.most_common(tally)]
    if sites:
        out["sites"] = [{"site": k[0], "via": k[1], "op": k[2],
                         "count": calls[k], "bytes": b}
                        for k, b in moved.most_common(sites)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Counted peaks of dry-run cells on a fake mesh.")
    ap.add_argument("cells", nargs="+", help="ARCH or ARCH:LAYERS")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--multipod", action="store_true",
                    help="the (2, 16, 16) pod mesh, in place of --mesh")
    ap.add_argument("--shape", default="train_4k",
                    choices=("train_4k", "prefill_32k", "decode_32k",
                             "long_500k"))
    ap.add_argument("--strategy", default="2d")
    ap.add_argument("--tally", type=int, default=0)
    ap.add_argument("--sites", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(REPO / "src"), str(REPO / "tests")]
    mesh_shape = (2, 16, 16) if args.multipod else \
        tuple(int(s) for s in args.mesh.split("x"))
    for cell in args.cells:
        arch, _, layers = cell.partition(":")
        print(json.dumps(count_cell(arch, int(layers) if layers else None,
                                    mesh_shape, args.strategy, args.tally,
                                    args.sites, args.shape)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
