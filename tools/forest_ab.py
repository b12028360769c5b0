#!/usr/bin/env python3
"""Time the forest kernel (B1) and the forest engine of one checkout of the
PyTorch/CUDA port on one CUDA card.

    python3 tools/forest_ab.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``), fits the
512-tree forest ``chip_smoke.py`` serves (the committed suite fixture, seed
0, dense depth 10) and prints one JSON line per batch B = 64 / 328 / 4096:

  ms          back-to-back calls of the served path's kernel wrapper on rows
              already on the card, by CUDA events
  device_ms   the forest kernels alone (every kernel whose name holds
              ``forest_``), from torch.profiler
  backend_ms  host clock around the engine's backend call (rows to the
              card, the kernel, answers back)
  engine_ms   host clock around ``ForestEngine.predict`` of B uncached rows

then the card's name and power limit. The served path is the one that
checkout's ``serve/backend.py`` takes: tables packed once
(``ops.pack_tables``) where the checkout has it, else dense tables padded
once to the kernel's tree stride (``ops.pad_trees``), the forest API before
packed tables. So two commits compare on one card, in turns:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for s in build/parent/src src src build/parent/src; do
        python3 tools/forest_ab.py --src $s; done

Without a CUDA device it exits 2 before printing any result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCHES = (64, 328, 4096)
N_TREES, DEPTH = 512, 10


def served_call(ops, dense, dev):
    """The served path's kernel call for ``dense`` on ``dev``, tables
    prepared once as the checkout's ``serve/backend.py`` prepares them."""
    import torch
    raw = (torch.as_tensor(dense.feature, dtype=torch.int32, device=dev),
           torch.as_tensor(dense.threshold, dtype=torch.float32, device=dev),
           torch.as_tensor(dense.value, dtype=torch.float32, device=dev))
    if hasattr(ops, "pack_tables"):
        packed = ops.pack_tables(*raw, depth=dense.depth,
                                 n_features=dense.n_features)
        return lambda x: ops.forest_predict_packed(x, packed)
    padded = ops.pad_trees(*raw)
    return lambda x: ops.forest_predict(x, *padded, depth=dense.depth,
                                        n_trees=dense.n_trees)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=REPO / "src",
                        help="the src directory of the checkout to time")
    parser.add_argument("--label", default=None)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("forest_ab: torch sees no CUDA device; this run needs one",
              file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(REPO))
    import numpy as np

    import chip_smoke as cs
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.devices import SIMULATED_DEVICES
    from repro_torch.core.forest import ExtraTreesRegressor
    from repro_torch.core.forest_torch import to_dense
    from repro_torch.kernels.forest import ops
    from repro_torch.serve import ForestEngine
    if not Path(ops.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"imported {ops.__file__}, not from {src}")

    dev = torch.device("cuda")
    ds = Dataset.load(cs.FIXTURE).reduce_overrepresented()
    X, y, _ = ds.matrix(SIMULATED_DEVICES[0].name, "time_us")
    X = X.astype(np.float32)
    est = ExtraTreesRegressor(n_estimators=N_TREES, criterion="mse",
                              max_features="max",
                              seed=0).fit(X, np.log(y))
    call = served_call(ops, to_dense(est, DEPTH), dev)
    rng = np.random.default_rng(0)
    label = args.label or str(args.src)
    for B in BATCHES:
        # distinct rows: the fixture's, jittered past its 328 (as
        # chip_smoke.py's rows())
        rows = X[rng.choice(len(X), B, replace=B > len(X))]
        if B > len(X):
            rows = rows * rng.lognormal(0.0, 0.05, rows.shape)
        rows = np.ascontiguousarray(rows, dtype=np.float32)
        x = torch.as_tensor(rows, device=dev)
        ms = cs.cuda_ms(lambda: call(x), iters=500, warmup=50)
        device_ms = cs.kernel_device_ms(lambda: call(x), "forest_")
        with ForestEngine(est, device="cuda", cache_size=0) as eng:
            eng.predict(rows)
            n = 50
            t0 = time.perf_counter()
            for _ in range(n):
                eng._predict_fn(rows)
            backend_ms = (time.perf_counter() - t0) / n * 1e3
            t0 = time.perf_counter()
            for _ in range(n):
                eng.predict(rows)
            engine_ms = (time.perf_counter() - t0) / n * 1e3
        print(json.dumps({"label": label, "B": B, "ms": ms,
                          "device_ms": device_ms, "backend_ms": backend_ms,
                          "engine_ms": engine_ms}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
