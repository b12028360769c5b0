#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path — the paper's predictor behind
``ForestEngine`` and ``MultiDeviceEngine`` — on the card, at the paper's
serving size: 512-tree extra-trees forests fitted on the committed
82-kernel x 4-size suite dataset (``tests/fixtures/suite_dataset_v1.json``),
served at dense depth 10. Phases, one JSON line each:

  env      torch / CUDA versions, the card, its power limit
  build    nvcc of ``src/repro_torch/csrc/forest.cu`` and its -Xptxas -v lines
  fit      the forests, fitted on the host
  kernel   the CUDA kernel against its plain torch version (``ref.py``) on
           the same CUDA tensors, depth {2,5,8,10} x batch {1,7,64,328,4096},
           rtol 1e-5 / atol 1e-6, bitwise repeatable
  serve    ForestEngine on the card (backend "hopper"): batched predict,
           a burst of async singles, cache hits, a hot-swap, then
           MultiDeviceEngine pricing and scheduling; answers held to the
           plain CPU dense path; launch counter read around the run
  timing   kernel, plain-version and engine times at B = 64 / 328 / 4096,
           beside the least time the card could take (the bound)

then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and ``{"ok": true, "device": {...}}`` last. Any
failed check raises and the script exits non-zero; without a CUDA device it
exits non-zero before printing any result. The kernel builds into
``build/kernels/``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FIXTURE = REPO / "tests" / "fixtures" / "suite_dataset_v1.json"

N_TREES = 512            # the reference's paper profile (bench_latency.py)
DEPTH = 10               # EngineConfig.dense_depth
DEPTHS = (2, 5, 8, 10)
BATCHES = (1, 7, 64, 328, 4096)
TIMED_BATCHES = (64, 328, 4096)
RTOL, ATOL = 1e-5, 1e-6
# NVIDIA's H100 SXM data sheet: the HBM rate, and the fp32 rate outside the
# tensor cores (which the compare/index/add work runs at)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, by
    CUDA events, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, name: str, iters: int = 50) -> float | None:
    """Mean device time of the kernels named ``name`` that ``fn()``
    launches, from torch.profiler's CUDA trace: the kernel alone, without
    the host's launch cost. None when the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    hits = [a for a in prof.key_averages() if name in a.key]
    count = sum(a.count for a in hits)
    if not count:
        return None
    return sum(a.device_time_total for a in hits) / count / 1e3


def bound(x, feature, threshold, depth: int) -> tuple[float, str, dict]:
    """Least time for one forest call on these inputs: the larger of (bytes
    this data's walks must read — each distinct node once — plus x and out,
    over the HBM rate) and (compare/index/add operations over the fp32
    rate)."""
    import torch
    B, F = x.shape
    T, N = feature.shape
    trees = torch.arange(T, device=x.device)[None, :]
    cur = torch.zeros((B, T), dtype=torch.int64, device=x.device)
    nodes = 0
    for _ in range(depth):
        nodes += torch.unique(trees * N + cur).numel()
        feat = feature[trees, cur]
        xv = torch.gather(x, 1, feat.clamp_min(0).long())
        left = (feat < 0) | (xv <= threshold[trees, cur])
        cur = torch.where(left, 2 * cur + 1, 2 * cur + 2)
    leaves = torch.unique(trees * N + cur).numel()
    n_bytes = nodes * 8 + leaves * 4 + B * F * 4 + B * 4
    n_ops = B * T * (3 * depth + 1)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, {"bytes": n_bytes, "ops": n_ops}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this run needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    import numpy as np

    from repro_torch.core.dataset import Dataset
    from repro_torch.core.devices import SIMULATED_DEVICES
    from repro_torch.core.forest import ExtraTreesRegressor
    from repro_torch.core.forest_torch import DenseForestTorch, to_dense
    from repro_torch.core.scheduler import schedule
    from repro_torch.kernels.forest import kernel as fk
    from repro_torch.kernels.forest import ops
    from repro_torch.kernels.forest.ref import forest_predict_ref
    from repro_torch.serve import ForestEngine, MultiDeviceEngine

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ------------------------------------------------------------- build
    t0 = time.perf_counter()
    info = fk.build()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if any(k in ln for k in ("registers", "spill", "smem",
                                      "Compiling entry", "bytes stack"))]
    emit("build", seconds=time.perf_counter() - t0,
         command=" ".join(info.command), ptxas=ptxas,
         tree_stride=fk.TREE_STRIDE)

    # --------------------------------------------------------------- fit
    t0 = time.perf_counter()
    ds = Dataset.load(FIXTURE).reduce_overrepresented()
    dev0, dev1 = SIMULATED_DEVICES[0].name, SIMULATED_DEVICES[1].name
    X, y0, _ = ds.matrix(dev0, "time_us")
    X = X.astype(np.float32)
    _, y1, _ = ds.matrix(dev1, "time_us")

    def fit(y, seed):
        return ExtraTreesRegressor(n_estimators=N_TREES, criterion="mse",
                                   max_features="max",
                                   seed=seed).fit(X, np.log(y))
    est, est_swap, est_dev1 = fit(y0, 0), fit(y0, 1), fit(y1, 0)
    if N_TREES % fk.TREE_STRIDE == 0:
        raise AssertionError("tree count must leave the last tree stride "
                             "ragged, to exercise the padding path")
    emit("fit", seconds=time.perf_counter() - t0, rows=int(X.shape[0]),
         features=int(X.shape[1]), trees=N_TREES,
         avg_depth=est.avg_depth(), devices=[dev0, dev1])

    # ------------------------------------------------------------ kernel
    rng = np.random.default_rng(0)

    def rows(B):
        """B distinct feature rows: the fixture's kernels, and past its 328
        rows, its kernels again with a 5 % multiplicative jitter (distinct
        rows, so the engine's de-duplication cannot shrink a batch)."""
        if B == len(X):
            return X
        r = X[rng.choice(len(X), B, replace=B > len(X))]
        if B > len(X):
            r = r * rng.lognormal(0.0, 0.05, r.shape).astype(np.float32)
        return np.ascontiguousarray(r, dtype=np.float32)

    def tables(depth, estimator=est):
        d = to_dense(estimator, depth)
        raw = (torch.as_tensor(d.feature, device=dev),
               torch.as_tensor(d.threshold, device=dev),
               torch.as_tensor(d.value, device=dev))
        return raw, ops.pad_trees(*raw)

    max_err = 0.0
    results = []
    for depth in DEPTHS:
        raw, padded = tables(depth)
        for B in BATCHES:
            x = torch.as_tensor(rows(B), device=dev)
            out = ops.forest_predict(x, *padded, depth=depth, n_trees=N_TREES)
            again = ops.forest_predict(x, *padded, depth=depth,
                                       n_trees=N_TREES)
            plain = forest_predict_ref(x, *raw, depth)
            torch.cuda.synchronize()
            torch.testing.assert_close(out, plain, rtol=RTOL, atol=ATOL)
            if not torch.equal(out, again):
                raise AssertionError(f"kernel not repeatable at depth "
                                     f"{depth}, B={B}")
            if B > 7:
                head = ops.forest_predict(x[:7].contiguous(), *padded,
                                          depth=depth, n_trees=N_TREES)
                if not torch.equal(head, out[:7]):
                    raise AssertionError("a row's answer depends on its batch")
            err = float((out - plain).abs().max())
            max_err = max(max_err, err)
            results.append({"depth": depth, "B": B, "max_abs_err": err,
                            "tile_rows": fk.tile_rows(B)})
    # non-finite features follow ref.py: NaN goes right, an inf in another
    # column leaves the walk alone
    raw, padded = tables(DEPTH)
    x = torch.as_tensor(rows(64), device=dev).clone()
    x[0, :] = float("nan")
    x[1, 3] = float("inf")
    x[2, 5] = float("-inf")
    x[3, 0] = float("nan")
    out = ops.forest_predict(x, *padded, depth=DEPTH, n_trees=N_TREES)
    plain = forest_predict_ref(x, *raw, DEPTH)
    torch.testing.assert_close(out, plain, rtol=RTOL, atol=ATOL)
    emit("kernel", cases=len(results), max_abs_err=max_err, rtol=RTOL,
         atol=ATOL, results=results, nonfinite_rows="ok")

    # ------------------------------------------------------------- serve
    def plain_cpu(estimator, Z):
        return DenseForestTorch(to_dense(estimator, DEPTH),
                                device="cpu")(Z).numpy().astype(np.float64)

    def close_to(got, want, what):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)

    ops.launches = 0                       # count the main path's launches
    t_serve = time.perf_counter()
    engine = ForestEngine(est, device="cuda")
    if engine.backend != "hopper":
        raise AssertionError(f"engine serves on {engine.backend!r}")
    want = plain_cpu(est, X)
    close_to(engine.predict(X), want, "batched predict")
    batches = engine.stats.batches
    close_to(engine.predict(X), want, "repeat predict")
    if engine.stats.batches != batches or engine.stats.cache_hits < len(X):
        raise AssertionError(f"repeat predict missed the cache: "
                             f"{engine.stats}")
    engine.cache_clear()
    futs = [engine.predict_async(X[i]) for i in range(200)]
    singles = np.array([f.result(timeout=60) for f in futs])
    close_to(singles, want[:200], "async singles")
    st = engine.stats_snapshot()
    burst = {"requests": st.requests, "flushes_size": st.flushes_size,
             "flushes_deadline": st.flushes_deadline,
             "batches": st.batches}
    gen = engine.swap_estimator(est_swap)
    if gen != 1 or engine.generation != 1:
        raise AssertionError(f"hot-swap generation {gen}")
    close_to(engine.predict(X), plain_cpu(est_swap, X), "after hot-swap")

    mde = MultiDeviceEngine.from_fits({dev0: (est, None),
                                       dev1: (est_dev1, None)})
    T_mat, P_mat = mde.price(X)
    for j, (name, e) in enumerate(((dev0, est), (dev1, est_dev1))):
        eng = mde.engines[name][MultiDeviceEngine.TIME]
        if eng.backend != "hopper":
            raise AssertionError(f"{name} engine serves on {eng.backend!r}")
        log_t = eng.predict(X)
        close_to(log_t, plain_cpu(e, X), f"{name} pricing")
        np.testing.assert_array_equal(T_mat[:, j], np.exp(log_t))
    sched = schedule(X, mde)
    if (len(sched.assignments) != len(X) or not np.isfinite(sched.makespan_us)
            or sched.makespan_us <= 0):
        raise AssertionError(f"bad schedule: {sched.makespan_us}")
    torch.cuda.synchronize()
    launches = ops.launches
    engine_batches = engine.stats.batches + sum(
        per[MultiDeviceEngine.TIME].stats.batches
        for per in mde.engines.values())
    if launches < engine_batches or launches == 0:
        raise AssertionError(f"{launches} kernel launches for "
                             f"{engine_batches} engine batches")
    emit("serve", seconds=time.perf_counter() - t_serve, backend="hopper",
         rows=int(len(X)), burst=burst, generation=engine.generation,
         price_shape=list(T_mat.shape), finite=bool(np.isfinite(T_mat).all()),
         makespan_us=sched.makespan_us, kernel_launches=launches,
         engine_batches=engine_batches)
    engine.close()
    mde.close()

    # ------------------------------------------------------------ timing
    raw, padded = tables(DEPTH)
    timing = []
    for B in TIMED_BATCHES:
        x = torch.as_tensor(rows(B), device=dev)
        def launch():
            return ops.forest_predict(x, *padded, depth=DEPTH,
                                      n_trees=N_TREES)
        k_ms = cuda_ms(launch, iters=200, warmup=20)
        d_ms = kernel_device_ms(launch, "forest_kernel")
        p_ms = cuda_ms(lambda: forest_predict_ref(x, *raw, DEPTH),
                       iters=20, warmup=3)
        b_ms, b_by, work = bound(x, *raw[:2], DEPTH)
        # one engine call on uncached rows: launches and host-clock latency
        with ForestEngine(est, device="cuda", cache_size=0) as eng:
            xs = rows(B)
            eng.predict(xs)
            before = ops.launches
            eng.predict(xs)
            per_call = ops.launches - before
            n = 20
            t0 = time.perf_counter()
            for _ in range(n):
                eng.predict(xs)
            e_ms = (time.perf_counter() - t0) / n * 1e3
        timing.append({"B": B, "ms": k_ms, "device_ms": d_ms,
                       "plain_ms": p_ms, "bound_ms": b_ms,
                       "bound_by": b_by, **work, "launches_per_call": per_call,
                       "engine_ms": e_ms, "engine_rows_per_s": B / e_ms * 1e3,
                       "library_ms": None, "tile_rows": fk.tile_rows(B)})
        emit("timing", **timing[-1], depth=DEPTH, trees=N_TREES, card=smi)

    main_b = next(t for t in timing if t["B"] == X.shape[0])
    print(json.dumps({"kernels": [{
        "name": "forest_predict_f32", "route": "cuda",
        "source": "src/repro_torch/csrc/forest.cu",
        "replaces": "src/repro/kernels/forest/kernel.py:37",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_b["ms"], "device_ms": main_b["device_ms"],
        "plain_ms": main_b["plain_ms"],
        "bound_ms": main_b["bound_ms"], "bound_by": main_b["bound_by"],
        "library_ms": None, "batch": main_b["B"], "depth": DEPTH,
        "trees": N_TREES}]}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
