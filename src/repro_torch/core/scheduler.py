"""Heterogeneous cluster scheduler driven by the predictor — the paper's
motivating use case (§1: task placement across heterogeneous processors,
provisioning, time/power trade-offs).

Given a set of kernels (feature vectors, recorded ONCE — the portability
property) and per-device-type trained forests, the scheduler:
  * predicts (time, power) for every (kernel, device-type, operating-point)
    triple — DVFS grids (``DeviceModel.freq_grid``) are priced by transform
    of ONE nominal prediction per device (t ∝ 1/f, power via a fitted
    ``core.power.PowerSplit``), so grid size never multiplies serving cost,
  * assigns kernels to the (device queue, frequency) minimizing the chosen
    objective (makespan-greedy "fastest queue", energy = P*t, or
    energy-delay product), choosing the frequency PER ASSIGNMENT subject to
    the remaining deadline slack,
  * respects per-device queues (list scheduling).

The paper's latency requirement (§7.1: scheduling decisions orders of
magnitude shorter than execution) is met by the flat/batched predictor —
one batched forest call prices the whole (kernels x devices) matrix.

When the predictor is a shared service (the cluster tier) rather than a
library call, the scheduler's DEADLINE is what should order the service's
admission queue: ``schedule(..., deadline_s=...)`` threads the remaining
slack into every deadline-aware predictor call, and ``slack_priority``
maps that slack onto the admission priority bands — tight-deadline
scheduling requests jump the queue, background refits do not, and no
caller ever chooses a magic priority int.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

#: Slack bands (seconds) for ``slack_priority``: a request whose remaining
#: deadline slack falls in band i dispatches at priority i (lower = first).
#: The bands bracket the paper's 15–108 ms single-prediction cost: <=10 ms
#: slack means the caller is already inside one prediction's budget.
PRIORITY_BANDS = (0.010, 0.050, 0.250, 1.0)

#: Priority assigned to requests with no deadline at all (background work:
#: refit probes, batch repricing) — after every deadlined band.
PRIORITY_BACKGROUND = len(PRIORITY_BANDS) + 1


def slack_priority(slack_s: float | None,
                   bands: tuple = PRIORITY_BANDS) -> int:
    """Admission priority from remaining deadline slack (lower = first).

    The cluster frontend calls this for every submit that does not pin an
    explicit priority, and the network transport carries only the deadline
    — so a remote scheduler's urgency is derived from its slack END TO END
    instead of being a caller-chosen int.

    <= bands[0] slack -> 0 (most urgent), ... > bands[-1] -> len(bands);
    ``None`` (no deadline) -> ``PRIORITY_BACKGROUND``, after every
    deadlined request.
    """
    if slack_s is None:
        return len(bands) + 1
    for i, edge in enumerate(bands):
        if slack_s <= edge:
            return i
    return len(bands)


@dataclass
class DevicePredictor:
    name: str
    time_fn: object                 # ForestEngine (or anything with
    power_fn: object | None = None  # .predict), or a bare X -> y callable
    log_time: bool = True
    count: int = 1                  # identical devices of this type
    # DVFS pricing. The forests predict at the NOMINAL clock (f=1.0);
    # operating points are priced by transform: kernels run ~1/f slower
    # below nominal (conservative — memory-bound kernels slow down less),
    # and power follows ``power_split`` (a fitted ``core.power.PowerSplit``;
    # None = the legacy assumed-cubic P ∝ f³).
    #
    # ``freq_scale`` pins the device to ONE operating point (the legacy
    # scalar path); ``freq_grid`` offers a DISCRETE grid the scheduler
    # chooses from PER ASSIGNMENT (``DeviceModel.freq_grid``). When a grid
    # is given it replaces ``freq_scale``. At the default (no grid,
    # freq_scale=1.0) pricing is exactly the forests' prediction.
    freq_scale: float = 1.0
    freq_grid: tuple[float, ...] | None = None
    power_split: object | None = None   # core.power.PowerSplit | None


def _predict(model, X, deadline_s: float | None = None) -> np.ndarray:
    """Serve from a ForestEngine/estimator (``.predict``) or a bare callable.
    Engines get the whole kernel batch in ONE call (micro-batching and the
    feature-vector cache live inside the engine). A remaining ``deadline_s``
    is forwarded to deadline-aware predictors (remote replicas, cluster
    frontends) so the serving tier can order its admission queue by the
    scheduler's real slack."""
    fn = getattr(model, "predict", None)
    target = fn if fn is not None else model
    if deadline_s is not None and deadline_s > 0:
        # a burned budget (<= 0) degrades to the plain call: forwarding a
        # negative deadline would make the serving tier fail the request
        # (DeadlineExceeded) and abort the half-priced matrix — late but
        # complete beats failed
        from ..serve.backend import supports_deadline
        if supports_deadline(target):
            return np.asarray(target(X, deadline_s=deadline_s),
                              dtype=np.float64)
    return np.asarray(target(X), dtype=np.float64)


def _as_predictors(devices) -> list[DevicePredictor]:
    """Accept a list[DevicePredictor] or a serve.MultiDeviceEngine."""
    to_dp = getattr(devices, "to_device_predictors", None)
    return to_dp() if to_dp is not None else list(devices)


@dataclass
class Assignment:
    kernel: int
    device: str
    queue_slot: int
    t_us: float
    power_w: float
    start_us: float
    freq: float = 1.0              # chosen DVFS operating point (1 = nominal)


@dataclass
class Schedule:
    assignments: list
    makespan_us: float
    energy_j: float
    predict_seconds: float
    deadline_us: float | None = None   # execution deadline the selection saw
    meets_deadline: bool | None = None

    def operating_points(self) -> list:
        """Chosen (device, freq) per assignment, in assignment order — what
        the cluster tier reports in dispatch results."""
        from .devices import OperatingPoint
        return [OperatingPoint(a.device, a.freq) for a in self.assignments]


def _device_grid(d) -> tuple[float, ...]:
    """Effective operating-point grid of one DevicePredictor: the discrete
    ``freq_grid`` when given, else the single legacy ``freq_scale`` point."""
    grid = getattr(d, "freq_grid", None)
    if not grid:
        grid = (getattr(d, "freq_scale", 1.0),)
    grid = tuple(float(f) for f in grid)
    for f in grid:
        if not f > 0:
            raise ValueError(
                f"operating-point frequency must be > 0 on "
                f"{d.name!r}, got {f}")
    return grid


def _power_scale(d, f: float) -> float:
    """Relative power at operating point ``f`` under the device's split
    (fitted ``PowerSplit``), defaulting to the legacy assumed P ∝ f³."""
    split = getattr(d, "power_split", None)
    return f ** 3 if split is None else float(split.scale(f))


def predict_matrix(X: np.ndarray, devices, *,
                   deadline_s: float | None = None):
    """(n_kernels, n_devices) predicted time_us and power_w at each
    device's PINNED operating point (``freq_scale``; nominal by default).

    ``devices`` is a list of DevicePredictor (whose predictors may be
    ForestEngines or callables) or a ``serve.MultiDeviceEngine``.

    ``deadline_s`` is the budget for the WHOLE matrix: each successive
    predictor call receives the slack still remaining, so a serving tier
    sees the scheduler's true urgency grow as the budget burns down.

    Per-assignment frequency SELECTION prices the whole grid instead —
    see ``predict_operating_points``."""
    T3, P3, grids = predict_operating_points(
        X, devices, deadline_s=deadline_s, pinned=True)
    return T3[:, :, 0], P3[:, :, 0]


def predict_operating_points(X: np.ndarray, devices, *,
                             deadline_s: float | None = None,
                             pinned: bool = False):
    """Price the full (kernels × devices × operating points) tensor.

    Returns ``(T, P, grids)``: T and P have shape (n_kernels, n_devices,
    max_grid) — entries beyond a device's grid are +inf (never chosen) —
    and ``grids[j]`` is device j's frequency tuple. One batched predictor
    call per (device, target) prices the NOMINAL clock; each operating
    point is a transform of it (t ∝ 1/f, power via the device's
    ``PowerSplit`` — fitted, or the assumed-cubic default), so grid size
    never multiplies serving cost.

    ``pinned=True`` collapses every device to its single ``freq_scale``
    point (the ``predict_matrix`` view)."""
    devices = _as_predictors(devices)
    if pinned:
        grids = [(float(getattr(d, "freq_scale", 1.0)),) for d in devices]
        for d, g in zip(devices, grids):
            if not g[0] > 0:
                raise ValueError(f"freq_scale must be > 0 on {d.name!r}, "
                                 f"got {g[0]}")
    else:
        grids = [_device_grid(d) for d in devices]
    n = X.shape[0]
    gmax = max(len(g) for g in grids)
    T = np.full((n, len(devices), gmax), np.inf)
    P = np.full((n, len(devices), gmax), np.inf)
    t_deadline = (None if deadline_s is None
                  else time.monotonic() + deadline_s)

    def remaining() -> float | None:
        return (None if t_deadline is None
                else t_deadline - time.monotonic())

    for j, d in enumerate(devices):
        t = _predict(d.time_fn, X, deadline_s=remaining())
        t_nom = np.exp(t) if d.log_time else t
        p_nom = (_predict(d.power_fn, X, deadline_s=remaining())
                 if d.power_fn is not None else 1.0)
        for g, f in enumerate(grids[j]):
            T[:, j, g] = t_nom / f
            P[:, j, g] = p_nom * _power_scale(d, f)
    return T, P, grids


def schedule(X: np.ndarray, devices, objective: str = "makespan", *,
             deadline_s: float | None = None) -> Schedule:
    """List-schedule kernels (longest-processing-time first) onto the
    (device queue, operating point) minimizing the objective increment.

    ``deadline_s`` plays two roles, both "when the caller needs this done":
    it bounds the DECISION — threaded into every deadline-aware predictor
    call, prioritizing this scheduler's requests by real slack — and, for
    devices that expose a ``freq_grid``, it constrains the EXECUTION: each
    assignment picks the frequency minimizing its objective among the
    operating points whose queue still finishes within the deadline
    (energy: tight kernels speed up, slack kernels run at the
    energy-optimal clock). When no option fits, the fastest completion is
    taken — late but least-late beats an arbitrary choice. Devices without
    a grid keep the exact legacy behavior (one pinned point, unconstrained
    placement), so existing callers and the slack-priority bands are
    unchanged.

    Selection policy (independently re-implemented as the brute-force
    oracle in tests/test_dvfs.py):

    * **Placement** — for each kernel in LPT order, enumerate every
      (queue, grid frequency) option: for the energy objective only each
      device's FASTEST point (frequency choice is the downshift pass's
      job — placing slow up front would burn slack later kernels need,
      so time commits at the fastest point while the COST is the
      kernel's eventual energy there: its minimum p·t over the grid);
      for makespan/edp the whole grid. An option is FEASIBLE when its
      completion plus the queue's fair-share reservation of the still-
      unscheduled work (sum of remaining kernels' fastest times / number
      of queues) stays within the deadline. Among feasible options
      minimize the objective cost (makespan: completion; energy: p·t;
      edp: completion·p·t), ties broken by earliest completion; when
      nothing is feasible take the fastest completion — late but
      least-late. First strictly-better option wins — deterministic in
      (queue, grid) order.
    * **Downshift (energy objective with a grid)** — per queue,
      repeatedly apply the single grid-step downshift with the best
      energy-saving-per-added-microsecond ratio that still fits the
      queue's remaining deadline slack (ties: larger kernel first, then
      placement order), until no step saves energy or fits. This
      water-fills the slack evenly across the queue — tight kernels stay
      fast, slack kernels settle at the energy-optimal clock — and is
      never worse than pinning every device to the best fixed frequency
      that meets the deadline.
    """
    if objective not in ("makespan", "energy", "edp"):
        raise ValueError(f"unknown objective {objective!r} "
                         f"(makespan | energy | edp)")
    devices = _as_predictors(devices)
    t0 = time.perf_counter()
    has_grid = any(getattr(d, "freq_grid", None) for d in devices)
    T, P, grids = predict_operating_points(
        X, devices, deadline_s=deadline_s, pinned=not has_grid)
    t_pred = time.perf_counter() - t0
    # the execution-deadline constraint only binds when there is a grid to
    # choose from: without one the option set is a single point per device
    # and legacy placement must be preserved verbatim
    deadline_us = (deadline_s * 1e6
                   if deadline_s is not None and has_grid else None)
    two_phase = has_grid and objective == "energy"

    queues: list[tuple[str, int]] = []
    for d in devices:
        queues.extend((d.name, c) for c in range(d.count))
    dev_index = {d.name: j for j, d in enumerate(devices)}
    ready = np.zeros(len(queues))
    tmin = T.min(axis=(1, 2))                   # fastest option per kernel
    if two_phase:
        # eventual post-downshift energy per (kernel, device): the
        # placement cost (padding is inf·inf, never the min)
        e_min = (P * T).min(axis=2)
    order = np.argsort(-tmin)                   # LPT heuristic
    remaining_min = float(tmin.sum())
    out = []
    placed: list[tuple[int, int]] = []          # (queue, device) per row
    for k in order:
        remaining_min -= float(tmin[k])
        reserve = (remaining_min / len(queues)
                   if deadline_us is not None else 0.0)
        best, best_key, best_q = None, None, -1
        for qi, (dname, _) in enumerate(queues):
            j = dev_index[dname]
            if two_phase:                       # fastest point only
                g_opts = (int(np.argmax(grids[j])),)
            else:
                g_opts = range(len(grids[j]))
            for g in g_opts:
                f = grids[j][g]
                t, p = T[k, j, g], P[k, j, g]
                finish = ready[qi] + t
                if objective == "makespan":
                    cost = finish
                elif objective == "energy":
                    cost = e_min[k, j] if two_phase else p * t
                else:                            # energy-delay product
                    cost = finish * p * t
                if not has_grid:
                    key = (cost,)                # exact legacy ordering
                elif (deadline_us is None
                        or finish + reserve <= deadline_us):
                    key = (0, cost, finish)
                else:
                    key = (1, finish, finish)
                if best_key is None or key < best_key:
                    best_key, best_q, best = key, qi, (t, p, f)
        t, p, f = best
        out.append(Assignment(kernel=int(k), device=queues[best_q][0],
                              queue_slot=queues[best_q][1], t_us=t,
                              power_w=p, start_us=float(ready[best_q]),
                              freq=f))
        placed.append((best_q, dev_index[queues[best_q][0]]))
        ready[best_q] += t

    if two_phase:
        _downshift(out, placed, T, P, grids, ready, deadline_us)

    energy = sum(a.power_w * a.t_us for a in out) * 1e-6
    makespan = float(ready.max())
    return Schedule(assignments=out, makespan_us=makespan,
                    energy_j=energy, predict_seconds=t_pred,
                    deadline_us=deadline_us,
                    meets_deadline=(None if deadline_us is None
                                    else makespan <= deadline_us))


def _downshift(out: list, placed: list, T, P, grids, ready,
               deadline_us: float | None) -> None:
    """Energy water-filling pass (see ``schedule``): step assignments down
    their device's frequency grid, best saving-per-microsecond first,
    while the queue still meets the deadline. Mutates assignments (t_us,
    power_w, freq, start_us) and the per-queue ``ready`` totals."""
    by_queue: dict[int, list[int]] = {}
    for i, (qi, _j) in enumerate(placed):
        by_queue.setdefault(qi, []).append(i)
    for qi, rows in by_queue.items():
        while True:
            slack = (np.inf if deadline_us is None
                     else deadline_us - ready[qi])
            best = None                # (ratio, -t_us, order, row, g_next)
            for i in rows:
                a = out[i]
                j = placed[i][1]
                grid = grids[j]
                lower = [g for g, f in enumerate(grid) if f < a.freq]
                if not lower:
                    continue
                g_next = max(lower, key=lambda g: grid[g])  # one step down
                dt = T[a.kernel, j, g_next] - a.t_us
                de = (P[a.kernel, j, g_next] * T[a.kernel, j, g_next]
                      - a.power_w * a.t_us)
                if de >= 0 or dt > slack:
                    continue           # past the energy optimum / no room
                key = (de / max(dt, 1e-12), -a.t_us, i)
                if best is None or key < best[:3]:
                    best = (*key, g_next)
            if best is None:
                break
            _ratio, _neg_t, i, g_next = best
            a, j = out[i], placed[i][1]
            ready[qi] += T[a.kernel, j, g_next] - a.t_us
            a.t_us = float(T[a.kernel, j, g_next])
            a.power_w = float(P[a.kernel, j, g_next])
            a.freq = float(grids[j][g_next])
        # starts shifted by the new durations: recompute cumulatively
        start = 0.0
        for i in rows:
            out[i].start_us = start
            start += out[i].t_us


def speedup_vs_baseline(X, devices, baseline: str = "single") -> dict:
    """Compare predictor-driven placement vs naive baselines (round-robin,
    all-on-fastest-device) — the quantified scheduler win."""
    devices = _as_predictors(devices)
    sched = schedule(X, devices)
    T, P = predict_matrix(X, devices)
    # round-robin over all queues
    queues = []
    for d in devices:
        queues.extend([0.0] * d.count)
    names = []
    for d in devices:
        names.extend([d.name] * d.count)
    dev_index = {d.name: j for j, d in enumerate(devices)}
    for k in range(X.shape[0]):
        qi = k % len(queues)
        queues[qi] += T[k, dev_index[names[qi]]]
    rr = max(queues)
    single = T[:, 0].sum()                       # everything on device 0
    return {"scheduled_us": sched.makespan_us, "round_robin_us": rr,
            "single_device_us": single,
            "speedup_vs_rr": rr / sched.makespan_us,
            "speedup_vs_single": single / sched.makespan_us,
            "predict_seconds": sched.predict_seconds}
