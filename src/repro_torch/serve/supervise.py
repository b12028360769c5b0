"""TransferSupervisor: the cold-start tier that manages itself.

PR 9's transfer tier serves an unseen device from second zero, but every
step after that was manual: nothing fed real measurements back into
``CalibrationMonitor``, nothing called ``calibrate(device=...)`` when the
real spec sheet landed, and ``to_forest()`` graduation was an operator
action. Stevens & Klöckner (arXiv 1904.09538) show cross-machine
predictors stay accurate only when retrained against fresh measurements,
and Ilager et al. (arXiv 2004.08177) argue the serving loop should be
driven end-to-end by that data — this module is that loop, run as an
``EngineRefresher``-style background thread:

1. **feedback** — every new ``DatasetStore`` sample (the streaming
   collector's sink) carrying a managed device's target is folded back
   through ``TransferPredictor.ingest_store``, which records the
   PRE-update prediction against the measured ``time_us``/``power_w`` in
   the monitor: ``calibration.mape{device,target}`` is real serving
   error, not test-only simulated ground truth.
2. **auto-graduation** — per device, the live MAPE trajectory is watched;
   when the transfer tier stops beating its own trailing window (and has
   ``min_graduate_samples``), ``to_forest()`` is fitted OFF the serving
   lock and atomically swapped into the device's ``ReplicaPool`` slot
   (``swap_engine``: generation bump, zero dropped requests — in-flight
   dispatches finish on the old engine, which stays answerable).
3. **pricing-matrix admission** — a graduating time-target device also
   enters the scheduler's matrix via ``MultiDeviceEngine.add_device``,
   not just the frontend.
4. **auto re-target** — ``announce_spec(name, device)`` queues the real
   spec sheet; the next cycle calls ``calibrate(device=...)`` and REPLAYS
   the store's full history onto the new prior (the re-target resets the
   ingest high-water mark), all mid-serve.
5. **probe budgeting** — ``plan_probes`` allocates a fleet's next
   measurements across the uncalibrated devices, highest-MAPE-first or
   coverage-first, both deterministic (``PYTHONHASHSEED``-independent).

Alerting: any series whose rolling MAPE exceeds the paper's offline
envelope upper bound (52 % time / 2.94 % power MAPE, Tables 4/5 —
``PAPER_ENVELOPE_PCT``) is surfaced via ``stats.alerts`` and the
``supervisor.envelope_exceeded`` gauge.

``supervise_once()`` is the synchronous unit (tests, benches, custom
loops); ``start()`` runs it on a poll thread that
``StreamingCollector.add_on_chunk(supervisor.on_chunk)`` can poke for
sub-poll-latency reaction. The smoke entry point
(``python -m repro_torch.serve.supervise``) stages day-zero → measured feedback
→ auto-graduation end to end and exits nonzero on any broken link.

Docs: docs/portability.md (graduation state machine, probe policies) and
docs/observability.md (metric kinds, alert wiring).

A copy of ``repro.serve.supervise`` over the port's engines. The smoke
serves the graduated forest on the card, through the CUDA forest kernel
(``EngineConfig``'s default there); ``--device cpu`` serves it with the
reference's ``tree-walk`` on the host.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from ..core.dataset import DatasetStore
from ..core.transfer import TransferPredictor, select_probes
from .engine import EngineConfig, ForestEngine

__all__ = ["GraduatedEngine", "PAPER_ENVELOPE_PCT", "PROBE_POLICIES",
           "SupervisorConfig", "SupervisorStats", "TransferSupervisor"]

#: Paper Tables 4/5 offline cross-validation envelope, upper bounds: time
#: MAPE spans 8.86-52 % across devices, power 1.84-2.94 %. A live series
#: past these is worse than the paper's WORST offline device — alert.
PAPER_ENVELOPE_PCT = {"time_us": 52.0, "power_w": 2.94}

PROBE_POLICIES = ("highest-mape", "coverage")

#: MAPE rank assigned to a (device, target) series with no samples yet:
#: worse than any measured series, finite so the in-plan discount can
#: round-robin the first probes across several unmeasured devices.
_UNMEASURED_MAPE = 1e9


@dataclass(frozen=True)
class SupervisorConfig:
    """Knobs for the supervision loop. Defaults favor PATIENCE: a device
    graduates only once the transfer tier demonstrably stopped improving,
    never on a lucky early window."""
    poll_s: float = 0.05               # background loop cadence
    min_graduate_samples: int = 32     # never graduate before this many
    plateau_window: int = 6            # trailing MAPE readings compared
    plateau_rel_improve: float = 0.02  # window must improve >= 2 % (rel.)
    probe_policy: str = "highest-mape"
    envelope_pct: dict = field(
        default_factory=lambda: dict(PAPER_ENVELOPE_PCT))
    engine_config: EngineConfig | None = None   # graduated ForestEngine cfg

    def __post_init__(self):
        if self.probe_policy not in PROBE_POLICIES:
            raise ValueError(f"unknown probe policy {self.probe_policy!r} "
                             f"(have {PROBE_POLICIES})")


@dataclass
class SupervisorStats:
    polls: int = 0                 # supervise_once cycles completed
    ingested: int = 0              # store samples folded into transfer tiers
    feedback: int = 0              # post-graduation (pred, measured) records
    graduations: int = 0           # transfer -> forest swaps committed
    retargets: int = 0             # calibrate(device=...) + history replays
    alerts: int = 0                # series that ENTERED envelope violation
    errors: int = 0                # supervise_once failures (loop survives)
    last_store_version: int = -1   # store version last cycle consumed


class GraduatedEngine:
    """Linear-output adapter over a graduated ``ForestEngine``.

    ``TransferPredictor.to_forest`` fits the LOG target (the paper's Eq. 1
    rationale: targets span ~8 orders of magnitude), so the raw engine
    answers log-µs. A pool slot whose transfer predictor served linear µs
    (``log_output=False``) keeps its output contract across the graduation
    swap by exponentiating here. Duck-types the serving surface the pool
    and frontend require.
    """

    def __init__(self, engine: ForestEngine):
        self.engine = engine
        self.n_features = engine.n_features

    @property
    def generation(self) -> int:
        return self.engine.generation

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.exp(self.engine.predict(X))

    def stats_snapshot(self):
        return self.engine.stats_snapshot()

    def close(self) -> None:
        self.engine.close()


@dataclass
class _Managed:
    """One supervised device slot: the predictor and its lifecycle state."""
    key: str                           # registration key (stable across
                                       # re-targets; monitor series follow
                                       # predictor.device.name)
    predictor: TransferPredictor
    replica: str | None                # ReplicaPool slot to swap on gradu.
    stage: str = "transfer"            # "transfer" | "forest"
    history: deque = field(default_factory=lambda: deque(maxlen=1))
    last_n: int = -1                   # n_observed at last history push
    pending_spec: object = None        # queued announce_spec payload
    engine: ForestEngine | None = None  # raw (log-target) engine post-grad.
    graduated_at_n: int = 0
    tracked: int = 0                   # store mark for post-grad feedback


class TransferSupervisor:
    """Self-managing transfer tier over one ``DatasetStore`` of measured
    ground truth (see module docstring for the five duties).

    ``pool`` (optional ``cluster.ReplicaPool``) receives the graduation
    engine swap for devices registered with a ``replica=`` slot name;
    ``multi_engine`` (optional ``serve.MultiDeviceEngine``) admits
    graduating time-target devices into the pricing matrix. Without
    either, graduation still fits the forest and flips the stage — the
    caller reads it from ``stats_snapshot()``.
    """

    def __init__(self, store: DatasetStore, monitor, *,
                 pool=None, multi_engine=None,
                 config: SupervisorConfig | None = None, registry=None):
        self.store = store
        self.monitor = monitor
        self.pool = pool
        self.multi_engine = multi_engine
        self.config = config or SupervisorConfig()
        self.stats = SupervisorStats()
        self._devices: dict[str, _Managed] = {}
        self._violating: set[tuple[str, str]] = set()
        self._lock = threading.Lock()          # devices table + stats
        self._cycle_lock = threading.Lock()    # one supervise_once at a time
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if registry is not None:
            self.register_metrics(registry)

    # ------------------------------------------------------------ enrollment

    def manage(self, predictor: TransferPredictor, *,
               replica: str | None = None, key: str | None = None) -> str:
        """Enroll a transfer predictor; returns its registration key
        (defaults to the predictor's current device name). ``replica``
        names the ``ReplicaPool`` slot this predictor serves, so
        graduation knows where to swap the fitted forest."""
        key = str(key if key is not None else predictor.device.name)
        if replica is not None and self.pool is not None \
                and replica not in self.pool.replicas:
            raise KeyError(f"no replica {replica!r} in pool "
                           f"(have {self.pool.names})")
        m = _Managed(key=key, predictor=predictor, replica=replica,
                     history=deque(maxlen=self.config.plateau_window))
        with self._lock:
            if key in self._devices:
                raise ValueError(f"device {key!r} already managed")
            self._devices[key] = m
        return key

    def announce_spec(self, key: str, device) -> None:
        """The real spec sheet landed mid-serve: queue a re-target. The
        next cycle calls ``calibrate(device=...)`` on the predictor and
        replays the store's history onto the new prior."""
        with self._lock:
            m = self._devices[key]
            if m.stage != "transfer":
                raise ValueError(f"device {key!r} already graduated")
            m.pending_spec = device
        self._wake.set()

    def on_chunk(self, version: int | None = None,
                 n: int | None = None) -> None:
        """Chunk listener for ``StreamingCollector.add_on_chunk`` — pokes
        the background loop so fresh measurements are folded in without
        waiting out ``poll_s``."""
        self._wake.set()

    # ------------------------------------------------------------- one cycle

    def supervise_once(self) -> dict:
        """One supervision cycle: re-targets, feedback ingestion,
        graduation checks, envelope alerts. Returns a summary dict of what
        happened (all lists empty on a quiet cycle). Serialized — a manual
        call and the background loop never interleave."""
        with self._cycle_lock:
            return self._cycle()

    def _cycle(self) -> dict:
        cfg = self.config
        out = {"ingested": 0, "feedback": 0, "retargeted": [],
               "graduated": [], "alerts": []}
        with self._lock:
            managed = sorted(self._devices.values(), key=lambda m: m.key)

        # 1. queued re-targets first, so the replay below lands on the new
        #    prior instead of one cycle later
        for m in managed:
            with self._lock:
                spec, m.pending_spec = m.pending_spec, None
            if spec is None or m.stage != "transfer":
                continue
            m.predictor.calibrate([], device=spec)
            m.predictor.ingest_store(self.store)   # replay full history
            m.history.clear()
            m.last_n = -1
            with self._lock:
                self.stats.retargets += 1
            out["retargeted"].append(m.key)

        # 2. feedback: fold new measured samples into every transfer-stage
        #    predictor (records (pre-update predicted, measured) pairs into
        #    the monitor); score graduated forests against the same truth
        samples, version = self.store.raw()
        for m in managed:
            if m.stage == "transfer":
                out["ingested"] += m.predictor.ingest_store(self.store)
            else:
                out["feedback"] += self._track_graduated(m, samples)

        # 3. graduation: a hybrid-stage device that stopped beating its own
        #    trailing MAPE window has outgrown the transfer tier
        for m in managed:
            if m.stage != "transfer":
                continue
            st = m.predictor.stats_snapshot()
            mape = self.monitor.mape(st.device, st.target)
            if mape is not None and st.n_observed > m.last_n:
                # push only when new ground truth arrived: idle polls must
                # not flood the window with identical readings and fake a
                # plateau
                m.history.append(float(mape))
                m.last_n = st.n_observed
            if (st.mode == "hybrid"
                    and st.n_observed >= cfg.min_graduate_samples
                    and len(m.history) == m.history.maxlen
                    and m.history[-1] >= m.history[0]
                    * (1.0 - cfg.plateau_rel_improve)):
                self._graduate(m, st)
                out["graduated"].append(m.key)

        # 4. envelope alerts: count each series ONCE as it enters violation
        over = self.monitor.over_threshold(cfg.envelope_pct)
        current = {(d, t) for d, t, _ in over}
        with self._lock:
            entered = current - self._violating
            self._violating = current
            self.stats.alerts += len(entered)
            self.stats.ingested += out["ingested"]
            self.stats.feedback += out["feedback"]
            self.stats.last_store_version = version
            self.stats.polls += 1
        out["alerts"] = [(d, t, m_) for d, t, m_ in over
                         if (d, t) in entered]
        return out

    def _track_graduated(self, m: _Managed, samples: list) -> int:
        """Keep scoring a graduated device: record the forest's prediction
        against every new measured sample, so ``calibration.mape`` keeps
        tracking the device AFTER it left the transfer tier (and a
        post-graduation drift shows up in the same gauge that drove
        graduation)."""
        st = m.predictor.stats_snapshot()
        n = 0
        for s in samples[m.tracked:]:
            t = s.targets.get(st.device, {})
            if st.target in t and m.engine is not None:
                x = np.asarray(s.features, dtype=np.float32)[None, :]
                pred = float(np.exp(m.engine.predict(x))[0])
                self.monitor.record(st.device, st.target, pred,
                                    float(t[st.target]), kernel=s.group)
                n += 1
        m.tracked = len(samples)
        return n

    def graduate(self, key: str) -> int:
        """Force-graduate one device now (the automatic path calls the
        same machinery when the plateau criterion fires); returns the new
        pool slot generation (0 when no pool slot is attached)."""
        with self._cycle_lock:
            with self._lock:
                m = self._devices[key]
            if m.stage != "transfer":
                raise ValueError(f"device {key!r} already graduated")
            return self._graduate(m, m.predictor.stats_snapshot())

    def _graduate(self, m: _Managed, st) -> int:
        # fit OFF every serving lock: the predictor keeps answering (and
        # observing) while the forest trains and the engine builds
        est = m.predictor.to_forest()
        engine = ForestEngine(est, self.config.engine_config
                              or EngineConfig())
        slot_gen = 0
        if self.pool is not None and m.replica is not None:
            # match the slot's output contract: to_forest is log-target,
            # the wrapper restores linear µs where the predictor served it
            serving = (engine if m.predictor.log_output
                       else GraduatedEngine(engine))
            slot_gen = self.pool.swap_engine(m.replica, serving)
        if self.multi_engine is not None and st.target == "time_us" \
                and st.device not in self.multi_engine.engines:
            # pricing matrix wants log-time engines when log_time=True
            self.multi_engine.add_device(
                st.device, engine if self.multi_engine.log_time
                else GraduatedEngine(engine))
        with self._lock:
            m.stage = "forest"
            m.engine = engine
            m.graduated_at_n = st.n_observed
            m.tracked = st.ingested if st.ingested else len(
                self.store.raw()[0])
            self.stats.graduations += 1
        return slot_gen

    # --------------------------------------------------------- probe budget

    def plan_probes(self, X_pool: np.ndarray, budget: int, *,
                    policy: str | None = None) -> list[tuple[str, int]]:
        """Allocate the fleet's next ``budget`` measurements across the
        managed, still-uncalibrated (transfer-stage) devices.

        Returns ``[(device_key, row_index_into_X_pool), ...]`` in
        measurement order. Within a device, probes follow its
        ``select_probes`` coverage prefix, continued at the device's
        observation count — the streaming-schedule property holds across
        planning calls. Across devices, the interleave is the policy:

        * ``"highest-mape"`` — each slot goes to the device whose live
          ``calibration.mape`` is worst, discounted by probes already
          planned for it (``mape / (1 + planned)``), so a fixed budget
          concentrates on the least-calibrated hardware without starving
          the rest; a series with no samples ranks worse than any
          measured one.
        * ``"coverage"`` — each slot goes to the device with the FEWEST
          total observations (live count + planned), spreading the budget
          evenly across the fleet before deepening anywhere.

        Deterministic and ``PYTHONHASHSEED``-independent: devices are
        ranked with sorted-key tie-breaks and ``select_probes`` is pure
        numpy — two hosts planning the same fleet state produce the SAME
        schedule (``tests/test_supervise.py`` proves it across
        interpreters).
        """
        policy = policy or self.config.probe_policy
        if policy not in PROBE_POLICIES:
            raise ValueError(f"unknown probe policy {policy!r} "
                             f"(have {PROBE_POLICIES})")
        X_pool = np.asarray(X_pool, dtype=np.float64)
        order = select_probes(X_pool, len(X_pool))
        with self._lock:
            managed = sorted(
                (m for m in self._devices.values() if m.stage == "transfer"),
                key=lambda m: m.key)
        if not managed or budget <= 0 or not len(order):
            return []
        seen: dict[str, int] = {}
        mapes: dict[str, float] = {}
        pos: dict[str, int] = {}
        for m in managed:
            st = m.predictor.stats_snapshot()
            seen[m.key] = st.n_observed
            live = self.monitor.mape(st.device, st.target)
            mapes[m.key] = float(live) if live is not None \
                else _UNMEASURED_MAPE
            pos[m.key] = min(st.n_observed, len(order))
        planned = {m.key: 0 for m in managed}
        plan: list[tuple[str, int]] = []
        for _ in range(int(budget)):
            open_keys = [k for k in planned if pos[k] < len(order)]
            if not open_keys:
                break                       # every device exhausted the pool
            if policy == "coverage":
                k = min(open_keys, key=lambda k: (seen[k] + planned[k], k))
            else:
                k = min(open_keys,
                        key=lambda k: (-mapes[k] / (1 + planned[k]), k))
            plan.append((k, int(order[pos[k]])))
            pos[k] += 1
            planned[k] += 1
        return plan

    # --------------------------------------------------------- observability

    def stats_snapshot(self) -> dict:
        """Atomic view: the loop counters plus per-device lifecycle state
        (stage, pool slot generation, graduation point). The generation
        bump of a graduation swap is visible here AND in
        ``pool.stats_snapshot().slot_swaps`` / ``slot_generations()``."""
        slot_gens = (self.pool.slot_generations()
                     if self.pool is not None else {})
        with self._lock:
            devices = {
                key: {"stage": m.stage,
                      "replica": m.replica,
                      "graduated_at_n": m.graduated_at_n,
                      "slot_generation": slot_gens.get(m.replica, 0)}
                for key, m in sorted(self._devices.items())}
            return {"stats": SupervisorStats(**self.stats.__dict__),
                    "devices": devices}

    def register_metrics(self, registry) -> None:
        """Expose the loop through an ``obs.MetricsRegistry``. Every
        ``register_fn`` PINS its kind: the cycle/ingest/graduation tallies
        are counters; store version, fleet size and envelope state are
        gauges (reset-prone or free to move down). The Prometheus TYPE
        lines are asserted by ``tests/test_supervise.py``."""
        for name in ("polls", "ingested", "feedback", "graduations",
                     "retargets", "alerts", "errors"):
            registry.register_fn(f"supervisor.{name}",
                                 lambda n=name: getattr(self.stats, n),
                                 kind="counter")
        registry.register_fn("supervisor.last_store_version",
                             lambda: self.stats.last_store_version,
                             kind="gauge")
        registry.register_fn("supervisor.devices",
                             lambda: len(self._devices), kind="gauge")
        registry.register_fn(
            "supervisor.graduated_devices",
            lambda: sum(1 for m in self._devices.values()
                        if m.stage == "forest"), kind="gauge")
        registry.register_fn(
            "supervisor.envelope_exceeded",
            lambda: len(self.monitor.over_threshold(
                self.config.envelope_pct)), kind="gauge")

    # ------------------------------------------------------------ background

    def start(self) -> "TransferSupervisor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="transfer-supervisor", daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.supervise_once()
            except Exception:
                # a bad cycle must never take supervision down: the tier
                # keeps serving its current stage and the next cycle
                # retries (stats.errors counts the failures)
                with self._lock:
                    self.stats.errors += 1
            self._wake.wait(self.config.poll_s)
            self._wake.clear()

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        self._wake.set()
        if join and self._thread is not None:
            self._thread.join(timeout=30.0)

    def __enter__(self) -> "TransferSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


# ------------------------------------------------------------------ smoke

def cliff_rows(device, n: int, seed: int, *, cliff: float = 16.0,
                scale: float = 3.0):
    """(X, y) synthetic ground truth: feature rows whose roofline columns
    drive the simulator for ``device`` — with two behaviors the spec
    sheet knows nothing about: the silicon underdelivers ``scale``x
    across the board (the analytical refit learns this from a handful of
    probes), and kernels past an arithmetic-intensity threshold fall off
    a ``cliff`` (a fusion/cache effect only a per-device forest can
    learn — the regime where the transfer tier floors and graduation
    pays, see docs/portability.md)."""
    from ..core.features import FEATURE_NAMES, N_FEATURES
    from ..core.simulate import WorkloadSpec, simulate_time_median_us

    i = {name: j for j, name in enumerate(FEATURE_NAMES)}
    rng = np.random.default_rng(seed)
    X, y = [], []
    for _ in range(n):
        flops = 10 ** rng.uniform(9, 10)
        gvol = 10 ** rng.uniform(7, 8)
        work = 10 ** rng.uniform(4, 5)
        special = flops * rng.uniform(0, 0.05)
        spec = WorkloadSpec(flops=flops, hbm_bytes=gvol, collective_bytes=0.0,
                            special_ops=special, control_ops=0.0,
                            work_items=work)
        t, _cov = simulate_time_median_us(spec, device, rng)
        ai = flops / max(gvol, 1.0)
        if ai > 100.0:
            t *= cliff
        row = np.zeros(N_FEATURES)
        row[i["work_per_shard"]] = work
        row[i["num_shards"]] = 1.0
        row[i["total_instr"]] = flops + special
        row[i["arith_ops"]] = flops
        row[i["special_ops"]] = special
        row[i["global_mem_vol"]] = gvol
        row[i["arith_intensity"]] = ai
        X.append(row)
        y.append(scale * t)
    return np.stack(X), np.asarray(y)


def smoke(device: str = "cuda") -> int:
    """Day-zero device -> measured feedback -> auto-graduation, end to
    end, asserting every link (the blocking CI step).

    The scenario is the one graduation exists for: a conservative
    transfer config (heavy shrinkage — trust the spec-sheet prior until
    the evidence is overwhelming) serving a device with an off-spec
    performance cliff. The hybrid's shrinkage floors its accuracy on
    cliff kernels; the live MAPE gauge plateaus; the supervisor notices,
    fits the full per-device forest and swaps it in mid-serve. Every
    quantity below is seeded, so the asserts are exact, not
    probabilistic.
    """
    from ..cluster.frontend import ClusterFrontend
    from ..cluster.replicas import ReplicaPool
    from ..core.dataset import DatasetStore, Sample
    from ..core.devices import TPU_V5E
    from ..core.metrics import mape
    from ..core.transfer import TransferConfig
    from ..obs.calibration import CalibrationMonitor
    from ..obs.registry import MetricsRegistry
    from .backend import build_transfer_engine

    dev = "day-zero-accelerator"
    Xp, yp = cliff_rows(TPU_V5E, 160, seed=1)      # probe stream
    Xev, yev = cliff_rows(TPU_V5E, 48, seed=2)     # held-out eval set

    reg = MetricsRegistry()
    mon = CalibrationMonitor(reg, alpha=0.3)
    tcfg = TransferConfig(min_samples_leaf=4, shrinkage=32.0)
    tp = build_transfer_engine(dev, monitor=mon, config=tcfg)  # generic prior
    store = DatasetStore()
    pool = ReplicaPool({"cold": tp}, check_interval_s=60.0)
    sup = TransferSupervisor(
        store, mon, pool=pool, registry=reg,
        config=SupervisorConfig(
            min_graduate_samples=96, plateau_window=3,
            engine_config=EngineConfig(
                backend="tree-walk" if device == "cpu" else None,
                cache_size=0, device=device)))
    sup.manage(tp, replica="cold", key=dev)

    with ClusterFrontend(pool, max_queue=64) as fe:
        day0 = fe.predict(Xev[:4])
        assert np.isfinite(day0).all() and (day0 > 0).all(), day0
        m_day0 = mape(yev, fe.predict(Xev))

        m_plateau = m_day0              # last eval MAPE while still transfer
        order = select_probes(Xp, len(Xp))
        for chunk_start in range(0, len(order), 8):
            if sup.stats_snapshot()["devices"][dev]["stage"] == "transfer":
                m_plateau = mape(yev, fe.predict(Xev))
            for j in order[chunk_start:chunk_start + 8]:
                store.extend([Sample(
                    app="smoke", kernel=f"k{j}", variant="s",
                    features=Xp[j],
                    targets={dev: {"time_us": float(yp[j])}})])
            sup.supervise_once()
            served = fe.predict(Xev[:2])
            assert np.isfinite(served).all(), served

        snap = sup.stats_snapshot()
        st = snap["devices"][dev]
        assert st["stage"] == "forest", snap
        assert st["slot_generation"] == 1, snap
        assert pool.stats_snapshot().slot_swaps == 1
        assert snap["stats"].feedback > 0, snap      # post-grad. scoring ran
        m_final = mape(yev, fe.predict(Xev))
        live = mon.mape(dev, "time_us")
        assert live is not None and np.isfinite(live)
        assert m_final < m_day0, (m_day0, m_final)
        # graduation must not give back what the transfer tier earned: the
        # forest serves within the plateau it replaced (small slack for the
        # eval-set estimate's granularity)
        assert m_final <= 1.10 * m_plateau, (m_plateau, m_final)
        print(f"supervisor smoke OK: day-zero MAPE {m_day0:.1f}% -> "
              f"plateau {m_plateau:.1f}% -> graduated {m_final:.1f}% after "
              f"{st['graduated_at_n']} measured samples "
              f"(slot generation {st['slot_generation']}, "
              f"{snap['stats'].feedback} post-graduation feedback samples, "
              f"live gauge {live:.1f}%, {snap['stats'].alerts} envelope "
              f"alerts)")
    return 0


if __name__ == "__main__":
    import argparse
    import sys
    ap = argparse.ArgumentParser(description=smoke.__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the graduated forest is served: 'cuda' (the "
                         "forest kernel on the card) or 'cpu'")
    sys.exit(smoke(ap.parse_args().device))
