"""The cost counter for the roofline terms (the port of
``repro.core.hlo_analysis``).

The reference parses the compiled HLO of one SPMD participant and weights
each while body by its trip count. A DTensor program has no compiled
per-rank module, so the counterpart here runs the program once, eagerly,
under a ``TorchDispatchMode`` (``CostCounter``), on meta arguments (no
storage, no numbers) or on real ones, on the caller's mesh, and counts what
ONE RANK executes:

  * ``flops``            2·M·N·K for matmuls and convolutions (and the
                         attention ops torch has a formula for), from
                         ``torch.utils.flop_counter``'s formulas; plus one
                         per output element of every elementwise op and
                         reduction, as the reference counts a fusion;
  * ``transcendentals``  the output elements of exp, tanh, sigmoid, rsqrt,
                         log, erf, pow and the ops built on them (softmax,
                         SiLU, GELU, log-sigmoid);
  * ``hbm_bytes``        every op's result bytes (eager mode writes every
                         result) except views and metadata ops (the
                         reference's ``_NO_TRAFFIC_OPS``), plus the
                         program's inputs read once, as the reference reads
                         the entry parameters; an in-place write into a
                         slice counts the slice, so ``hbm_bytes_once``
                         stays 0;
  * ``collective_bytes`` the collectives DTensor's redistributions issue
                         (``_c10d_functional``, and ``c10d`` process-group
                         calls), by op, with the reference's accounting
                         (``_collective_bytes``) and the group size read
                         from the op's group:
        all-gather:         result_bytes × (g-1)/g
        all-reduce:         2 × operand_bytes × (g-1)/g
        reduce-scatter:     operand_bytes × (g-1)/g
        all-to-all:         operand_bytes × (g-1)/g
        collective-permute: operand_bytes (a point-to-point send)
        broadcast:          operand_bytes × (g-1)/g (XLA has none)
    The counts equal ``CommDebugMode``'s on the same run, which counts the
    same ops (it counts no point-to-point send).

What cannot mean the same thing in torch:
  * **Local ops only.** An op on DTensors is the global-shape wrapper of
    the local ops that DTensor then runs; counting it as well would mix
    global and local counts (``FlopCounterMode`` counts the wrapper, the
    library count ``xla_cost_analysis`` returns). The counter lets DTensor
    run such an op (``NotImplemented``) and counts the local ops it runs,
    inside and outside ``local_map``; the fake tensors of DTensor's
    sharding propagation are not counted either.
  * **Eager bytes, not post-fusion bytes.** Every intermediate an eager
    program materialises is counted, where XLA's fusions keep many on
    chip.
  * **No** ``while_trips``: an eager run has no loop to weight, every
    layer is seen (it stays empty).
  * **No bf16 halving** (the reference's ``logical_bf16``, an XLA:CPU
    artefact): torch moves the dtype it holds.
  * **Activation checkpointing**: the recomputed forward runs again in the
    backward pass and is counted again, as XLA's remat is.
  * **The hand-written kernels** launch outside the dispatcher, so a
    launch on a CUDA tensor (seen through ``kernels.watch``) counts the
    FLOPs of its plain version on the same shapes, and its inputs and
    output once.
  * **Peak memory**: a live-bytes tally of the storages the program holds
    (its inputs, and every storage an op makes until it is freed), the
    counterpart of ``memory_analysis``.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

# the op namespaces of collectives (CommDebugMode's)
_COMM_NAMESPACES = {"_c10d_functional", "c10d_functional",
                    "_c10d_functional_autograd", "_dtensor", "c10d"}
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}

# ops whose result moves no bytes (the counterpart of the reference's
# _NO_TRAFFIC_OPS): besides every view op, allocations and aliases
_NO_TRAFFIC_OPS = {"detach", "alias", "lift_fresh", "_unsafe_view", "empty",
                   "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd",
                   "set_", "resize_", "_local_scalar_dense"}

# reductions count one FLOP per output element, as a reduce fusion does
_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
               "std", "var_mean", "std_mean", "logsumexp", "norm",
               "linalg_vector_norm", "cumsum", "cumprod", "argmax", "argmin",
               "any", "all", "_softmax", "_log_softmax",
               "_softmax_backward_data", "_log_softmax_backward_data"}

_TRANSCENDENTALS = {"exp", "exp_", "exp2", "expm1", "tanh", "tanh_",
                    "sigmoid", "sigmoid_", "rsqrt", "rsqrt_", "sqrt", "sqrt_",
                    "log", "log_", "log1p", "log2", "erf", "erf_", "pow",
                    "pow_", "sin", "cos", "_softmax", "_log_softmax",
                    "logsumexp", "silu", "silu_", "gelu", "log_sigmoid_forward"}


@dataclass
class HloCosts:
    """Per-rank costs, the reference's fields (see the module docstring for
    what each means here)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    hbm_bytes_once: float = 0.0   # always 0: an in-place slice write counts
                                  # the slice it writes
    collective_bytes: float = 0.0
    collective_counts: dict = field(default_factory=dict)     # op -> count
    collective_bytes_by_op: dict = field(default_factory=dict)
    transcendentals: float = 0.0
    while_trips: list[float] = field(default_factory=list)   # always empty

    def as_dict(self) -> dict:
        return dict(flops=self.flops, hbm_bytes=self.hbm_bytes,
                    collective_bytes=self.collective_bytes,
                    collective_counts=dict(self.collective_counts),
                    collective_bytes_by_op=dict(self.collective_bytes_by_op),
                    transcendentals=self.transcendentals,
                    while_trips=list(self.while_trips))


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _local(t):
    """A DTensor's local shard; a plain tensor itself."""
    return getattr(t, "_local_tensor", t)


def _is_fake(tree) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor

    return any(isinstance(t, FakeTensor) for t in _tensors(tree))


def _group_size(args, kwargs, default: int) -> int:
    """The size of a collective's group: its ``group_name`` (functional
    collectives) or its ProcessGroup (``c10d`` ops); else ``default``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, dist.ProcessGroup):
            return max(a.size(), 1)
        if isinstance(a, str):
            try:
                return max(_resolve_process_group(a).size(), 1)
            except (KeyError, RuntimeError, ValueError):
                continue
    return default


def _collective_bytes(op: str, in_bytes: float, out_bytes: float,
                      g: int) -> float:
    """The reference's per-op accounting (``_collective_bytes``)."""
    frac = (g - 1) / g if g > 1 else 0.0
    if op == "all-gather":
        return out_bytes * frac
    if op == "all-reduce":
        return 2.0 * in_bytes * frac
    if op == "collective-permute":
        return in_bytes
    return in_bytes * frac            # reduce-scatter, all-to-all, broadcast


def _plain_versions() -> dict:
    """Each kernel wrapper's plain version, called on the wrapper's
    ``watch`` inputs."""
    from ..kernels.attention.ref import attention_ref
    from ..kernels.mamba.ref import ssd_chunked

    return {
        "flash_attention": lambda a: attention_ref(
            a["q"], a["k"], a["v"], causal=a["causal"],
            sm_scale=a["sm_scale"]),
        "ssd_scan": lambda a: ssd_chunked(a["x"], a["alog"], a["B"], a["C"],
                                          h0=a["h0"], chunk=a["chunk"]),
    }


class CostCounter(TorchDispatchMode):
    """Counts what one rank executes (the module docstring says what);
    ``costs`` holds the counts, ``live_bytes`` and ``peak_bytes`` the
    tally of live storages. ``track`` enters tensors made before the run
    (its inputs) into the tally."""

    def __init__(self, n_devices: int = 1):
        super().__init__()
        self.n_devices = n_devices
        self.costs = HloCosts()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}            # storage key -> (bytes, weakref)
        self._kernel_flops_only = False
        self._closed = False

    # ------------------------------------------------------ live storages
    def track(self, tensors) -> None:
        for t in _tensors(tensors):
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.ref(st, self._freed(key)))
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key):
        def cb(_):
            if self._closed:
                return
            n, _ref = self._live.pop(key, (0, None))
            self.live_bytes -= n
        return cb

    def storage_bytes(self, tensors, exclude: set = frozenset()) -> int:
        """Bytes of the distinct storages of ``tensors`` not in
        ``exclude`` (storage keys)."""
        seen, n = set(exclude), 0
        for t in _tensors(tensors):
            st = _local(t).untyped_storage()
            if st._cdata not in seen:
                seen.add(st._cdata)
                n += st.nbytes()
        return n

    def close(self) -> None:
        """Stop the tally (storages freed later change nothing)."""
        self._closed = True
        self._live.clear()

    # ------------------------------------------------------------ counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # DTensor runs (and we count) the
                                        # local ops
        out = func(*args, **kwargs)
        if isinstance(func, torch._ops.OpOverload) and not _is_fake(out) \
                and not _is_fake(args):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        c = self.costs
        name = func._opname
        results = _tensors(out)
        packet = func._overloadpacket
        if func.namespace in _COMM_NAMESPACES and name in _COLLECTIVES:
            op = _COLLECTIVES[name]
            g = _group_size(args, kwargs, self.n_devices)
            b = _collective_bytes(op, sum(map(_nbytes, _tensors(args))),
                                  sum(map(_nbytes, results)), g)
            c.collective_bytes += b
            c.collective_counts[op] = c.collective_counts.get(op, 0) + 1
            c.collective_bytes_by_op[op] = (c.collective_bytes_by_op.get(op, 0)
                                            + b)
        elif packet in flop_registry:
            c.flops += float(flop_registry[packet](*args, **kwargs,
                                                   out_val=out))
        elif results and (torch.Tag.pointwise in func.tags
                          or name in _REDUCTIONS):
            c.flops += float(results[0].numel())
        if name in _TRANSCENDENTALS and results:
            c.transcendentals += float(results[0].numel())
        if self._kernel_flops_only:
            return
        if not (func.is_view or name in _NO_TRAFFIC_OPS):
            c.hbm_bytes += float(sum(map(_nbytes, results)))
        self.track(results)

    def kernel_call(self, name: str, inputs: dict, output) -> None:
        """``kernels.watch`` hook: a kernel launched on a CUDA tensor ran
        outside the dispatcher, so count its plain version's FLOPs on meta
        tensors of the same shapes, and its inputs and output once."""
        tensors = [t for t in inputs.values() if isinstance(t, torch.Tensor)]
        if not tensors or tensors[0].device.type != "cuda":
            return None                 # the plain version ran: counted
        meta = {k: (torch.empty_like(v, device="meta")
                    if isinstance(v, torch.Tensor) else v)
                for k, v in inputs.items()}
        self._kernel_flops_only = True
        try:
            _plain_versions()[name](meta)
        finally:
            self._kernel_flops_only = False
        self.costs.hbm_bytes += float(sum(map(_nbytes, tensors))
                                      + sum(map(_nbytes, _tensors(output))))
        return None


@dataclass
class CountedRun:
    """One counted run of a program: the per-rank ``costs``; the live-bytes
    tally's ``peak_bytes``, ``arg_bytes`` (the inputs' storages) and
    ``out_bytes`` (the output's storages that are not the inputs');
    ``library_flops``, ``FlopCounterMode``'s total on the same run;
    ``seconds`` of the run; and the program's ``output``."""
    costs: HloCosts
    peak_bytes: int
    arg_bytes: int
    out_bytes: int
    library_flops: float
    seconds: float
    output: object = None


def count_program(fn, *args, n_devices: int = 1, **kwargs) -> CountedRun:
    """Run ``fn(*args, **kwargs)`` once under the counter (and under
    ``FlopCounterMode`` for the library's own count), on whatever mesh its
    arguments live on; ``n_devices`` is the group size of a collective
    whose group cannot be read."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels import watch

    counter = CostCounter(n_devices)
    counter.track((args, kwargs))
    arg_keys = set(counter._live)
    arg_bytes = counter.live_bytes
    library = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    try:
        with library, counter, watch.watching(counter.kernel_call):
            out = fn(*args, **kwargs)
        seconds = time.perf_counter() - t0
        costs = counter.costs
        costs.hbm_bytes += arg_bytes                 # the inputs, read once
        out_bytes = counter.storage_bytes(out, exclude=arg_keys)
        peak = counter.peak_bytes
    finally:
        counter.close()
    return CountedRun(costs=costs, peak_bytes=peak, arg_bytes=arg_bytes,
                      out_bytes=out_bytes,
                      library_flops=float(library.get_total_flops()),
                      seconds=seconds, output=out)


def analyze_program(fn, *args, n_devices: int = 1, **kwargs) -> HloCosts:
    """Per-rank costs of one run of ``fn`` (the counterpart of
    ``analyze_hlo_text`` / ``analyze_compiled``)."""
    return count_program(fn, *args, n_devices=n_devices, **kwargs).costs


def xla_cost_analysis(run: CountedRun) -> dict:
    """The library's own count of a counted run, as the reference's
    ``xla_cost_analysis`` returns XLA's: ``FlopCounterMode``'s total (the
    DTensor-level ops included), beside which the report shows the
    counter's correction."""
    return {"flops": run.library_flops}
