"""Hardware-independent feature extraction from a ``torch.export`` graph
(paper §3.1/§3.2, Table 6): the port of ``repro.core.features``.

The paper instruments PTX and counts, per thread, how often each
instruction executes, grouped into {arithmetic, special, logic, control,
sync}, with the memory volumes {global, shared, param}, the launch
configuration and two derived features: 12 features. The reference reads
them from StableHLO; this module reads them from the core ATen graph of
``torch.export`` (``ExportedProgram.run_decompositions()``, with softmax,
log-softmax and gelu split further by torch's own decompositions, as
StableHLO splits them). Export traces on fake tensors, so extraction never
runs the function. The outputs are the reference's: the 12
``FEATURE_NAMES`` in paper Table 6 order, the same ``aux`` keys, the same
``LaunchConfig`` and the same ``OpTally`` arithmetic (parameters counted
once; arguments of at most 256 bytes count as parameter memory).

Each op is weighted by the scalar lane-executions it performs, as in the
reference: elementwise ops by their result's elements, ``mm``/``bmm`` by
``_dot_flops``, ``convolution`` by ``_conv_flops``, a reduction by its
operand's elements. Op names map onto the reference's groups:

=================  ==========================================================
group              core ATen ops (the reference's StableHLO ops)
=================  ==========================================================
special            exp, expm1, log, log1p, sigmoid, tanh, tan, sin, cos,
                   atan2, rsqrt, sqrt, erf, erfinv, pow with a non-integer
                   exponent (exponential, log, logistic, tanh, sine, power,
                   erf, ...)
logic              eq/ne/lt/le/gt/ge, where, masked_fill, bitwise and/or/xor/
                   not, logical ops, shifts, sign, isnan/isinf/isfinite
                   (compare, select, and, or, xor, shift_*, ...)
control            a ``scan`` node adds ``1 + trip`` (the ``while`` and its
                   branches) and multiplies its body's counts by ``trip``;
                   sort; cond/while_loop (while, sort, call, ...)
sync               ``_c10d_functional`` collectives (all_reduce, ...)
memory move        view, reshape, expand, permute, squeeze/unsqueeze, cat,
                   slice, select, index, index_select, index_put, gather,
                   scatter(_add), flip, constant_pad_nd, clone, full,
                   zeros (reshape, broadcast_in_dim, transpose, concatenate,
                   slice, gather/scatter, reverse, pad, copy); weighed by
                   the result's elements, their bytes added to global memory
arithmetic         everything else; mm/bmm/convolution add their operands'
                   and result's bytes to global memory
=================  ==========================================================

Ops that the decomposition leaves whole count as the reference counts what
it lowers to:

==========================  =================================================
core ATen op                counted as (the reference's lowering)
==========================  =================================================
linalg_qr                   2 control (LAPACK geqrf and orgqr: the reference
                            reads each ``custom_call`` as a call), 2 logic
                            per result element (its triangle's mask)
linalg_cholesky_ex          1 control (potrf), 3 logic per element
linalg_solve_triangular     1 control (trsm)
linalg_lu_factor_ex         2 control (getrf) and 2 per row (the loop that
                            turns pivots into a permutation, a call a trip),
                            1 logic per element
linalg_lu_solve             3 control and 2 per row (two trsm, the loop)
_linalg_solve_ex            4 control and 2 per row, 1 logic per element
_fft_r2c / _c2c / _c2r      arithmetic, result elements (fft)
sort                        1 control, 9 logic (the comparator's scalars)
topk                        arithmetic, elements of the indices (top_k)
searchsorted                a loop of ceil(log2(n + 1)) trips (the binary
                            search): 1 + trip control, and per trip and
                            query 6 arithmetic, 13 logic and 10 memory moves
roll (kept whole)           1 control, two slices and a concat (a call of
                            ``_roll_static``)
==========================  =================================================

A ``scan`` node's trip count is its xs' dim 0 (``workloads.suite`` gives a
loop with only a trip count a ``(length, 0)`` tensor). Each trip also
counts the reference's loop bookkeeping: its counter's add and compare, a
``dynamic_slice`` and reshape of every xs and a ``dynamic_update_slice`` of
every stacked output (the whole buffer). An op that indexes with integers
counts the reference's negative-index wrap (compare, add, select and two
broadcast constants per index), and an elementwise operand of another
shape than the result the ``broadcast_in_dim`` the reference emits. A
scalar argument (``mul(x, 0.5)``) is a constant the reference materialises:
its bytes count once as parameter memory, as do the program's lifted
constants and a reduction's init value. The user inputs and the first
user output give ``io_bytes``: the reference reads an entry's results only
up to the first result's attributes.
"""
from __future__ import annotations

import contextlib
import functools
import math
import operator
import sys
from dataclasses import dataclass

import numpy as np
import torch

FEATURE_NAMES: list[str] = [
    "work_per_shard",      # paper: threads per CTA
    "num_shards",          # paper: CTAs
    "total_instr",
    "arith_ops",
    "special_ops",
    "logic_ops",
    "control_ops",
    "sync_ops",
    "global_mem_vol",
    "param_mem_vol",
    "shared_mem_vol",
    "arith_intensity",
]

N_FEATURES = len(FEATURE_NAMES)

# ------------------------------------------------------------- op grouping
SPECIAL_OPS = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sigmoid",
    "tanh", "tan", "sin", "cos", "asin", "acos", "atan", "atan2", "sinh",
    "cosh", "asinh", "acosh", "atanh", "rsqrt", "sqrt", "pow", "erf",
    "erfc", "erfinv",
}
LOGIC_OPS = {
    "eq", "ne", "lt", "le", "gt", "ge", "where", "masked_fill",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "logical_and", "logical_or", "logical_xor", "logical_not",
    "__and__", "__or__", "__xor__", "__lshift__", "__rshift__",
    "bitwise_left_shift", "bitwise_right_shift", "sign", "isnan", "isinf",
    "isfinite",
}
SYNC_OPS = {
    "all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
    "all_to_all_single", "broadcast",
}
MEM_MOVE_OPS = {
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "squeeze", "unsqueeze", "cat", "slice", "slice_scatter", "select",
    "select_scatter", "index", "index_select", "index_put", "gather",
    "scatter", "scatter_add", "scatter_reduce", "flip", "constant_pad_nd", "clone", "copy", "alias", "as_strided", "full",
    "full_like", "zeros", "zeros_like", "ones", "ones_like", "scalar_tensor",
    "split", "split_with_sizes", "unbind", "embedding", "lift_fresh_copy",
    "diagonal",
}
DOT_OPS = {"mm", "bmm", "mv", "dot"}
DOT_ADD_OPS = {"addmm", "baddbmm", "addmv"}      # (bias, lhs, rhs)
REDUCE_OPS = {
    "sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin",
    "any", "all", "var", "std", "var_mean", "logsumexp",
    "linalg_vector_norm", "cumsum", "cumprod", "cummax", "cummin",
}
# LAPACK calls (see the module docstring): (control ops, control ops per
# row of the input, logic ops per result element)
LAPACK_OPS = {
    "linalg_qr": (2, 0, 2), "linalg_cholesky_ex": (1, 0, 3),
    "linalg_cholesky": (1, 0, 3), "linalg_solve_triangular": (1, 0, 0),
    "triangular_solve": (1, 0, 0), "linalg_lu_factor_ex": (2, 2, 1),
    "linalg_lu_factor": (2, 2, 1), "linalg_lu_solve": (3, 2, 0),
    "_linalg_solve_ex": (4, 2, 1), "linalg_solve": (4, 2, 1),
}
FFT_OPS = {"_fft_r2c", "_fft_c2c", "_fft_c2r"}
CONTROL_OPS = {"sort"}
# ops that index with integers (the reference wraps negative indices), and
# the position of their index argument
INDEXING_OPS = {"index": 1, "index_put": 1, "index_select": 2, "gather": 2,
                "scatter": 2, "scatter_add": 2, "scatter_reduce": 2,
                "embedding": 1}
# no work: bookkeeping nodes and effect tokens
SKIP_OPS = {
    "getitem", "_assert_tensor_metadata", "_assert_scalar",
    "_assert_async", "sym_size", "sym_constrain_range",
    "sym_constrain_range_for_size", "with_effects", "empty",
    "empty_strided", "empty_like", "detach", "_linalg_check_errors",
    "wait_tensor",
}
# the reference's binary search, per trip and query element
_SEARCH_WEIGHTS = {"arith": 6.0, "logic": 13.0, "mem_move": 10.0}


@dataclass
class LaunchConfig:
    """The kernel-launch-configuration analogue (paper §3.1): chosen by the
    caller, independent of hardware."""
    work_items: float = 1.0        # total parallel work items (tokens, rows..)
    n_shards: int = 1              # mesh size the program is launched on
    shared_mem_bytes: float = 0.0  # on-chip block bytes for kernel workloads


@dataclass
class OpTally:
    arith: float = 0.0
    special: float = 0.0
    logic: float = 0.0
    control: float = 0.0
    sync: float = 0.0
    mem_move: float = 0.0
    global_vol: float = 0.0
    param_vol: float = 0.0
    collective_bytes: float = 0.0
    flops: float = 0.0              # dot/conv MAC flops only (aux)

    def add(self, other: "OpTally", mult: float = 1.0) -> None:
        self.arith += mult * other.arith
        self.special += mult * other.special
        self.logic += mult * other.logic
        self.control += mult * other.control
        self.sync += mult * other.sync
        self.mem_move += mult * other.mem_move
        self.global_vol += mult * other.global_vol
        self.param_vol += other.param_vol          # params counted once
        self.collective_bytes += mult * other.collective_bytes
        self.flops += mult * other.flops

    @property
    def total(self) -> float:
        return (self.arith + self.special + self.logic + self.control
                + self.sync + self.mem_move)


@dataclass
class FeatureVector:
    values: np.ndarray                # (N_FEATURES,) float64, paper Table 6 order
    aux: dict                         # exact counts for the simulator/roofline

    def __getitem__(self, name: str) -> float:
        return float(self.values[FEATURE_NAMES.index(name)])

    def as_dict(self) -> dict[str, float]:
        return {n: float(v) for n, v in zip(FEATURE_NAMES, self.values)}


# ------------------------------------------------------------------ shapes

def _tensors(val) -> list:
    """The tensors of a node's ``meta["val"]`` (one, or a tuple of them)."""
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors(v)]
    return []


def _elems(t) -> int:
    return int(math.prod(t.shape))


def _bytes(t) -> int:
    return _elems(t) * t.element_size()


def _val(arg):
    return arg.meta.get("val") if isinstance(arg, torch.fx.Node) else None


def _dot_flops(lhs, result) -> float:
    """2 * prod(result) * prod(lhs contracting dims): every dot op that
    survives decomposition contracts lhs's last dim."""
    return 2.0 * _elems(result) * (lhs.shape[-1] if lhs.dim() else 1)


def _conv_flops(weight, result) -> float:
    """2 * out_elems * (kernel_elems / out_features); the weight is
    (O, I/groups, *kernel)."""
    return 2.0 * _elems(result) * (_elems(weight) / max(weight.shape[0], 1))


def _op_name(target) -> str:
    if target is operator.getitem:
        return "getitem"
    name = getattr(target, "_opname", None) or getattr(target, "__name__", "")
    return name.split(".")[0]


# schema types of an op's operands: a Python number in one of these slots
# is a constant the reference materialises (and broadcasts)
_OPERAND_TYPES = {"Tensor", "Optional[Tensor]", "number", "Optional[number]",
                  "Scalar", "Optional[Scalar]"}


def _operands(node) -> list:
    """``node``'s operands: the tensors (their ``meta["val"]``) and Python
    numbers in its schema's tensor and scalar slots, in order."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return []
    out = []
    for i, a in enumerate(schema.arguments):
        if i < len(node.args):
            v = node.args[i]
        elif a.name in node.kwargs:
            v = node.kwargs[a.name]
        else:
            continue
        if str(a.type) not in _OPERAND_TYPES:
            continue
        if isinstance(v, torch.fx.Node):
            v = _val(v)
        if isinstance(v, torch.Tensor) or (
                isinstance(v, (int, float)) and not isinstance(v, bool)):
            out.append(v)
    return out


# ------------------------------------------------------------------ walker

def _walk(gm: torch.fx.GraphModule) -> OpTally:
    """One graph's tally, each scan body walked recursively and multiplied
    by its trip count."""
    tally = OpTally()
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        if node.target is torch.ops.higher_order.scan:
            _scan(gm, node, tally)
            continue
        name = _op_name(node.target)
        if name in SKIP_OPS:
            continue
        if isinstance(node.target, torch._ops.HigherOrderOperator):
            tally.control += 1.0                    # cond, while_loop, ...
            continue
        _op(node, name, tally)
    return tally


def _scan(gm, node, tally: OpTally) -> None:
    body_ref, init, xs = node.args[0], node.args[1], node.args[2]
    xs_vals = [_val(x) for x in xs]
    trip = float(xs_vals[0].shape[0]) if xs_vals else 1.0
    tally.control += 1.0 + trip                     # loop + branches
    body = _walk(getattr(gm, body_ref.target))
    # each trip slices every xs (dynamic_slice and reshape) and writes each
    # output into its stacked buffer (a dynamic_update_slice, whose result
    # is the whole buffer)
    for t in xs_vals:
        if t.shape[0]:
            body.mem_move += 2.0 * _elems(t) / t.shape[0]
            body.global_vol += 2.0 * _bytes(t) / t.shape[0]
    for t in _tensors(node.meta.get("val"))[len(init):]:
        body.mem_move += _elems(t)
        body.global_vol += _bytes(t)
    body.arith += 1.0                # the induction variable's increment
    body.logic += 1.0                # and the compare of the loop's cond
    body.param_vol += 12.0           # its start, bound and step (int32)
    tally.add(body, trip)


def _op(node, name: str, tally: OpTally) -> None:
    res = _tensors(node.meta.get("val"))
    if not res:
        return
    result = res[-1]
    args = [_val(a) for a in node.args]
    operands = _operands(node)
    tally.param_vol += sum(result.element_size() for v in operands
                           if not isinstance(v, torch.Tensor))
    if name in INDEXING_OPS:
        idx = node.args[INDEXING_OPS[name]]
        n = float(sum(_elems(_val(i)) for i in (
            idx if isinstance(idx, (list, tuple)) else [idx]) if i is not None))
        tally.logic += 2.0 * n
        tally.arith += n
        tally.flops += n
        tally.mem_move += 2.0 * n
    if name in DOT_OPS or name in DOT_ADD_OPS:
        lhs, rhs = (args[1], args[2]) if name in DOT_ADD_OPS else args[:2]
        fl = _dot_flops(lhs, result)
        tally.arith += fl
        tally.flops += fl
        tally.global_vol += _bytes(lhs) + _bytes(rhs) + _bytes(result)
    elif name == "convolution":
        fl = _conv_flops(args[1], result)
        tally.arith += fl
        tally.flops += fl
        tally.global_vol += _bytes(args[0]) + _bytes(args[1]) + _bytes(result)
    elif name in REDUCE_OPS:
        cnt = float(_elems(args[0]))
        tally.arith += cnt
        tally.flops += cnt
        tally.param_vol += args[0].element_size()   # the init value
    elif name in LAPACK_OPS:
        calls, per_row, logic = LAPACK_OPS[name]
        tally.control += calls + per_row * args[0].shape[-2]
        tally.logic += logic * _elems(res[0])
    elif name in FFT_OPS:
        tally.arith += _elems(result)
        tally.flops += _elems(result)
    elif name == "searchsorted":
        trip = float(math.ceil(math.log2(args[0].shape[-1] + 1)))
        q = float(_elems(result))
        tally.control += 1.0 + trip
        tally.arith += trip * q * _SEARCH_WEIGHTS["arith"]
        tally.flops += trip * q * _SEARCH_WEIGHTS["arith"]
        tally.logic += trip * q * _SEARCH_WEIGHTS["logic"]
        tally.mem_move += trip * q * _SEARCH_WEIGHTS["mem_move"]
        tally.global_vol += 4.0 * trip * q * _SEARCH_WEIGHTS["mem_move"]
    elif name == "roll":
        # the reference's _roll_static: a call of two slices and a concat
        tally.control += 1.0
        tally.mem_move += 2.0 * _elems(result)
        tally.global_vol += 2.0 * _bytes(result)
    elif name in SYNC_OPS:
        tally.sync += 1.0
        tally.collective_bytes += _bytes(result)
    elif name in MEM_MOVE_OPS:
        tally.mem_move += _elems(result)
        tally.global_vol += _bytes(result)
    elif name in CONTROL_OPS:
        tally.control += 1.0
        tally.logic += 9.0           # the comparator's scalar compares/selects
    else:
        _elementwise(node, name, result, operands, tally)


def _elementwise(node, name, result, operands, tally: OpTally) -> None:
    """An elementwise op, weighed by its result's elements, and a
    ``broadcast_in_dim`` for each operand of another shape, as the
    reference's lowering has it."""
    n = float(_elems(result))
    for v in operands:
        if not isinstance(v, torch.Tensor) or tuple(v.shape) != tuple(
                result.shape):
            size = (v.element_size() if isinstance(v, torch.Tensor)
                    else result.element_size())
            tally.mem_move += n
            tally.global_vol += n * size
    if name == "pow" and _integer_exponent(node):
        tally.arith += n                            # integer_pow: multiplies
        tally.flops += n
    elif name in SPECIAL_OPS:
        tally.special += n
    elif name in LOGIC_OPS:
        tally.logic += n
    else:
        tally.arith += n
        tally.flops += n


def _integer_exponent(node) -> bool:
    e = node.args[1] if len(node.args) > 1 else None
    return isinstance(e, (int, float)) and float(e).is_integer()


# ------------------------------------------------------------- entry points

def _decompositions():
    """The core ATen table, with softmax, log-softmax and gelu split into
    their primitive ops as StableHLO has them."""
    from torch._decomp import decomposition_table
    aten = torch.ops.aten
    table = torch.export.default_decompositions()
    for op in (aten._softmax.default, aten._log_softmax.default,
               aten.gelu.default):
        table[op] = decomposition_table[op]
    table.pop(aten.roll.default, None)      # counted whole, as _roll_static
    return table


@functools.cache
def _cia_ops() -> frozenset:
    from torch._export.utils import _collect_all_valid_cia_ops
    return frozenset(_collect_all_valid_cia_ops())


@contextlib.contextmanager
def _cia_ops_collected_once():
    """``run_decompositions`` collects the composite-implicit ops of every
    operator namespace anew on each call, which is most of its cost; the set
    is the same for every program of a process, so collect it once."""
    mods = [m for m in (sys.modules.get("torch.export.exported_program"),
                        sys.modules.get("torch.export.decomp_utils"))
            if hasattr(m, "_collect_all_valid_cia_ops")]
    saved = [m._collect_all_valid_cia_ops for m in mods]
    for m in mods:
        m._collect_all_valid_cia_ops = lambda: set(_cia_ops())
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m._collect_all_valid_cia_ops = f


def extract_from_program(ep, launch: LaunchConfig | None = None
                         ) -> FeatureVector:
    """Features of an ``ExportedProgram``: its core ATen graph walked once."""
    launch = launch or LaunchConfig()
    with _cia_ops_collected_once():
        ep = ep.run_decompositions(_decompositions())
    t = _walk(ep.graph_module)

    nodes = {n.name: n for n in ep.graph.nodes}
    args_bytes = small_args = res_bytes = 0.0
    for spec in ep.graph_signature.input_specs:
        v = _val(nodes[spec.arg.name])
        if not isinstance(v, torch.Tensor):
            continue                                # effect tokens
        if spec.kind.name == "USER_INPUT":
            args_bytes += _bytes(v)
            if _bytes(v) <= 256:
                small_args += _bytes(v)
        elif spec.kind.name in ("PARAMETER", "BUFFER", "CONSTANT_TENSOR"):
            t.param_vol += _bytes(v)
    # the first result only: the reference reads the results from its entry
    # signature up to the first result's attribute dict, so it counts one
    # result of a function that returns several
    user_outputs = [spec.arg.name for spec in ep.graph_signature.output_specs
                    if spec.kind.name == "USER_OUTPUT"]
    if user_outputs:
        res_bytes = float(_bytes(_val(nodes[user_outputs[0]])))

    global_vol = args_bytes + res_bytes + t.global_vol
    param_vol = small_args + t.param_vol
    arith = t.arith
    intensity = arith / max(global_vol, 1.0)

    values = np.array([
        launch.work_items / max(launch.n_shards, 1),
        float(launch.n_shards),
        t.total,
        arith,
        t.special,
        t.logic,
        t.control,
        t.sync,
        global_vol,
        param_vol,
        launch.shared_mem_bytes,
        intensity,
    ], dtype=np.float64)

    aux = dict(
        flops=t.flops,
        hbm_bytes=args_bytes + res_bytes + t.global_vol,
        io_bytes=args_bytes + res_bytes,
        collective_bytes=t.collective_bytes,
        special_ops=t.special,
        control_ops=t.control,
        mem_move=t.mem_move,
        work_items=launch.work_items,
        n_shards=launch.n_shards,
    )
    return FeatureVector(values=values, aux=aux)


class _Program(torch.nn.Module):
    """``fn`` as a module, for ``torch.export``."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def extract(fn, *args, launch: LaunchConfig | None = None) -> FeatureVector:
    """Export ``fn`` on ``args`` and extract its features. Export traces on
    fake tensors: ``fn`` never runs (paper: 'minimal overhead')."""
    ep = torch.export.export(_Program(fn), tuple(args))
    return extract_from_program(ep, launch)
