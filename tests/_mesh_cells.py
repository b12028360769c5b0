"""Every arch's ``train_4k`` cell (``repro_torch.launch.cells.cell_fns``) at
full width on a fake process group: the helpers of
tests/test_torch_mesh_cells.py and tests/test_torch_mesh_cells_strategies.py.

A cell's arguments are meta-device tensors distributed by the cell's own
placements over a ("data", "model") DeviceMesh of a ``fake`` process group
(no rank runs, no numbers), and the step runs forward, backward and the
AdamW update inside ``activation_sharding``: what it proves is that every
op finds a sharding, at the widths the reduced configs cannot reach (they
pick head counts that divide 2). It does not hold numbers; the gloo worlds
do (tests/test_torch_mesh_train.py, tests/test_torch_mesh_families.py).

The serving cells (``prefill_32k``, ``decode_32k``, ``long_500k``) run
one prefill or decode step the same way (``run_serve_cell``). Before the
repair of faults F2-F4 every one of them failed but xlstm-125m's prefill:
the xLSTM refused a carried state on a mesh (F2), the attention's prefill
and decode mixed plain rotary tables and masks into DTensor ops (F3), and
a decode cell read its position from a meta tensor (F4).

Cuts, all of work, none of width:
  * depth: 2 layers; xlstm-125m one group of 4 (3 mLSTM + 1 sLSTM),
    zamba2-2.7b one shared-block period (6 Mamba2 layers, one shared
    attention), whisper-medium 2 encoder + 2 decoder layers;
  * microbatches: at most 2 (each further one repeats the same ops);
  * xlstm-125m: 128 tokens a sequence instead of 4,096 (the batch stays
    256), and a prompt of 128 instead of 32,768 in ``prefill_32k``: its sLSTM steps through the sequence one position at a time, and
    meta tensors take some 170 us an op (a 4,096-step layer: about 20 s
    forward, 46 s backward); no placement depends on the length.

Before the repair of fault F1 (the projections flattening sharded heads),
these cells failed: smollm-360m under ``2d`` on (2, 2), (2, 16) and
(16, 16) and under ``zero3`` and ``sp`` on (2, 2); qwen2.5-14b,
mistral-large-123b, qwen1.5-110b and granite-moe-3b-a800m under ``2d`` on
(2, 16) and (16, 16) ("Cannot unflatten unevenly sharded tensor"). Every
cell of whisper-medium, olmoe-1b-7b, granite-moe-3b-a800m, qwen2-vl-7b and
xlstm-125m failed as well: their models mixed plain tensors into DTensor
ops (the sinusoid tables, the MoE's output buffer, the xLSTM's causal
mask) or, for qwen2-vl-7b, built the M-RoPE index on the meta device
without its size. zamba2-2.7b passed everywhere, and the dense archs on
(2, 2) under ``tp``.

Fault F6: torch 2.11's DTensor (the card's) refuses a view that flattens
several dimensions once one after the first is sharded, and a 3-D @ 2-D
matmul views its (B, S, d) operand, and in the backward the product's
gradient, as (B S, d); torch 2.13's rule accepts it. Run by the parent of
the repair (``sharding/context.py::project``) under torch 2.11.0+cu128,
28 training cells failed:
  * on (2, 2) under ``sp``: smollm-360m, qwen2.5-14b, qwen1.5-110b,
    whisper-medium, olmoe-1b-7b, xlstm-125m, granite-moe-3b-a800m,
    qwen2-vl-7b, mistral-large-123b and zamba2-2.7b, each with
    "Attempted to flatten multiple dimensions, with dimension 1 being
    sharded" (the sequence, in the MLP's, the Mamba2 in-projection's, the
    mLSTM up-projection's or the logits' ``x @ w``), in its own process
    as in a sweep;
  * on (2, 2) under ``zero3`` and ``tp``: smollm-360m, qwen2.5-14b,
    qwen1.5-110b, whisper-medium, olmoe-1b-7b and xlstm-125m, and under
    ``2d`` zamba2-2.7b and xlstm-125m on (2, 2), (2, 16) and (16, 16).
    These 18 ran in their own processes; they failed in the sweep only
    after an ``sp`` cell had failed in the same process: that cell's
    checkpointed layer left its saved-tensor hooks in place (torch 2.13's
    checkpoint unwinds them when a forward raises), so the next cell's
    backward recomputed the failed cell's layer. The flatten error again,
    "Attempting to broadcast" (another arch's widths) in an ``rms_norm``,
    and "Could not resolve the process group" (a destroyed group's name)
    in a ``product_on_shards`` were those recomputations.
Torch 2.13 runs every cell. ``view_rule_2_11`` holds 2.11's view rule
here: ``run_cell`` and ``run_serve_cell`` run every cell under it.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import replace

CUTS = {"xlstm-125m": dict(n_layers=4), "zamba2-2.7b": dict(n_layers=6),
        "whisper-medium": dict(n_layers=2, n_enc_layers=2)}
XLSTM_SEQ = 128
MAX_MICROBATCHES = 2


def _placements(tree) -> list:
    """The placements of a tree's leaves in key order: a DTensor's, or a
    placements tuple itself."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _placements(tree[k])]
    return [tuple(getattr(tree, "placements", tree))]


# torch 2.11's refusal, word for word (a RuntimeError of two strings)
VIEW_RULE_ERROR = ("Attempted to flatten multiple dimensions, with dimension "
                   "{} being sharded. ", "It cannot be performed without "
                   "redistribution, which is disallowed by the current "
                   "operator.")


@contextlib.contextmanager
def view_rule_2_11():
    """DTensor's view rule as torch 2.11 has it, whatever torch runs: a view
    (``aten.view``, ``aten._unsafe_view``: a strict view, which may not
    redistribute) that flattens several dimensions refuses a shard on any
    but the first of them. A 3-D @ 2-D matmul views its (B, S, d) operand
    as (B S, d), so a sequence-sharded ``x @ w`` raises (fault F6). Torch
    2.13's rule accepts it (the shard becomes a strided one). The guard
    wraps the view propagator's flatten analysis and clears the sharding
    caches on entry and exit; where torch has no such propagator, its own
    rule is 2.11's and nothing is wrapped."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._ops import _view_ops
    from torch.distributed.tensor.debug import _clear_sharding_prop_cache
    from torch.distributed.tensor.placement_types import _StridedShard

    cls = getattr(_view_ops, "_ViewShardingPropagator", None)
    if cls is None:
        yield
        return
    analyze = cls._analyze_flatten

    def refusing(self, cmd):
        if self.strict_view:
            for dim in cmd.input_dims[1:]:
                if any(isinstance(p, (Shard, _StridedShard))
                       and p.dim == dim.input_dim
                       for p in self.input_src_placements):
                    msg = VIEW_RULE_ERROR[0].format(dim.input_dim)
                    raise RuntimeError(msg, VIEW_RULE_ERROR[1])
        return analyze(self, cmd)

    _clear_sharding_prop_cache()
    cls._analyze_flatten = refusing
    try:
        yield
    finally:
        cls._analyze_flatten = analyze
        _clear_sharding_prop_cache()


@contextlib.contextmanager
def fake_mesh(mesh_shape: tuple):
    """A ("data", "model") DeviceMesh of ``mesh_shape`` over a ``fake``
    process group, destroyed on exit; of three dimensions, a ("pod",
    "data", "model") one, as the multi-pod production mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(mesh_shape))
    names = ("pod", "data", "model")[-len(mesh_shape):]
    try:
        yield init_device_mesh("cpu", mesh_shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _cut(arch: str):
    from repro_torch.configs import ARCHS

    cfg = replace(ARCHS[arch], **CUTS.get(arch, dict(n_layers=2)))
    return replace(cfg, microbatches=min(cfg.microbatches, MAX_MICROBATCHES))


def run_cell(arch: str, mesh_shape: tuple, strategy: str) -> dict:
    """The cut ``train_4k`` cell of ``arch`` on a fake (data, model) mesh of
    ``mesh_shape`` under ``strategy``: the loss's shape, the state's leaves
    and whether each kept the placements it came in with."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import cell_fns
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import distribute_tree

    shape = SHAPES["train_4k"]
    if arch == "xlstm-125m":
        shape = ShapeConfig("train_4k", XLSTM_SEQ, shape.global_batch,
                            "train")
    with fake_mesh(mesh_shape) as mesh:
        step, args, in_pl, out_pl, _ = cell_fns(build_model(_cut(arch)),
                                                shape, strategy, mesh)
        state = distribute_tree(args[0], mesh, in_pl[0])
        batch = distribute_tree(args[1], mesh, in_pl[1])
        with view_rule_2_11(), activation_sharding(mesh, strategy):
            new, metrics = step(state, batch)
        return {"loss_shape": tuple(metrics["loss"].shape),
                "placements": _placements(new),
                "want": _placements(in_pl[0]),
                "out_pl": _placements(out_pl[0])}


def run_serve_cell(arch: str, mesh_shape: tuple, strategy: str,
                   shape_name: str = "decode_32k"):
    """The cut serving cell ``shape_name`` (``prefill_32k``, ``decode_32k``
    or ``long_500k``) of ``arch`` on a fake mesh: one prefill or decode
    step on meta arguments placed by the cell (xlstm-125m's prompt cut to
    XLSTM_SEQ tokens, as its training cells are); returns its outputs."""
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.cells import cell_fns
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import distribute_tree

    shape = SHAPES[shape_name]
    if arch == "xlstm-125m" and shape.kind == "prefill":
        shape = ShapeConfig(shape.name, XLSTM_SEQ, shape.global_batch,
                            shape.kind)
    with fake_mesh(mesh_shape) as mesh:
        fn, args, in_pl, _, _ = cell_fns(build_model(_cut(arch)), shape,
                                         strategy, mesh)
        args = [distribute_tree(a, mesh, pl) for a, pl in zip(args, in_pl)]
        with view_rule_2_11(), activation_sharding(mesh, strategy):
            return fn(*args)
