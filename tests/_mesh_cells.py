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
"""
from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def fake_mesh(mesh_shape: tuple):
    """A ("data", "model") DeviceMesh of ``mesh_shape`` over a ``fake``
    process group, destroyed on exit."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_shape[0] * mesh_shape[1])
    try:
        yield init_device_mesh("cpu", mesh_shape,
                               mesh_dim_names=("data", "model"))
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
        with activation_sharding(mesh, strategy):
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
        with activation_sharding(mesh, strategy):
            return fn(*args)
