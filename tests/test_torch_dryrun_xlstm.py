"""Faults F27 and F28 (ROADMAP section 3), repaired by the xLSTM's
recurrences as scans with their own backward (``models/xlstm.py``) and the
cost counter's count of a ``scan`` (``core/hlo_analysis.py``).

F28: the one-device trace of an xLSTM cell (``core/features.py::
trace_graph``, the dry-run's features) unrolled the sLSTM's steps op by op,
and xlstm-125m's ``prefill_32k`` and ``train_4k`` traces ran over 2 hours
and were stopped, so those records had no features. Now the trace keeps
each recurrence as ``scan`` nodes: its node count does not grow with the
sequence, and its 12 features are held to the reference's (its lowered
StableHLO, ``core/features.py::extract_from_text``) of the same reduced
cell, each at the ratio stated in FEATURE_RATIOS.

F27: xlstm-125m's ``train_4k`` peak a rank was 2.76x / 2.06x the
reference's: the autograd of the unrolled loops kept every step's
intermediates, and the mLSTM every chunk's (C, n, m) and its q/k/v in
float32. The cell cut to one group of 4 layers at full width and length,
on a fake (16, 16) and (2, 16, 16) mesh under ``2d``, is held within
1.15x the reference's count of the same cell (``peak_bytes_tpu``: lowered
and compiled on 512 host devices in a subprocess, its ``analyze_cell``).
Its parent counted 5,466,121,716 bytes a rank on (16, 16), 2.33x the
reference's 2,347,162,448."""
from dataclasses import replace

import pytest
import torch

import test_distributed
from _mesh_cells import fake_mesh, view_rule_2_11
from repro_torch.configs import ARCHS, SHAPES, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotune import cell_features, strategy_costs
from repro_torch.core.features import FEATURE_NAMES, LaunchConfig, trace_graph
from repro_torch.launch.cells import cell_fns
from repro_torch.models.registry import build_model

PEAK_LIMIT = 1.15
LAYERS = 4
MESHES = [(16, 16), (2, 16, 16)]
BATCH = 8
# the port's feature over the reference's, reduced xlstm-125m at 128
# tokens x 8 (2 microbatches in training), as measured (rel 0.02): the
# reference's while loops count more control ops a trip than the port's
# one a trip of a scan; the port's backward recomputes each step's forward
# from its entering state (special ops), where the reference's VJP reads
# the residuals its forward stacked (global memory); the norms' backward
# (``models/common.py::_RMSNorm``) takes fewer scalar operands than
# autograd's of the same formula (param_mem_vol: 0.306 before it);
# work_per_shard and num_shards are the launch's, sync_ops and
# shared_mem_vol 0 on both
FEATURE_RATIOS = {
    "train": {"total_instr": 0.960, "arith_ops": 1.085,
              "special_ops": 1.592, "logic_ops": 0.679,
              "control_ops": 0.259, "global_mem_vol": 0.617,
              "param_mem_vol": 0.296, "arith_intensity": 1.758},
    "prefill": {"total_instr": 1.043, "arith_ops": 0.996,
                "special_ops": 1.000, "logic_ops": 0.668,
                "control_ops": 0.247, "global_mem_vol": 1.566,
                "param_mem_vol": 0.576, "arith_intensity": 0.636},
}
SEQ = 128


def _trace(kind: str, seq: int):
    with fake_mesh((4, 2)) as mesh:
        fn, args, _, _, _ = cell_fns(build_model(reduced(ARCHS["xlstm-125m"])),
                                     ShapeConfig("c", seq, BATCH, kind),
                                     "2d", mesh)
        return trace_graph(fn, *args)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_trace_keeps_the_recurrences_as_scans(kind):
    """The same graph at 128 and 256 tokens (2 and 4 chunks, 128 and 256
    sLSTM steps): the loops are not unrolled."""
    graphs = [_trace(kind, seq) for seq in (SEQ, 2 * SEQ)]
    scans = [sum(n.target is torch.ops.higher_order.scan
                 for n in g.graph.nodes) for g in graphs]
    assert scans[0] == scans[1] > 0
    assert len(graphs[0].graph.nodes) == len(graphs[1].graph.nodes)


@pytest.fixture(scope="module")
def reference_features():
    """The reference's 12 features of the reduced cells, from its lowered
    program (what its dry-run records)."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.configs import ARCHS as R_ARCHS
    from repro.configs import reduced as r_reduced
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.core.features import LaunchConfig as RLaunchConfig
    from repro.core.features import extract_from_text
    from repro.launch.cells import cell_fns as r_cell_fns
    from repro.models.registry import build_model as r_build

    out = {}
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    for kind in FEATURE_RATIOS:
        fn, args, _, _, _ = r_cell_fns(
            r_build(r_reduced(R_ARCHS["xlstm-125m"])),
            RShapeConfig("c", SEQ, BATCH, kind), "2d", mesh)
        out[kind] = extract_from_text(
            jax.jit(fn).lower(*args).as_text(),
            RLaunchConfig(work_items=float(SEQ * BATCH), n_shards=8)
        ).as_dict()
    return out


@pytest.mark.parametrize("kind", sorted(FEATURE_RATIOS))
def test_features_against_the_reference(reference_features, kind):
    want = reference_features[kind]
    with fake_mesh((4, 2)) as mesh:
        got = cell_features(build_model(reduced(ARCHS["xlstm-125m"])),
                            ShapeConfig("c", SEQ, BATCH, kind), mesh,
                            LaunchConfig(work_items=float(SEQ * BATCH),
                                         n_shards=8)).as_dict()
    for name in FEATURE_NAMES:
        ratio = FEATURE_RATIOS[kind].get(name)
        if ratio is None:                   # the launch's, or 0 on both
            assert got[name] == want[name], name
        else:
            assert got[name] / want[name] == pytest.approx(ratio, rel=0.02), \
                (name, got[name], want[name])


@pytest.fixture(scope="module")
def reference_peaks():
    """{mesh: the reference's peak_bytes_tpu a device of the cut cell}."""
    return test_distributed.run_sub(f"""
        from dataclasses import replace
        from jax.sharding import Mesh
        from repro.configs import ARCHS, SHAPES
        from repro.launch.cells import cell_fns
        from repro.launch.roofline import analyze_cell
        from repro.models.registry import build_model
        from repro.sharding.context import activation_sharding

        out = {{}}
        for m in {MESHES!r}:
            n = int(np.prod(m))
            mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(m),
                        ("pod", "data", "model")[-len(m):])
            cfg = replace(ARCHS["xlstm-125m"], n_layers={LAYERS})
            shape = SHAPES["train_4k"]
            fn, args, in_sh, out_sh, donate = cell_fns(
                build_model(cfg), shape, "2d", mesh)
            with mesh, activation_sharding(mesh, "2d"):
                c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                            donate_argnums=donate).lower(*args).compile()
            rep = analyze_cell(c, arch="xlstm-125m", shape=shape,
                               mesh_name="m", n_devices=n, strategy="2d",
                               cfg=cfg)
            out[str(m)] = rep.peak_bytes_tpu
        print("RESULT:" + json.dumps(out))
    """, devices=512)


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: "x".join(map(str, s)))
def test_train_peak_within_the_reference(reference_peaks, mesh_shape):
    model = build_model(replace(ARCHS["xlstm-125m"], n_layers=LAYERS))
    with fake_mesh(mesh_shape) as mesh, view_rule_2_11():
        run = strategy_costs(model, SHAPES["train_4k"], mesh, "2d")
    want = reference_peaks[str(mesh_shape)]
    assert 0 < run.peak_bytes <= PEAK_LIMIT * want, (
        run.peak_bytes, want, run.peak_bytes / want)
