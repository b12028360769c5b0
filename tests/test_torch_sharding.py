"""The port's sharding rules (``repro_torch.sharding``, ``launch.mesh``,
``launch.cells``) against the reference's, with no ranks.

``spec_for_axes`` is called on both sides with a stand-in mesh (names and
sizes only) for every parameter, input and cache leaf of all 10 archs at
full size, under all 5 strategies, on the meshes (1, 1), (2, 4), (4, 2),
(16, 16) and (2, 16, 16): the specs must be equal. ``placements`` must give
each rank of a 2 x 2 x 2 mesh the local shape and offset that the
reference's ``NamedSharding`` gives its device (the reference's side runs
in an 8-virtual-device subprocess). ``make_production_mesh`` builds the
reference's shapes and names under a fake process group of 512 ranks."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as R_ARCHS
from repro.configs.base import ShapeConfig as RShape
from repro.launch.cells import cell_fns as r_cell_fns
from repro.models.registry import build_model as r_build
from repro.sharding import context as r_context  # noqa: F401  (act axes)
from repro.sharding.rules import STRATEGIES as R_STRATEGIES
from repro.sharding.rules import spec_for_axes as r_spec_for_axes
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.cells import cell_fns
from repro_torch.models.registry import build_model
from repro_torch.sharding import context  # noqa: F401  (act axes)
from repro_torch.sharding.rules import (STRATEGIES, local_chunk, placements,
                                        spec_for_axes, tree_shardings)
from torch.distributed.tensor import Replicate, Shard

ROOT = Path(__file__).resolve().parents[1]
MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 4)),
          (("data", "model"), (4, 2)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]
SHAPES = [("train", 1024, 32), ("prefill", 512, 6), ("decode", 4096, 16)]


def _port_mesh(names, sizes):
    return SimpleNamespace(mesh_dim_names=names, shape=sizes)


def _ref_mesh(names, sizes):
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


def _pairs(axes, shapes, path=()):
    """[(path, axes leaf, shape)] of an axes tree and its shapes tree (a
    shape is a tuple, or a leaf with ``.shape``)."""
    is_leaf = isinstance(axes, tuple) and all(
        isinstance(a, (str, type(None))) for a in axes)
    if is_leaf:
        shp = shapes.shape if hasattr(shapes, "shape") else shapes
        return [(path, axes, tuple(shp))]
    if isinstance(axes, dict):
        return [x for k in sorted(axes)
                for x in _pairs(axes[k], shapes[k], path + (k,))]
    return [x for i, a in enumerate(axes)
            for x in _pairs(a, shapes[i], path + (i,))]


def _port_leaves(model, kind, seq, batch):
    shape = ShapeConfig("t", seq, batch, kind)
    out = _pairs(model.param_axes(), model.abstract())
    out += _pairs(model.input_axes(shape), model.abstract_inputs(shape))
    out += _pairs(model.cache_axes(batch, seq),
                  model.abstract_cache(batch, seq))
    return out


def _ref_leaves(model, kind, seq, batch):
    shape = RShape("t", seq, batch, kind)
    out = _pairs(model.param_axes(), model.abstract())
    out += _pairs(model.input_axes(shape), model.input_specs(shape))
    out += _pairs(model.cache_axes(batch, seq),
                  model.abstract_cache(batch, seq))
    return out


def test_strategies_are_the_reference_s():
    assert STRATEGIES == R_STRATEGIES


@pytest.mark.parametrize("strategy", sorted(R_STRATEGIES))
@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_spec_for_axes_equals_reference(arch, strategy):
    port, ref = build_model(get_config(arch)), r_build(R_ARCHS[arch])
    n = 0
    for kind, seq, batch in SHAPES:
        got = _port_leaves(port, kind, seq, batch)
        want = _ref_leaves(ref, kind, seq, batch)
        assert [(p, a, s) for p, a, s in got] == \
            [(p, a, s) for p, a, s in want]
        for names, sizes in MESHES:
            pm, rm = _port_mesh(names, sizes), _ref_mesh(names, sizes)
            for path, axes, shp in got:
                for shape in (shp, None):
                    mine = spec_for_axes(axes, STRATEGIES[strategy], pm,
                                         shape)
                    theirs = tuple(r_spec_for_axes(
                        axes, R_STRATEGIES[strategy], rm, shape))
                    assert mine == theirs, (arch, strategy, sizes, path)
                    n += 1
    assert n >= 100


def test_placements_split_a_tensor_dim_over_two_mesh_dims():
    mesh = _port_mesh(("pod", "data", "model"), (2, 16, 16))
    assert placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements((None, "data"), mesh) == (Replicate(), Shard(1),
                                                Replicate())
    assert placements((), mesh) == (Replicate(),) * 3
    # a split over one rank is no split
    one = _port_mesh(("data", "model"), (1, 4))
    assert placements(("data", "model"), one) == (Replicate(), Shard(1))
    with pytest.raises(ValueError, match="order"):
        placements((("data", "pod"),), mesh)


CASES = [((8, 12, 4), (("pod", "data"), None, "model")),
         ((8, 12, 4), ("data", "model")),
         ((6, 4), (None, ("data", "model"))),
         ((4, 8, 2), ("model", None, "pod")),
         ((16,), (("pod", "data", "model"),)),
         ((5, 3), ())]


@pytest.fixture(scope="module")
def ref_indices():
    """{case: {device id: [(start, stop) per dim]}} of the reference's
    NamedSharding on a 2 x 2 x 2 mesh of 8 virtual devices, and the
    reference's production meshes (512 virtual devices)."""
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
        import json, sys
        sys.path.insert(0, {str(ROOT / 'src')!r})
        import jax, numpy as np
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from repro.launch.mesh import make_production_mesh
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                    ("pod", "data", "model"))
        out = []
        for shape, spec in {CASES!r}:
            spec = [tuple(s) if isinstance(s, list) else s for s in spec]
            m = NamedSharding(mesh, P(*spec)).devices_indices_map(
                tuple(shape))
            out.append({{str(d.id): [[s.start or 0,
                                      shape[i] if s.stop is None else s.stop]
                                     for i, s in enumerate(idx)]
                         for d, idx in m.items()}})
        prod = [[list(m.axis_names), [m.shape[a] for a in m.axis_names]]
                for m in (make_production_mesh(),
                          make_production_mesh(multi_pod=True))]
        print("RESULT:" + json.dumps({{"cases": out, "prod": prod}}))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT:")]
    return json.loads(line[-1][len("RESULT:"):])


@pytest.mark.parametrize("case", range(len(CASES)))
def test_placements_give_each_rank_the_reference_s_block(case,
                                                         ref_indices):
    """Rank r sits at mesh coordinate (r // 4, r // 2 % 2, r % 2), as
    device r does in the reference's mesh; its ``local_chunk`` of an arange
    tensor covers the reference's index block, and DTensor's own shape and
    offset for that rank agree."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset

    shape, spec = CASES[case]
    mesh = _port_mesh(("pod", "data", "model"), (2, 2, 2))
    pl = placements(spec, mesh)
    full = torch.arange(int(np.prod(shape))).reshape(shape)
    for rank in range(8):
        coord = (rank // 4, rank // 2 % 2, rank % 2)
        block = ref_indices["cases"][case][str(rank)]
        want = full[tuple(slice(a, b) for a, b in block)]
        assert torch.equal(local_chunk(full, (2, 2, 2), coord, pl), want)
        lshape, offset = _compute_local_shape_and_global_offset(
            shape, (2, 2, 2), list(coord), pl)
        assert tuple(lshape) == tuple(b - a for a, b in block)
        assert tuple(offset) == tuple(a for a, _ in block)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_under_a_fake_process_group(multi_pod, ref_indices):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh, mesh_devices

    names, sizes = ref_indices["prod"][int(multi_pod)]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(sizes)))
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        assert list(mesh.mesh_dim_names) == names
        assert list(mesh.shape) == sizes
        assert mesh_devices(mesh) == int(np.prod(sizes))
        # the rules read a DeviceMesh as they read the stand-in
        model = build_model(get_config("smollm-360m"))
        pl = tree_shardings(model.param_axes(), mesh, "2d", model.abstract())
        assert pl["embed"] == placements(spec_for_axes(
            ("vocab", "embed"), STRATEGIES["2d"], mesh, (49152, 960)), mesh)
    finally:
        dist.destroy_process_group()


def _meta_pairs(tree):
    """[(shape, dtype name)] of a meta tree or a ShapeDtypeStruct tree, in
    the reference's (sorted-key) leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _meta_pairs(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _meta_pairs(v)]
    return [(tuple(tree.shape), str(tree.dtype).split(".")[-1])]


def _placement_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _placement_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and tree and not hasattr(
            tree[0], "is_shard"):
        return [x for v in tree for x in _placement_leaves(v)]
    return [tuple(tree)]


@pytest.mark.parametrize("kind,seq,batch", SHAPES)
@pytest.mark.parametrize("arch", ["smollm-360m", "zamba2-2.7b"])
def test_cell_fns_match_the_reference(arch, kind, seq, batch):
    """The meta-device args have the reference's shapes and dtypes, and the
    placements are the reference's specs as ``placements``."""
    names, sizes = ("data", "model"), (4, 2)
    port, ref = build_model(get_config(arch)), r_build(R_ARCHS[arch])
    got = cell_fns(port, ShapeConfig("t", seq, batch, kind), "2d",
                   _port_mesh(names, sizes))
    want = r_cell_fns(ref, RShape("t", seq, batch, kind), "2d",
                      AbstractMesh(sizes, names))
    assert got[4] == want[4]
    assert len(got[1]) == len(want[1])
    for g_args, w_args, g_pl, w_sh in zip(got[1], want[1], got[2], want[2]):
        assert _meta_pairs(g_args) == _meta_pairs(w_args)
        assert all(t.device.type == "meta"
                   for t in jax.tree.leaves(g_args, is_leaf=lambda x:
                                            isinstance(x, torch.Tensor)))
        w_specs = [tuple(s.spec) for s in jax.tree.leaves(w_sh)]
        mesh = _port_mesh(names, sizes)
        assert _placement_leaves(g_pl) == [
            tuple(placements(tuple(s), mesh)) for s in w_specs]
