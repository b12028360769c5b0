"""Every arch's serving cells at full width, depth-cut as
``tests/_mesh_cells.py::CUTS`` cuts them, on a fake (2, 2, 2) ("pod",
"data", "model") mesh under ``2d`` and torch 2.11's view rule: one prefill
or decode step each (``prefill_32k``, ``decode_32k``, and ``long_500k``
where ``supports_shape`` allows it), whose logits and caches have the
shapes of the reference's same cell (``jax.eval_shape`` of its
``launch/cells.py::cell_fns`` function)."""
from dataclasses import replace

import jax
import pytest

from _mesh_cells import XLSTM_SEQ, _cut, run_serve_cell
from repro.configs import ARCHS as R_ARCHS
from repro.configs.base import ShapeConfig as RShapeConfig
from repro.models.registry import build_model as r_build
from repro_torch.configs import ARCHS, SHAPES, supports_shape

CELLS = [(arch, shape) for arch in ARCHS
         for shape in ("prefill_32k", "decode_32k", "long_500k")
         if supports_shape(ARCHS[arch], SHAPES[shape])]


def _shapes(tree) -> list:
    """The shapes of a tree's leaves, in key order."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _shapes(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _shapes(v)]
    return [tuple(tree.shape)]


def _reference_shapes(arch: str, shape_name: str) -> list:
    """The shapes of the reference's (logits, caches) of the same cut
    cell."""
    cut = _cut(arch)
    cfg = replace(R_ARCHS[arch], n_layers=cut.n_layers,
                  n_enc_layers=cut.n_enc_layers)
    s = SHAPES[shape_name]
    seq = XLSTM_SEQ if arch == "xlstm-125m" and s.kind == "prefill" \
        else s.seq_len
    shape = RShapeConfig(s.name, seq, s.global_batch, s.kind)
    model = r_build(cfg)
    params = model.abstract(dtype=cfg.dtype)
    batch = model.input_specs(shape)
    if s.kind == "prefill":
        return _shapes(jax.eval_shape(model.prefill, params, batch))
    cache = model.abstract_cache(shape.global_batch, shape.seq_len)
    return _shapes(jax.eval_shape(model.decode, params, batch, cache))


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_serve_cell_runs_on_a_fake_pod_mesh(arch, shape):
    out = run_serve_cell(arch, (2, 2, 2), "2d", shape)
    assert _shapes(out) == _reference_shapes(arch, shape)
