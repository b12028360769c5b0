"""Every arch's serving cells at full width under ``2d`` on a fake (2, 2)
mesh: ``prefill_32k`` and ``decode_32k``, and ``long_500k`` where
``supports_shape`` allows it (the sub-quadratic families), one step each
on meta arguments placed by the cell (tests/_mesh_cells.py says how and
what is cut). Before the repair of faults F2-F4 every cell but
xlstm-125m's prefill failed; the numbers of the repaired paths are held on
4 gloo ranks in tests/test_torch_mesh_families.py."""
import pytest

from _mesh_cells import _cut, run_serve_cell
from repro_torch.configs import ARCHS, SHAPES, supports_shape

CELLS = [(arch, shape) for arch in ARCHS
         for shape in ("prefill_32k", "decode_32k", "long_500k")
         if supports_shape(ARCHS[arch], SHAPES[shape])]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_serve_cell_runs_on_a_fake_mesh(arch, shape):
    logits, caches = run_serve_cell(arch, (2, 2), "2d", shape)
    assert tuple(logits.shape) == (SHAPES[shape].global_batch, 1,
                                   _cut(arch).vocab)
    assert caches is not None
