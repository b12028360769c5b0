"""Every arch's ``train_4k`` cell at full width under ``2d`` on fake
(2, 2), (2, 16) and (16, 16) meshes (tests/_mesh_cells.py says how, what is
cut and which cells failed before the F1 and F6 repairs), under torch
2.11's DTensor view rule: forward, backward and AdamW run, the loss is a
scalar, and the new state keeps the placements the cell gave the old
one."""
import pytest

from _mesh_cells import run_cell
from repro_torch.configs import ARCHS


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 16), (16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cell_runs_on_a_fake_mesh(arch, mesh_shape):
    got = run_cell(arch, mesh_shape, "2d")
    assert got["loss_shape"] == ()
    assert got["placements"] == got["want"] == got["out_pl"]
