"""Every arch's ``train_4k`` cell at full width, depth-cut as
``tests/_mesh_cells.py::CUTS`` cuts it, on a fake (2, 2, 2) ("pod",
"data", "model") mesh under ``2d``: the multi-pod production mesh's three
axes, which the dry-run's ``--mesh multipod`` cells run at (2, 16, 16).
Each cell runs under torch 2.11's DTensor view rule (``view_rule_2_11``):
forward, backward and AdamW run, the loss is a scalar, and the new state
keeps the placements the cell gave the old one."""
import pytest

from _mesh_cells import run_cell
from repro_torch.configs import ARCHS


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cell_runs_on_a_fake_pod_mesh(arch):
    got = run_cell(arch, (2, 2, 2), "2d")
    assert got["loss_shape"] == ()
    assert got["placements"] == got["want"] == got["out_pl"]
    assert all(len(p) == 3 for p in got["placements"])
