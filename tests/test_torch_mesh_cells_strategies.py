"""Every arch's ``train_4k`` cell at full width under ``zero3``, ``tp`` and
``sp`` on a fake (2, 2) mesh (tests/_mesh_cells.py says how, what is cut
and which cells failed before the F1 repair); ``2d`` is in
tests/test_torch_mesh_cells.py."""
import pytest

from _mesh_cells import run_cell, run_decode_cell
from repro_torch.configs import ARCHS


@pytest.mark.parametrize("strategy", ["zero3", "tp", "sp"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cell_runs_under_each_strategy(arch, strategy):
    got = run_cell(arch, (2, 2), strategy)
    assert got["loss_shape"] == ()
    assert got["placements"] == got["want"] == got["out_pl"]


@pytest.mark.parametrize("strategy", ["2d", "tp"])
def test_xlstm_decode_cell_refuses_a_mesh(strategy):
    """An xLSTM decode step on a mesh raises plainly: mesh training and
    prefill run the cells from a zero state, and a carried state is not
    placed on the shards yet."""
    with pytest.raises(NotImplementedError, match="decode step on a mesh"):
        run_decode_cell("xlstm-125m", (2, 2), strategy)
