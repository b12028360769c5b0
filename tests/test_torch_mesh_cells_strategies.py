"""Every arch's ``train_4k`` cell at full width under ``zero3``, ``tp`` and
``sp`` on a fake (2, 2) mesh (tests/_mesh_cells.py says how, what is cut
and which cells failed before the F1 repair); ``2d`` is in
tests/test_torch_mesh_cells.py."""
import pytest

from _mesh_cells import run_cell, run_serve_cell
from repro_torch.configs import ARCHS


@pytest.mark.parametrize("strategy", ["zero3", "tp", "sp"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_cell_runs_under_each_strategy(arch, strategy):
    got = run_cell(arch, (2, 2), strategy)
    assert got["loss_shape"] == ()
    assert got["placements"] == got["want"] == got["out_pl"]


@pytest.mark.parametrize("strategy", ["2d", "tp"])
def test_xlstm_decode_cell_runs_on_a_mesh(strategy):
    """An xLSTM decode step on a mesh runs the O(1) recurrences on the
    shards of the carried states (fault F2: it raised), and returns the
    logits of one token and every state at its cache shape."""
    from repro_torch.configs import SHAPES

    from _mesh_cells import _cut
    from repro_torch.models.registry import build_model

    logits, states = run_serve_cell("xlstm-125m", (2, 2), strategy)
    shape = SHAPES["decode_32k"]
    cfg = _cut("xlstm-125m")
    assert tuple(logits.shape) == (shape.global_batch, 1, cfg.vocab)
    want = build_model(cfg).abstract_cache(shape.global_batch,
                                           shape.seq_len)
    for part in ("m", "s"):
        assert [tuple(t.shape) for t in states[part]] == [
            tuple(t.shape) for t in want[part]]
