"""The port's elastic resharding (``runtime/elastic.py``) and its
mesh-agnostic checkpoints (``checkpoint/manager.py``) on gloo ranks.

Reduced smollm-360m's train state goes onto a 2 x 2 plan over 4 ranks,
then onto a plan over ranks [0, 1] (the reference's
``test_elastic_reshard_roundtrip``, which loses half of 8 devices): every
leaf is bit for bit the state it started as, and exactly 2 ranks hold it.
On 2 ranks, a DTensor state saved from a 1 x 2 mesh is gathered
collectively and written once, and ``restore`` puts it back on its
placements."""
import json

import numpy as np
import pytest
import torch

from _gloo import result, run_world
from repro_torch.checkpoint import CheckpointManager

LOOP = dict(batch=4, seq_len=16)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world("elastic", 4, tmp_path_factory.mktemp("elastic"),
                     loop_kw=LOOP)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world("checkpoint_on_mesh", 2,
                     tmp_path_factory.mktemp("ckpt_mesh"))


def test_reshard_onto_two_ranks_is_bitwise(world4):
    ref = result(world4, "reshard", 0)["ref"]
    for rank in (0, 1):
        got = result(world4, "reshard", rank)
        assert got["mesh"] == (1, 2) and got["in_mesh"]
        assert sorted(got["after"]) == sorted(ref)
        for k, a in ref.items():
            assert got["after"][k].tobytes() == a.tobytes(), k


def test_resharded_state_is_held_on_exactly_two_ranks(world4):
    held = [result(world4, "reshard", r)["held"] for r in range(4)]
    assert held[0] > 0 and held[1] > 0, held
    assert held[2] == 0 and held[3] == 0, held
    assert not result(world4, "reshard", 2)["in_mesh"]


def test_mesh_checkpoint_is_written_once_and_restored_onto_its_plan(world2):
    for rank in (0, 1):
        got = result(world2, "save_restore", rank)
        assert got["files"] == ["step_0000000003"]
        assert got["step"] == 3 and got["same"] and got["dtensor"]
        # embed (vocab 128, d 64): vocab over model (2), embed over data (1)
        assert got["sharded_local"] == (64, 64)
        assert got["full"] == (128, 64)
        assert got["plain_device"] == {"cpu"}


def test_restore_defaults_to_the_saved_device(tmp_path):
    """The manifest records the state's device and ``restore`` returns
    there unless asked otherwise (a CPU-only host shows it with the meta
    device written in)."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, {"w": torch.arange(4.0)})
    manifest = tmp_path / "step_0000000001" / "manifest.json"
    meta = json.loads(manifest.read_text())
    assert meta["device"] == "cpu"
    meta["device"] = "meta"
    manifest.write_text(json.dumps(meta))
    assert mgr.restore()[1]["w"].device.type == "meta"
    got = mgr.restore(device="cpu")[1]["w"]
    np.testing.assert_array_equal(got.numpy(), np.arange(4.0))
    with pytest.raises(ValueError, match="mesh"):
        mgr.restore(placements={"w": ()})


def test_restore_keeps_a_scalar_s_shape(tmp_path):
    """A 0-d leaf (the optimizer's step) comes back 0-d, so it
    redistributes onto a mesh like the state it was saved from."""
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(2, {"step": torch.tensor(5, dtype=torch.int32),
                 "w": torch.ones(2, 3)})
    got = mgr.restore()[1]
    assert got["step"].shape == () and int(got["step"]) == 5
    assert got["w"].shape == (2, 3)
