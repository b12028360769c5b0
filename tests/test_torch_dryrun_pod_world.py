"""The pod axis with numbers: 4 gloo ranks on a (2, 1, 2) ("pod", "data",
"model") mesh, the multi-pod production mesh's three axes, under ``2d``.
Reduced smollm-360m and reduced zamba2-2.7b in float64 train 3 steps of
4 x 16 tokens with 2 microbatches from the port's seed-0 state, against
the port's one-device run from the same state at the 2-D worlds' tolerance
(tests/test_torch_mesh_train.py: rtol 1e-5 plus an atol of 1e-5 of each
tensor's largest magnitude), and each serves a prefill and 4 decode steps
against one device at the serving world's tolerances
(tests/test_torch_mesh_families.py: rtol 1e-9, and 1e-6 for zamba2, whose
decode carries its SSM state in float32). The batch shards over the pod axis
(and a data axis of 1), the weights over the model axis."""
from __future__ import annotations

import numpy as np
import pytest

from _gloo import mesh_config, result, run_world, serve_run, train_run
from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.common import tree_map
from repro_torch.models.registry import build_model
from repro_torch.train.step import init_train_state

LOOP = dict(steps=3, batch=4, seq_len=16, microbatches=2)
ARCHS = ("smollm-360m", "zamba2-2.7b")
RTOL = 1e-5
SERVE_RTOL = {"zamba2-2.7b": 1e-6}


def _close(got, want, tol, what=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=tol, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _f64_checkpoint(arch, directory):
    """The port's initial state at seed 0, its params in float64, as a
    step-0 checkpoint."""
    state = init_train_state(build_model(mesh_config(arch, dtype="float64")),
                             0, "cpu")
    state["params"] = tree_map(lambda _, t: t.double(), state["params"])
    CheckpointManager(directory, async_save=False).save(0, state)
    return str(directory)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pod_ckpt0")
    return {arch: _f64_checkpoint(arch, tmp / arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def world(ckpts, tmp_path_factory):
    return run_world("pod_mesh", 4, tmp_path_factory.mktemp("pod_mesh"),
                     ckpts=ckpts, loop_kw=LOOP, archs=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_on_the_pod_mesh_matches_one_device(world, ckpts, arch):
    want = train_run(mesh_config(arch, dtype="float64"), None, dict(LOOP),
                     ckpt=ckpts[arch])
    for rank in range(4):
        got = result(world, f"train/{arch}", rank)
        assert got["dtensor"]
        _close(got["losses"], want["losses"], RTOL, f"{arch} losses")
        _close(got["grad_norms"], want["grad_norms"], RTOL,
               f"{arch} grad norms")
        for path, arr in want["params"].items():
            _close(got["params"][path], arr, RTOL, f"{arch} {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_the_pod_mesh_matches_one_device(world, arch):
    want = serve_run(mesh_config(arch, dtype="float64"), None)
    got = result(world, f"serve/{arch}")
    assert len(got["logits"]) == len(want["logits"]) == 5
    for i, (g, w) in enumerate(zip(got["logits"], want["logits"])):
        _close(g, w, SERVE_RTOL.get(arch, 1e-9), f"{arch} logits {i}")
