"""The port's multi-device training (``train.loop.run_training`` with a
mesh, ``sharding``, the attention and SSD cores under ``local_map``,
``runtime.elastic``, ``checkpoint``) on 4 gloo ranks, against the port's
one-device run and the reference's run.

Reduced smollm-360m and reduced zamba2-2.7b (float32) train 3 steps of
4 x 16 tokens with 2 microbatches on a 2 x 2 ("data", "model") mesh under
``2d``, ``tp`` and ``zero3``, every rank starting from the reference's
initial state (``jax.random.key(0)``, carried over as a step-0 checkpoint),
with AdamW's epsilon at 1 (``_gloo.ADAM_EPS`` says why). Against the
port's one-device ``run_training`` from the same state, the losses, grad
norms and final parameters are held within rtol 1e-5 (plus an atol of
1e-5 of each tensor's largest magnitude): only the order of the sums
differs. Against the reference's ``run_training`` on a 1-device host mesh
(its jnp paths, ``use_pallas=False``), the losses are held to
tests/test_torch_train.py's tolerance, rtol 1e-4 plus an atol of 1e-4 of
the largest. Also: attention runs on head shards (4 heads, model axis 2);
2 KV heads on model axis 4 take the reference's ``head_dim`` fallback and
still match (in float64); a crash after step 1 resumed onto a 1 x 2 plan
over ranks [0, 1] continues the uninterrupted run; a checkpointed layer
recomputes in its forward's scope."""
from __future__ import annotations

from dataclasses import replace

import jax
import numpy as np
import pytest
from torch.distributed.tensor import Replicate, Shard

from _gloo import (ADAM_EPS, FALLBACK, mesh_config, result, run_world,
                   train_run)
from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.models.registry import build_model as r_build
from repro.train.loop import TrainLoopConfig as RLoopConfig
from repro.train.loop import run_training as r_run_training
from repro.train.optimizer import OptConfig as ROptConfig
from repro.train.step import init_train_state as r_init_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.convert import train_state_from_arrays
from repro_torch.models.common import tree_map
from repro_torch.models.registry import build_model
from repro_torch.train.step import init_train_state

LOOP = dict(steps=3, batch=4, seq_len=16, microbatches=2)
ARCHS = ("smollm-360m", "zamba2-2.7b")
STRATEGIES = ("2d", "tp", "zero3")
RTOL = 1e-5
REF_TOL = 1e-4


def _close(got, want, tol, what=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=tol, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _ref_checkpoint(arch, directory):
    """The reference's initial train state, as the port's step-0
    checkpoint."""
    r_model = r_build(r_reduced(R_ARCHS[arch]))
    r_state = r_init_train_state(r_model, jax.random.key(0))
    arrays = jax.tree.map(np.asarray, r_state)
    state = train_state_from_arrays(build_model(mesh_config(arch)).specs,
                                    arrays, device="cpu")
    CheckpointManager(directory, async_save=False).save(0, state)
    return str(directory)


def _f64_checkpoint(directory):
    """The head_dim fallback's initial state: the port's init at seed 0,
    its params in float64, as a step-0 checkpoint."""
    state = init_train_state(
        build_model(mesh_config("smollm-360m", **FALLBACK)), 0, "cpu")
    state["params"] = tree_map(lambda _, t: t.double(), state["params"])
    CheckpointManager(directory, async_save=False).save(0, state)
    return str(directory)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt0")
    out = {arch: _ref_checkpoint(arch, tmp / arch) for arch in ARCHS}
    out["fallback"] = _f64_checkpoint(tmp / "fallback")
    return out


@pytest.fixture(scope="module")
def world(ckpts, tmp_path_factory):
    import shutil

    out = tmp_path_factory.mktemp("mesh_train")
    shutil.copytree(ckpts[ARCHS[0]], out / "crash")
    return run_world("mesh_train", 4, out, ckpts=ckpts, loop_kw=LOOP,
                     strategies=STRATEGIES, archs=ARCHS)


@pytest.fixture(scope="module")
def one_device(ckpts):
    return {arch: train_run(mesh_config(arch), None, dict(LOOP),
                            ckpt=ckpts[arch]) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference():
    """The reference's losses. Its jnp chunked SSD takes ``exp`` before
    masking, so its zamba2 gradients are NaN once a chunk's decay overflows
    (tests/test_torch_train.py); it runs with that one line changed, as
    there."""
    import repro.models.mamba2 as r_mamba2
    from test_torch_train import _ssd_chunked_masked

    mesh = r_make_host_mesh()
    out = {}
    for arch in ARCHS:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(r_mamba2, "_ssd_chunked_jnp", _ssd_chunked_masked)
            got = r_run_training(
                r_build(r_reduced(R_ARCHS[arch])), mesh,
                RLoopConfig(log_every=1000, strategy="2d", **LOOP),
                opt_cfg=ROptConfig(lr=3e-3, eps=ADAM_EPS,
                                   total_steps=LOOP["steps"],
                                   warmup_steps=1),
                log_fn=lambda *_: None)
        out[arch] = got["losses"]
    return out


def _hold_to(got, want, what):
    _close(got["losses"], want["losses"], RTOL, f"{what} losses")
    _close(got["grad_norms"], want["grad_norms"], RTOL, f"{what} grad norms")
    assert sorted(got["params"]) == sorted(want["params"])
    for k, a in want["params"].items():
        _close(got["params"][k], a, RTOL, f"{what} {k}")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_matches_one_device(world, one_device, arch, strategy):
    got = result(world, f"{arch}/{strategy}")
    assert got["dtensor"]
    _hold_to(got, one_device[arch], f"{arch}/{strategy}")
    # every rank ends with the same whole parameters
    for rank in range(1, 4):
        other = result(world, f"{arch}/{strategy}", rank)
        assert other["losses"] == got["losses"]
        for k, a in got["params"].items():
            np.testing.assert_array_equal(other["params"][k], a)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_losses_match_reference(world, reference, arch, strategy):
    got = result(world, f"{arch}/{strategy}")
    _close(got["losses"], reference[arch], REF_TOL, f"{arch}/{strategy}")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_attention_runs_on_head_shards(world, arch, strategy):
    """4 heads (and 4 KV heads) on model axis 2: each rank's attention
    core sees 2 heads of q and of k, and 1 row (4 rows over 2 data ranks,
    in 2 microbatches)."""
    shapes = result(world, f"{arch}/{strategy}")["attn_shapes"]
    assert shapes == [((1, 16, 2, 16), (1, 16, 2, 16))], shapes


def test_head_dim_fallback_matches_one_device(world, ckpts):
    """2 KV heads on model axis 4: the rules shard wk's head_dim, and the
    attention core keeps q's head shard (one q head a rank) against the
    one KV head it reads, out of K/V whole (``_core_on_shards``), and
    matches the one-device run (both in float64, ``_gloo.FALLBACK`` says
    why)."""
    got = result(world, "head_dim_fallback")
    # wk is (layers, embed, kv_heads, head_dim): head_dim over model (embed
    # over a data axis of 1 is replicated)
    assert got["wk"] == (Replicate(), Shard(3))
    assert got["attn_shapes"] == [((2, 16, 1, 16), (2, 16, 1, 16))]
    cfg = mesh_config("smollm-360m", **FALLBACK)
    _hold_to(got, train_run(cfg, None, dict(LOOP), ckpt=ckpts["fallback"]),
             "head_dim fallback")


def test_crash_resume_onto_a_smaller_plan(world):
    """Crash after step 1 on 2 x 2; resume on ranks [0, 1] as a 1 x 2 plan
    from the step-1 checkpoint: steps 1 and 2 repeat the uninterrupted
    run's; ranks 2 and 3 sit out."""
    got = result(world, "crash_resume")
    assert got["mesh"] == (1, 2)
    whole = result(world, f"{ARCHS[0]}/2d")
    _close(got["losses"], whole["losses"][1:], RTOL, "resumed losses")
    for k, a in whole["params"].items():
        _close(got["params"][k], a, RTOL, k)
    assert result(world, "crash_resume", 1)["mesh"] == (1, 2)
    for rank in (2, 3):
        assert result(world, "crash_resume", rank) == {"sat_out": True}


def test_checkpoint_recomputes_in_the_forward_s_scope(world):
    """A checkpointed layer's recomputation runs in the scope its forward
    ran in, wherever the backward runs: the gradients taken outside the
    scope equal those taken inside, bit for bit."""
    got = result(world, "recompute_outside_scope")
    assert got["equal"] and got["leaves"] == 11
