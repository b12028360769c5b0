"""The moe, vlm, xlstm and encdec families trained on 4 gloo ranks, a 2 x 2
("data", "model") mesh, against the port's one-device run and the
reference's run, as tests/test_torch_mesh_train.py holds dense and
mamba_hybrid; and fault F1's repair at a head count the model axis does
not divide.

Reduced granite-moe-3b-a800m, qwen2-vl-7b, xlstm-125m and whisper-medium
train 3 steps of 4 x 16 tokens in 2 microbatches under ``2d``, ``tp`` and
``zero3`` with AdamW's epsilon at 1 (``_gloo.ADAM_EPS``), every rank and
the reference from the same initial state: the reference's init with its
constant leaves perturbed (``_lm_parity.ref_params``, at the parameter
seed each family's own test holds its gradients at, where the reference
is stable under a one-ulp nudge), as a step-0 checkpoint of each side.
The port runs in float64, as ``_gloo.FALLBACK`` does and for its reason:
the sums a mesh splits are summed in another order, and the reduced
models' float32 gradients sit 1e-5 to 1e-4 from a float64 run's, on one
device as on the mesh (the norms, the xLSTM's cells and the loss still
compute in float32). Against the port's one-device ``run_training`` the
losses, grad norms and final parameters are held within rtol 1e-5 (plus an
atol of 1e-5 of each tensor's largest magnitude); against the reference's
``run_training`` (float32) on a 1-device host mesh the losses within rtol
1e-4 (plus 1e-4 of the largest).

F1: reduced smollm-360m with 3 query heads over 1 KV head, so that neither
count divides the model axis of 2 and the weights shard ``head_dim``,
trains under ``2d``, ``zero3`` and ``sp`` and matches the one-device run
at rtol 1e-5, in float64 as ``_gloo.FALLBACK`` is (it raised on the mesh
before the repair).

Serving on the mesh (faults F2-F4): reduced xlstm-125m, smollm-360m,
granite-moe-3b-a800m, qwen2-vl-7b, zamba2-2.7b and whisper-medium, in
float64 under ``2d``, prefill a (4, 8) prompt and take 4 decode steps
against a 12-position cache whose sequence the model axis shards
(``_gloo.serve_run``): every logits array equals the one-device run's at
rtol 1e-9 (plus 1e-9 of the largest), zamba2's at 1e-6, since its SSD
scan computes in float32 whatever the model's dtype (its kernel's
precision) and float32 products over a batch shard round apart from the
whole batch's (7.5e-8 apart).

Whisper under ``sp``: the activations' sequence takes the model axis, so
the encoder's K/V reach ``models/attention.py::attend_full`` sharded over
the sequence; where a gradient is taken it gathers them
(``_core_on_shards``), since the merge of each rank's partial softmax over
its own keys (``_full_on_key_shards``) derives no gradient placements.
Reduced whisper-medium in float64 from the port's seed-0 state matches
the one-device run at rtol 1e-5 (it was 1.9e-3 off in its losses on the
key-shard route).

MoE drops: reduced granite with 3 experts (the model axis does not divide
them, so the dispatch buffer shards its capacity slots) and a capacity
factor of 0.25 over 4 x 32 tokens drops tokens; the mesh drops the same
tokens as one device (routing is global over the microbatch) and matches
it at rtol 1e-5."""
from __future__ import annotations

import jax
import numpy as np
import pytest

from _gloo import (ADAM_EPS, mesh_config, result, run_world, serve_run,
                   train_run)
from _lm_parity import ref_params
from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.launch.mesh import make_host_mesh as r_make_host_mesh
from repro.models.registry import build_model as r_build
from repro.train.loop import TrainLoopConfig as RLoopConfig
from repro.train.loop import run_training as r_run_training
from repro.train.optimizer import OptConfig as ROptConfig
from repro.checkpoint.manager import CheckpointManager as RCheckpointManager
from repro.train.step import init_train_state as r_init_train_state
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.convert import train_state_from_arrays
from repro_torch.models.common import tree_map
from repro_torch.models.registry import build_model
from repro_torch.train.step import init_train_state

LOOP = dict(steps=3, batch=4, seq_len=16, microbatches=2)
# each family's parameter seed: its own test's (tests/test_torch_moe.py,
# test_torch_lm.py, test_torch_xlstm.py, test_torch_encdec.py)
SEEDS = {"granite-moe-3b-a800m": 3, "qwen2-vl-7b": 0, "xlstm-125m": 1,
         "whisper-medium": 2}
FAMILIES = tuple(SEEDS)
STRATEGIES = ("2d", "tp", "zero3")
F64 = dict(dtype="float64")
F1 = dict(n_heads=3, n_kv_heads=1, dtype="float64")
F1_STRATEGIES = ("2d", "zero3", "sp")
DROPS = dict(n_experts=3, capacity_factor=0.25)
DROP_LOOP = dict(steps=2, batch=4, seq_len=32, microbatches=1)
# name: (arch, config overrides, loop, strategies)
RUNS = {**{arch: (arch, F64, LOOP, STRATEGIES) for arch in FAMILIES},
        "f1": ("smollm-360m", F1, LOOP, F1_STRATEGIES),
        "moe_drops": ("granite-moe-3b-a800m", DROPS, DROP_LOOP, ("2d",)),
        "whisper_sp": ("whisper-medium", F64, LOOP, ("sp",))}
RTOL = 1e-5
REF_TOL = 1e-4
SERVE = ("xlstm-125m", "smollm-360m", "granite-moe-3b-a800m", "qwen2-vl-7b",
         "zamba2-2.7b", "whisper-medium")
SERVE_RTOL = {"zamba2-2.7b": 1e-6}


def _close(got, want, tol, what=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=tol, atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _ref_checkpoints(arch, directory):
    """The initial train state (``ref_params`` at the family's seed, zero
    moments) as step-0 checkpoints of the port (its parameters in float64)
    and of the reference: (port's directory, reference's)."""
    r_state = r_init_train_state(r_build(r_reduced(R_ARCHS[arch])),
                                 jax.random.key(0))
    r_state["params"] = jax.tree.map(jax.numpy.asarray,
                                     ref_params(arch, seed=SEEDS[arch]))
    RCheckpointManager(directory / "ref", async_save=False).save(0, r_state)
    state = train_state_from_arrays(build_model(mesh_config(arch)).specs,
                                    jax.tree.map(np.asarray, r_state),
                                    device="cpu")
    state["params"] = tree_map(lambda _, t: t.double(), state["params"])
    CheckpointManager(directory / "port", async_save=False).save(0, state)
    return str(directory / "port"), str(directory / "ref")


def _port_checkpoint(arch, overrides, directory):
    """The port's initial state at seed 0 (float64 parameters for a float64
    config), as a step-0 checkpoint."""
    cfg = mesh_config(arch, **overrides)
    state = init_train_state(build_model(cfg), 0, "cpu")
    if cfg.dtype == "float64":
        state["params"] = tree_map(lambda _, t: t.double(), state["params"])
    CheckpointManager(directory, async_save=False).save(0, state)
    return str(directory)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt0")
    out = {}
    for arch in FAMILIES:
        out[arch], out[f"ref/{arch}"] = _ref_checkpoints(arch, tmp / arch)
    for name in ("f1", "moe_drops", "whisper_sp"):
        arch, overrides, _, _ = RUNS[name]
        out[name] = _port_checkpoint(arch, overrides, tmp / name)
    return out


@pytest.fixture(scope="module")
def world(ckpts, tmp_path_factory):
    return run_world("mesh_families", 4,
                     tmp_path_factory.mktemp("mesh_families"), ckpts=ckpts,
                     runs=RUNS, serve=SERVE)


@pytest.fixture(scope="module")
def one_device(ckpts):
    from _gloo import _record_drops
    from repro_torch.models import moe

    slots = moe.dispatch_slots
    drops = _record_drops()
    out = {}
    try:
        for name, (arch, overrides, loop, _) in RUNS.items():
            drops.clear()
            out[name] = train_run(mesh_config(arch, **overrides), None,
                                  dict(loop), ckpt=ckpts[name])
            out[name]["keep"] = list(drops)
    finally:
        moe.dispatch_slots = slots    # later tests in this process
    return out


@pytest.fixture(scope="module")
def reference(ckpts):
    mesh = r_make_host_mesh()
    return {arch: r_run_training(
        r_build(r_reduced(R_ARCHS[arch])), mesh,
        RLoopConfig(log_every=1000, strategy="2d",
                    checkpoint_dir=ckpts[f"ref/{arch}"], **LOOP),
        opt_cfg=ROptConfig(lr=3e-3, eps=ADAM_EPS, total_steps=LOOP["steps"],
                           warmup_steps=1),
        log_fn=lambda *_: None)["losses"] for arch in FAMILIES}


def _hold_to(world, name, strategy, want):
    what = f"{name}/{strategy}"
    got = result(world, what)
    assert got["dtensor"]
    _close(got["losses"], want["losses"], RTOL, f"{what} losses")
    _close(got["grad_norms"], want["grad_norms"], RTOL, f"{what} grad norms")
    assert sorted(got["params"]) == sorted(want["params"])
    for k, a in want["params"].items():
        _close(got["params"][k], a, RTOL, f"{what} {k}")
    # every rank ends with the same whole parameters
    for rank in range(1, 4):
        other = result(world, what, rank)
        assert other["losses"] == got["losses"]
        for k, a in got["params"].items():
            np.testing.assert_array_equal(other["params"][k], a)
    return got


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_matches_one_device(world, one_device, arch, strategy):
    _hold_to(world, arch, strategy, one_device[arch])


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_losses_match_reference(world, reference, arch, strategy):
    _close(result(world, f"{arch}/{strategy}")["losses"], reference[arch],
           REF_TOL, f"{arch}/{strategy}")


@pytest.mark.parametrize("strategy", F1_STRATEGIES)
def test_heads_the_model_axis_does_not_divide(world, one_device, strategy):
    """3 query heads over 1 KV head on model axis 2 (fault F1's input):
    the mesh run returns and equals the one-device run."""
    _hold_to(world, "f1", strategy, one_device["f1"])


def test_whisper_under_sp_matches_one_device(world, one_device):
    """The encoder's sequence-sharded K/V in a training step (``sp``): the
    mesh run equals the one-device run."""
    _hold_to(world, "whisper_sp", "sp", one_device["whisper_sp"])


def test_moe_drops_the_same_tokens(world, one_device):
    """Every routing choice's keep mask on the mesh equals the one-device
    run's, some token is dropped, and the runs agree."""
    got = _hold_to(world, "moe_drops", "2d", one_device["moe_drops"])
    want = one_device["moe_drops"]["keep"]
    assert len(got["keep"]) == len(want) > 0
    for a, b in zip(got["keep"], want):
        np.testing.assert_array_equal(a, b)
    assert not all(k.all() for k in want)


@pytest.mark.parametrize("arch", SERVE)
def test_serve_on_a_mesh_matches_one_device(world, arch):
    """A prefill and 4 decode steps on the 2 x 2 mesh, the carried states
    and KV caches on the shards (the KV cache's sequence over the model
    axis), give the one-device run's logits and final caches."""
    tol = SERVE_RTOL.get(arch, 1e-9)
    got = result(world, f"serve/{arch}")
    want = serve_run(mesh_config(arch, dtype="float64"), None)
    assert len(got["logits"]) == len(want["logits"]) == 5
    for i, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        _close(a, b, tol, f"{arch} logits {i}")

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, list):
            return [x for t in tree for x in flat(t)]
        return [tree]
    for a, b in zip(flat(got["caches"]), flat(want["caches"]), strict=True):
        _close(a, b, tol, f"{arch} caches")
