"""Faults F9-F12 (ROADMAP section 3), each held where it was found: what a
rank holds or moves, counted on meta tensors over a ``fake`` process group
(``core/hlo_analysis.py``'s counter), and the numbers against one device
and against the reference.

(a) F11. One zamba2-2.7b ``mamba_mix`` at full width on a fake (16, 16)
    mesh under ``2d``, forward and backward: no all-gather puts out an
    activation slice wider than a rank's d_inner / 16 (the parent gathered
    z, xBC and dt whole on every model rank: (8, 4096, 5120) and wider),
    no all-to-all runs, the in-projection's gradient comes back with the
    parameter's placements at its shard's size, and the counted all-gather
    bytes are the weights'.
(b) F10 and F12. ``project`` of a batch-sharded x against a weight sharded
    over the data axis (FSDP) on a fake (4, 2) mesh: the forward gathers
    the weight and the backward gathers it again, the weight's gradient is
    reduce-scattered to the weight's own placements at its shard's size,
    and no collective moves an x-sized tensor (the parent's DTensor matmul
    exchanged x over the data axis).
(c) F9. ``_sdpa``'s backward at smollm-360m's ``train_4k`` shape (8 rows a
    rank, 4096 positions, 15 / 5 heads of 64) on meta tensors: the live
    bytes above its inputs and gradients stay under five of one query
    chunk's f32 score buffers (its scores, probabilities and their
    gradients), and grow by under a quarter of one from 2 chunks to 8 (the
    parent kept every chunk's: 6.2 of them at 2 chunks, 18.9 at 8). Its
    gradients equal the reference ``_sdpa``'s ``jax.grad`` at
    tests/test_torch_context_parallel.py's float32 tolerance.
(d) Reduced zamba2-2.7b trained on a 2 x 2 gloo mesh in float64 under
    ``2d``, ``tp``, ``zero3`` and ``sp`` (the Mamba2 mixer on head shards;
    its float32 run is tests/test_torch_mesh_train.py's) against one
    device, at tests/test_torch_mesh_families.py's rtol.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from _gloo import mesh_config, result, run_world, train_run
from _mesh_cells import fake_mesh, view_rule_2_11
from repro.models.attention import _sdpa as r_sdpa
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.core import hlo_analysis
from repro_torch.core.hlo_analysis import count_program
from repro_torch.models.attention import Q_CHUNK, _sdpa
from repro_torch.models.common import logical_axes, tree_map
from repro_torch.models.mamba2 import mamba_mix, mamba_specs
from repro_torch.models.registry import build_model
from repro_torch.sharding.context import activation_sharding, project
from repro_torch.sharding.rules import distribute_tree, tree_shardings
from repro_torch.train.step import init_train_state

F32 = dict(rtol=2e-4, atol=2e-5)          # test_torch_context_parallel.py's


@pytest.fixture
def collectives(monkeypatch):
    """[(op, output shapes)] of every collective the cost counter counts
    while the fixture lives."""
    seen = []
    count = hlo_analysis.CostCounter._count

    def recording(self, func, args, kwargs, out):
        if func.namespace in hlo_analysis._COMM_NAMESPACES and \
                func._opname in hlo_analysis._COLLECTIVES:
            seen.append((hlo_analysis._COLLECTIVES[func._opname],
                         [tuple(t.shape)
                          for t in hlo_analysis._tensors(out)]))
        return count(self, func, args, kwargs, out)
    monkeypatch.setattr(hlo_analysis.CostCounter, "_count", recording)
    return seen


# ------------------------------------------------------------------ (a)

def test_mamba_mix_keeps_its_inner_shard(collectives):
    cfg = ARCHS["zamba2-2.7b"]
    B, S, m = 128, 4096, 16                  # a microbatch of train_4k
    specs = mamba_specs(cfg)
    meta = tree_map(lambda _, s: torch.empty(s.shape, device="meta"), specs)
    with fake_mesh((16, m)) as mesh, view_rule_2_11():
        pl = tree_shardings(logical_axes(specs), mesh, "2d", meta)
        params = distribute_tree(meta, mesh, pl)
        params = tree_map(lambda _, t: t.requires_grad_(), params)
        u = DTensor.from_local(
            torch.empty(B // 16, S, cfg.d_model, dtype=torch.bfloat16,
                        device="meta"), mesh, [Shard(0), Replicate()],
            run_check=False).requires_grad_()
        flat = [u, params["in_proj"], params["out_proj"]]

        def step():
            with activation_sharding(mesh, "2d"):
                out, _ = mamba_mix(cfg, params, u)
                return torch.autograd.grad(out, flat, torch.ones_like(out))
        run = count_program(step)
        du, dw, _ = run.output
    widest = B // 16 * S * (cfg.d_inner // m)
    for op, shapes in collectives:
        assert op != "all-to-all", shapes
        if op == "all-gather":
            for shape in shapes:
                assert len(shape) < 3 or np.prod(shape) <= widest, shape
    assert tuple(dw.placements) == tuple(params["in_proj"].placements)
    assert dw.to_local().shape == params["in_proj"].to_local().shape
    assert tuple(du.placements) == (Shard(0), Replicate())
    weights = 2 * sum(cfg.d_model * n for n in (
        2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.n_ssm_heads, cfg.d_inner))
    assert run.costs.collective_bytes_by_op["all-gather"] < 2 * weights


# ------------------------------------------------------------------ (b)

def test_project_gathers_the_weight_and_scatters_its_gradient(collectives):
    B, S, k, n = 8, 16, 32, 24
    with fake_mesh((4, 2)) as mesh:
        x = DTensor.from_local(torch.empty(B // 4, S, k, device="meta"),
                               mesh, [Shard(0), Replicate()],
                               run_check=False).requires_grad_()
        w = DTensor.from_local(torch.empty(k // 4, n, device="meta"), mesh,
                               [Shard(0), Replicate()],
                               run_check=False).requires_grad_()

        def step():
            with activation_sharding(mesh, "2d"):
                y = project(x, w)
                return y, torch.autograd.grad(y, (x, w), torch.ones_like(y))
        y, (dx, dw) = count_program(step).output
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert tuple(dw.placements) == tuple(w.placements)
    assert dw.to_local().shape == w.to_local().shape
    assert tuple(dx.placements) == tuple(x.placements)
    ops = [op for op, _ in collectives]
    assert ops.count("all-gather") == 2, collectives        # forward, backward
    assert ops.count("reduce-scatter") == 1, collectives
    for _, shapes in collectives:
        for shape in shapes:
            assert np.prod(shape) <= k * n, collectives      # never x-sized


# ------------------------------------------------------------------ (c)

def _sdpa_peak(Sq: int, Skv: int = 4096, B: int = 8, H: int = 15,
               Hkv: int = 5, D: int = 64) -> float:
    """Live bytes of ``_sdpa``'s forward and backward on meta tensors above
    its inputs and gradients, in query chunks' f32 score buffers."""
    qkv = [torch.empty(B, s, h, D, dtype=torch.bfloat16, device="meta",
                       requires_grad=True)
           for s, h in ((Sq, H), (Skv, Hkv), (Skv, Hkv))]

    def step(q, k, v):
        o = _sdpa(q, k, v, causal=True, q_offset=Skv - Sq)
        return torch.autograd.grad(o, (q, k, v), torch.ones_like(o))
    run = count_program(step, *qkv)
    chunk = B * H * Q_CHUNK * Skv * 4
    return (run.peak_bytes - run.arg_bytes - run.out_bytes) / chunk


def test_sdpa_backward_holds_one_chunk():
    two, eight = _sdpa_peak(2 * Q_CHUNK), _sdpa_peak(8 * Q_CHUNK)
    assert eight < 5, eight
    assert eight - two < 0.25, (two, eight)


def test_sdpa_gradients_match_the_reference():
    B, S, H, Hkv, D = 1, 2 * Q_CHUNK, 4, 2, 8
    rng = np.random.default_rng(7)
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))

    def loss(q, k, v):
        return jnp.sum(r_sdpa(None, q, k, v, causal=True) * g)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o = _sdpa(*t, causal=True)
    got = torch.autograd.grad(o, t, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32,
                                   err_msg=name)


# ------------------------------------------------------------------ (d)

LOOP = dict(steps=3, batch=4, seq_len=16, microbatches=2)
STRATEGIES = ("2d", "tp", "zero3", "sp")
F64 = dict(dtype="float64")
RUNS = {"zamba2-2.7b": ("zamba2-2.7b", F64, LOOP, STRATEGIES)}
RTOL = 1e-5                             # test_torch_mesh_families.py's


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The port's initial state at seed 0, float64 parameters, as a step-0
    checkpoint."""
    directory = tmp_path_factory.mktemp("zamba_f64")
    state = init_train_state(build_model(mesh_config("zamba2-2.7b", **F64)),
                             0, "cpu")
    state["params"] = tree_map(lambda _, t: t.double(), state["params"])
    CheckpointManager(directory, async_save=False).save(0, state)
    return str(directory)


@pytest.fixture(scope="module")
def world(ckpt, tmp_path_factory):
    return run_world("mesh_families", 4, tmp_path_factory.mktemp("zamba"),
                     ckpts={"zamba2-2.7b": ckpt}, runs=RUNS)


@pytest.fixture(scope="module")
def one_device(ckpt):
    return train_run(mesh_config("zamba2-2.7b", **F64), None, dict(LOOP),
                     ckpt=ckpt)


def _close(got, want, what):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), want, rtol=RTOL,
        atol=RTOL * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_zamba_on_head_shards_matches_one_device(world, one_device,
                                                 strategy):
    got = result(world, f"zamba2-2.7b/{strategy}")
    assert got["dtensor"]
    _close(got["losses"], one_device["losses"], f"{strategy} losses")
    _close(got["grad_norms"], one_device["grad_norms"],
           f"{strategy} grad norms")
    for k, a in one_device["params"].items():
        _close(got["params"][k], a, f"{strategy} {k}")
    for rank in range(1, 4):
        assert result(world, f"zamba2-2.7b/{strategy}", rank)["losses"] == \
            got["losses"]
