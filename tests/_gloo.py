"""Gloo worlds for the port's multi-rank tests, and the rank-side bodies.

``run_world(body, world, out_dir, **kw)`` spawns ``world`` ranks (one CPU
thread each) over a file store, runs ``body(rank, world, out_dir, **kw)``
in each and returns the results every rank pickled. A body runs each of its
checks through ``Checks``: a check that raises records its traceback under
its name, so each test asserts its own part. This module imports neither
jax nor the reference, so the ranks start quickly."""
from __future__ import annotations

import contextlib
import pickle
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


class Checks:
    def __init__(self):
        self.out: dict = {}

    def __call__(self, name: str, fn, *args):
        try:
            self.out[name] = fn(*args)
        except Exception:                   # recorded for the test to show
            self.out[name] = {"error": traceback.format_exc()}
        dist.barrier()


def _entry(rank, world, store, body, out_dir, kw):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        checks = Checks()
        globals()[body](rank, world, Path(out_dir), checks, **kw)
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(checks.out, f)
    finally:
        dist.destroy_process_group()


def run_world(body: str, world: int, out_dir: Path, timeout: float = 480,
              **kw) -> list[dict]:
    """[rank r's {check name: result}] of ``body`` run on ``world`` gloo
    ranks."""
    import pytest

    out_dir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        _entry, args=(world, str(out_dir / "store"), body, str(out_dir), kw),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"the {world} ranks of {body} did not finish in "
                            f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def result(results: list[dict], name: str, rank: int = 0):
    """A check's result on ``rank``; fails the test with the check's
    traceback if it raised."""
    import pytest

    got = results[rank][name]
    if isinstance(got, dict) and "error" in got:
        pytest.fail(f"{name} raised on rank {rank}:\n{got['error']}")
    return got


# ------------------------------------------------------------- rank bodies

def _arrays(tree, prefix=""):
    """{path: numpy} of a nested dict of (D)tensors, gathered whole."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_arrays(v, f"{prefix}{k}/"))
        return out
    t = tree.full_tensor() if isinstance(tree, DTensor) else tree
    return {prefix.rstrip("/"): t.detach().float().numpy().copy()}


# AdamW's epsilon in the parity runs. Adam divides each gradient by its own
# magnitude, so an element's update is sensitive to that gradient's
# rounding by up to 1 / eps. The reduced models' float32 gradients are
# themselves 3e-5 to 9e-5 (of each leaf's largest) off a float64 run, on
# one device as on the mesh, so with the default 1e-8 a sum taken in
# another order moves a few elements by a large share of lr, and 3 steps
# part at 1e-4 to 1e-3; with eps 1e-4 the embedding still parts at 1e-3.
# With eps = 1 the update is linear in the gradient (momentum SGD scaled by
# the bias corrections) and the runs agree to rounding.
ADAM_EPS = 1.0


# the head_dim fallback's config: 2 KV heads (4 q heads), in float64 (its
# initial state a float64 checkpoint). With model axis 4 every contraction
# over the heads is summed in 4 parts; in float32 the reduced model's
# gradient norm is itself 2e-5 off a float64 run, on one device as on the
# mesh (on opposite sides here), so float32 runs part at 4e-5. In float64
# the sharded and the one-device runs agree to the float32 of the loss and
# the optimizer.
FALLBACK = dict(n_kv_heads=2, dtype="float64")


def mesh_config(arch: str, **overrides):
    from repro_torch.configs import get_config, reduced

    return replace(reduced(get_config(arch)), use_pallas=True, **overrides)


def train_run(cfg, mesh, loop_kw: dict, ckpt: str | None = None,
              crash_at_step=None):
    """run_training's losses, grad norms and final params (whole)."""
    from repro_torch.models.registry import build_model
    from repro_torch.train.loop import TrainLoopConfig, run_training
    from repro_torch.train.optimizer import OptConfig

    loop = TrainLoopConfig(checkpoint_dir=ckpt, log_every=1000, **loop_kw)
    out = run_training(build_model(cfg), loop,
                       opt_cfg=OptConfig(lr=3e-3, eps=ADAM_EPS,
                                         total_steps=loop.steps,
                                         warmup_steps=1),
                       log_fn=lambda *_: None, device="cpu", mesh=mesh,
                       crash_at_step=crash_at_step)
    return {"losses": out["losses"], "grad_norms": out["grad_norms"],
            "params": _arrays(out["state"]["params"]),
            "dtensor": all(type(p).__name__ == "DTensor" for p in
                           _leaves(out["state"]["params"]))}


def _whole(tree):
    """A tree of (D)tensors (nested dicts, lists and tuples) as float64
    numpy, each DTensor gathered whole."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_whole(v) for v in tree]
    t = tree.full_tensor() if isinstance(tree, DTensor) else tree
    return t.detach().double().numpy().copy()


def _full(tree):
    """A tree of (D)tensors with each DTensor gathered whole."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_full(v) for v in tree)
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


# the serving runs' sizes: a prompt of SERVE_PROMPT tokens for each of
# SERVE_BATCH rows, then SERVE_STEPS decode steps against a cache of
# SERVE_PROMPT + SERVE_STEPS positions (even, so that a model axis of 2
# shards the KV cache's sequence)
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS = 4, 8, 4


def serve_run(cfg, mesh, strategy: str = "2d", seed: int = 0) -> dict:
    """A prefill of the family's batch at (SERVE_BATCH, SERVE_PROMPT),
    then SERVE_STEPS decode steps of seeded tokens, on one device (``mesh``
    None) or on ``mesh`` under ``strategy``: the parameters, the prompt
    and each step's tokens placed by the rules; the prefill's caches
    gathered, grown to their decode length (``place_prefill_caches``) and
    placed as the decode cell places them (``cache_axes``). Returns every
    logits array and the last caches, whole."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.serve import place_prefill_caches
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import distribute_tree, tree_shardings

    model = build_model(cfg)
    params = model.init(seed, "cpu")
    if cfg.dtype == "float64":
        params = tree_map(lambda _, t: t.double(), params)
    shape = ShapeConfig("serve", SERVE_PROMPT, SERVE_BATCH, "prefill")
    batch = model.make_batch(shape, seed=seed, device="cpu")
    start = SERVE_PROMPT + (batch["patch_embeds"].shape[1]
                            if "patch_embeds" in batch else 0)
    max_len = start + SERVE_STEPS
    steps = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (SERVE_STEPS, SERVE_BATCH, 1))

    def place(tree, axes):
        if mesh is None:
            return tree
        return distribute_tree(tree, mesh, tree_shardings(axes, mesh,
                                                          strategy, tree))

    scope = (activation_sharding(mesh, strategy) if mesh is not None
             else contextlib.nullcontext())
    params = place(params, model.param_axes())
    batch = place(batch, model.input_axes(shape))
    logits = []
    with scope:
        out, caches = model.prefill(params, batch)
        logits.append(out)
        caches = place(place_prefill_caches(model, _full(caches), max_len),
                       model.cache_axes(SERVE_BATCH, max_len))
        tok_axes = model.input_axes(ShapeConfig("step", max_len, SERVE_BATCH,
                                                "decode"))["tokens"]
        for i, tok in enumerate(steps):
            step = {"tokens": place(torch.as_tensor(tok, dtype=torch.int32),
                                    tok_axes), "pos": start + i}
            if cfg.family == "vlm":
                step["mrope_delta"] = 0
            out, caches = model.decode(params, step, caches)
            logits.append(out)
    return {"logits": [_whole(t) for t in logits], "caches": _whole(caches)}


def _by_path(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _record_attention_shards():
    """Patch the attention core to record (local q shape, local k shape)
    of every call; returns the list it appends to."""
    from repro_torch.models import attention

    seen = []
    core = attention._attend_core

    def recording(cfg, q, k, v, cos, sin):
        seen.append((tuple(q.shape), tuple(k.shape)))
        return core(cfg, q, k, v, cos, sin)
    attention._attend_core = recording
    return seen


def mesh_train(rank, world, out, checks, ckpts: dict, loop_kw: dict,
               strategies: tuple, archs: tuple):
    """Reduced archs trained on a 2 x 2 mesh under each strategy from the
    state in ``ckpts[arch]`` (step 0); the head_dim fallback on a 1 x 4
    mesh; a crash at step 1 resumed onto a 1 x 2 plan."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.runtime.elastic import plan_for_devices
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import build_model

    seen = _record_attention_shards()
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
    for arch in archs:
        for strategy in strategies:
            def run(arch=arch, strategy=strategy):
                seen.clear()
                got = train_run(mesh_config(arch), mesh22,
                                dict(loop_kw, strategy=strategy),
                                ckpt=ckpts[arch])
                got["attn_shapes"] = sorted(set(seen))
                return got
            checks(f"{arch}/{strategy}", run)

    def recompute_outside_scope():
        """The loss taken in the scope, its gradient outside: every
        checkpointed layer is recomputed outside the caller's scope (as on
        the card, where the autograd engine's thread has none)."""
        from torch.distributed.tensor import Replicate

        from repro_torch.models.common import leaves
        from repro_torch.sharding.context import activation_sharding
        from repro_torch.sharding.rules import distribute_tree, tree_shardings
        from repro_torch.train.step import _rebuild

        model = build_model(mesh_config("smollm-360m", remat=True,
                                        remat_groups=1))
        params = distribute_tree(model.init(0, "cpu"), mesh22, tree_shardings(
            model.param_axes(), mesh22, "2d", model.abstract()))
        shape = ShapeConfig("t", 16, 4, "train")
        batch = distribute_tree(
            model.make_batch(shape, 0, "cpu"), mesh22, tree_shardings(
                model.input_axes(shape), mesh22, "2d",
                model.abstract_inputs(shape)))

        def grads(outside: bool):
            flat = [p.detach().requires_grad_() for p in leaves(params)]
            with activation_sharding(mesh22, "2d"):
                loss = model.loss(_rebuild(params, flat), batch)[0]
                loss = loss.redistribute(mesh22, [Replicate()] * 2)
                if not outside:
                    return [g.full_tensor() for g in
                            torch.autograd.grad(loss, flat)]
            return [g.full_tensor() for g in torch.autograd.grad(loss, flat)]
        inside, outside = grads(False), grads(True)
        return {"equal": all(torch.equal(a, b)
                             for a, b in zip(inside, outside)),
                "leaves": len(inside)}
    checks("recompute_outside_scope", recompute_outside_scope)

    # 2 KV heads on model axis 4: the KV heads cannot shard, head_dim does
    mesh14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data",
                                                             "model"))

    def fallback():
        from repro_torch.models.common import logical_axes
        from repro_torch.sharding.rules import tree_shardings

        cfg = mesh_config("smollm-360m", **FALLBACK)
        pl = tree_shardings(logical_axes(build_model(cfg).specs), mesh14,
                            "2d", build_model(cfg).abstract())
        seen.clear()
        got = train_run(cfg, mesh14, dict(loop_kw, strategy="2d"),
                        ckpt=ckpts["fallback"])
        got["attn_shapes"] = sorted(set(seen))
        got["wk"] = tuple(pl["blocks"]["attn"]["wk"])
        return got
    checks("head_dim_fallback", fallback)

    # crash after step 1 on 2 x 2, resume on ranks [0, 1] as 1 x 2
    def crash_and_resume():
        arch = archs[0]
        cdir = str(out / "crash")
        kw = dict(loop_kw, strategy="2d", checkpoint_every=1)
        try:
            train_run(mesh_config(arch), mesh22, kw, ckpt=cdir,
                      crash_at_step=1)
        except RuntimeError as exc:
            assert "injected crash" in str(exc)
        dist.barrier()                       # the checkpoint is on disk
        plan = plan_for_devices([0, 1], build_model(mesh_config(arch)),
                                ShapeConfig("t", loop_kw["seq_len"],
                                            loop_kw["batch"], "train"),
                                "2d", device_type="cpu")
        if plan.mesh.get_coordinate() is None:
            return {"sat_out": True}
        got = train_run(mesh_config(arch), plan.mesh, kw, ckpt=cdir)
        got["mesh"] = tuple(plan.mesh.shape)
        return got
    checks("crash_resume", crash_and_resume)


def elastic(rank, world, out, checks, loop_kw: dict):
    """Reduced smollm's train state on a 2 x 2 plan, resharded onto ranks
    [0, 1]."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.elastic import plan_for_devices, reshard_state
    from repro_torch.train.step import init_train_state

    def run():
        from torch.distributed.tensor import DTensor

        model = build_model(mesh_config("smollm-360m"))
        shape = ShapeConfig("t", loop_kw["seq_len"], loop_kw["batch"],
                            "train")
        state = init_train_state(model, 0, "cpu")
        ref = _arrays(state)
        plan4 = plan_for_devices(list(range(4)), model, shape, "2d",
                                 model_axis=2, device_type="cpu")
        state4 = reshard_state(state, plan4)
        plan2 = plan_for_devices([0, 1], model, shape, "2d",
                                 device_type="cpu")
        state2 = reshard_state(state4, plan2)
        held = sum(int(x.to_local().numel()) for x in _leaves(state2)
                   if isinstance(x, DTensor))
        after = _arrays(state2) if plan2.mesh.get_coordinate() is not None \
            else None
        return {"ref": ref if rank == 0 else None, "after": after,
                "held": held, "mesh": tuple(plan2.mesh.shape),
                "in_mesh": plan2.mesh.get_coordinate() is not None}
    checks("reshard", run)


def checkpoint_on_mesh(rank, world, out, checks):
    """A DTensor train state saved from a 1 x 2 mesh (gathered, rank 0
    writes) and restored onto its placements."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import ShapeConfig  # noqa: F401
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.rules import distribute_tree, tree_shardings
    from repro_torch.train.step import (abstract_train_state,
                                        init_train_state, train_state_axes)

    def run():
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data",
                                                               "model"))
        model = build_model(mesh_config("smollm-360m"))
        pl = tree_shardings(train_state_axes(model), mesh, "2d",
                            abstract_train_state(model))
        state = distribute_tree(init_train_state(model, 0, "cpu"), mesh, pl)
        mgr = CheckpointManager(out / "ck", async_save=(rank == 0))
        mgr.save(3, state, {"loss": 1.0})
        mgr.wait()
        dist.barrier()
        files = sorted(p.name for p in (out / "ck").iterdir())
        step, back = mgr.restore(placements=pl, mesh=mesh)
        _, plain = mgr.restore(step)
        want, got = _by_path(state), _by_path(back)
        same = sorted(want) == sorted(got) and all(
            torch.equal(a.to_local(), got[k].to_local())
            and a.placements == got[k].placements for k, a in want.items())
        return {"files": files, "step": step, "same": same,
                "dtensor": all(isinstance(x, DTensor) for x in _leaves(back)),
                "plain_device": {str(x.device) for x in _leaves(plain)},
                "sharded_local": tuple(back["params"]["embed"].to_local()
                                       .shape),
                "full": tuple(plain["params"]["embed"].shape)}
    checks("save_restore", run)


def dp_grad(rank, world, out, checks):
    """The explicit-DP gradient on a 4-rank ("data",) mesh: the reference's
    two tests (uncompressed against one device; compressed + EF
    converging)."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.train.grad import init_error_state, make_dp_grad_fn

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))

    def uncompressed():
        rng = np.random.default_rng(0)
        W = torch.tensor(rng.normal(size=(16, 4)), dtype=torch.float32)
        X = torch.tensor(rng.normal(size=(32, 16)), dtype=torch.float32)
        y = torch.tensor(rng.normal(size=(32, 4)), dtype=torch.float32)

        def loss_fn(params, batch):
            xb, yb = batch
            return ((xb @ params - yb) ** 2).mean(), {}

        fn = make_dp_grad_fn(loss_fn, mesh, compress=False)
        loss, grads, _ = fn(W, (X, y), init_error_state(W))
        Wg = W.clone().requires_grad_()
        ref_loss = loss_fn(Wg, (X, y))[0]
        (ref,) = torch.autograd.grad(ref_loss, Wg)
        return {"diff": float((grads - ref).abs().max()),
                "grads": grads.numpy().copy(),
                "loss": float(loss), "ref_loss": float(ref_loss)}
    checks("uncompressed", uncompressed)

    def compressed():
        rng = np.random.default_rng(0)
        Wtrue = rng.normal(size=(8, 1)).astype(np.float32)
        Xn = rng.normal(size=(64, 8)).astype(np.float32)
        X = torch.tensor(Xn)
        y = torch.tensor(Xn @ Wtrue)
        W = torch.zeros(8, 1)

        def loss_fn(p, b):
            return ((b[0] @ p - b[1]) ** 2).mean(), {}

        fn = make_dp_grad_fn(loss_fn, mesh, compress=True,
                             error_feedback=True)
        err = init_error_state(W)
        losses = []
        for _ in range(150):
            loss, g, err = fn(W, (X, y), err)
            W = W - 0.1 * g
            losses.append(float(loss))
        return {"first": losses[0], "last": losses[-1]}
    checks("compressed", compressed)

    def psums():
        from repro_torch.train.grad import compressed_psum, psum_tree

        x = torch.tensor(np.random.default_rng(rank).normal(size=(5, 3)) *
                         (rank + 1), dtype=torch.float32)
        group = mesh.get_group("data")
        return {"compressed": compressed_psum(x, group).numpy().copy(),
                "plain": psum_tree({"x": x}, group)["x"].numpy().copy(),
                "tree": psum_tree({"x": x, "y": [x * 2]}, group,
                                  compress=True)["y"][0].numpy().copy()}
    checks("psum", psums)


def pipeline(rank, world, out, checks):
    """GPipe over ("stage", "mdl") = (2, 2), 6 microbatches, against the
    sequential stack."""
    from torch.distributed.device_mesh import init_device_mesh

    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import distribute
    from repro_torch.train.pipeline import pipeline_forward, split_stages

    def run():
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("stage",
                                                               "mdl"))
        rng = np.random.default_rng(0)
        L, d = 8, 16
        Ws = torch.tensor(rng.normal(size=(L, d, d)) * (1.0 / np.sqrt(d)),
                          dtype=torch.float32)

        def stage_fn(wstack, x):
            for w in wstack:
                x = torch.tanh(x @ w)
            return x

        M, mb = 6, 4
        xs = torch.tensor(rng.normal(size=(M, mb, d)), dtype=torch.float32)
        pipe = pipeline_forward(mesh, "stage", stage_fn, M)
        y = pipe(split_stages(Ws, 2), xs)
        # the stages as a DTensor sharded over the stage axis: each rank
        # holds its own stage's layers only
        staged = distribute(split_stages(Ws, 2), mesh,
                            (Shard(0), Replicate()))
        y_sharded = pipe(staged, xs)
        return {"y": y.numpy().copy(), "xs": xs.numpy().copy(),
                "Ws": Ws.numpy().copy(), "y_sharded": y_sharded.numpy(),
                "local_layers": tuple(staged.to_local().shape)}
    checks("forward", run)


def launcher_families(rank, world, out, checks, archs: tuple):
    """``train_main`` on 2 ranks with model axis 2, one step of each
    reduced arch in ``archs``."""
    from repro_torch.launch.train import main as train_main

    for arch in archs:
        def run(arch=arch):
            got = train_main(["--arch", arch, "--reduced", "--device", "cpu",
                              "--model-axis", "2", "--steps", "1"])
            return {"mesh": got["mesh"], "backend": got["backend"],
                    "losses": got["losses"],
                    "dtensor": all(type(p).__name__ == "DTensor" for p in
                                   _leaves(got["state"]["params"]))}
        checks(arch, run)


def _record_drops():
    """Patch the MoE's ``dispatch_slots`` to record the keep mask of every
    routing choice it ranks; returns the list it appends to."""
    from repro_torch.models import moe

    seen = []
    slots = moe.dispatch_slots

    def recording(e_idx, n_experts, cap):
        keep, slot = slots(e_idx, n_experts, cap)
        seen.append(keep.numpy().copy())
        return keep, slot
    moe.dispatch_slots = recording
    return seen


def mesh_families(rank, world, out, checks, ckpts: dict, runs: dict,
                  serve: tuple = ()):
    """Reduced archs trained on a 2 x 2 mesh from the state in
    ``ckpts[name]``: ``runs[name]`` is (arch, config overrides, loop
    overrides, strategies). The MoE's keep masks are recorded. Then each
    reduced arch of ``serve`` served in float64 on the mesh under ``2d``
    (``serve_run``)."""
    from torch.distributed.device_mesh import init_device_mesh

    drops = _record_drops()
    mesh22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
    for name, (arch, overrides, loop_kw, strategies) in runs.items():
        for strategy in strategies:
            def run(arch=arch, overrides=overrides, loop_kw=loop_kw,
                    strategy=strategy, name=name):
                drops.clear()
                got = train_run(mesh_config(arch, **overrides), mesh22,
                                dict(loop_kw, strategy=strategy),
                                ckpt=ckpts[name])
                got["keep"] = list(drops)
                return got
            checks(f"{name}/{strategy}", run)
    for arch in serve:
        checks(f"serve/{arch}", lambda arch=arch: serve_run(
            mesh_config(arch, dtype="float64"), mesh22))


def _placement(code: str):
    from torch.distributed.tensor import Replicate, Shard

    return Replicate() if code == "R" else Shard(int(code[1:]))


def project_cases(rank, world, out, checks, cases: dict):
    """``sharding.context.project`` on a 2 x 2 mesh in float64 under torch
    2.11's view rule (tests/_mesh_cells.py): for each case, x (4, 8, 6)
    and w (6, 10) placed by its codes ("R", "S0", ...; one per mesh
    dimension), and, where it has third codes, a zero tensor so placed
    added to the product (DTensor's rule for the sum moves the product
    there, and its gradient comes back so placed); the loss is
    sum(y * g). The product and the gradients of x and w, whole."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from _mesh_cells import view_rule_2_11
    from repro_torch.sharding.context import project

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x0, w0, g0 = project_inputs()
    y0 = x0 @ w0
    for name, (x_pl, w_pl, y_pl) in cases.items():
        def run(x_pl=x_pl, w_pl=w_pl, y_pl=y_pl):
            x = distribute_tensor(x0, mesh, [_placement(c) for c in x_pl])
            w = distribute_tensor(w0, mesh, [_placement(c) for c in w_pl])
            x.requires_grad_()
            w.requires_grad_()
            with view_rule_2_11():
                y = project(x, w)
                if y_pl:
                    y = y + distribute_tensor(torch.zeros_like(y0), mesh, [
                        _placement(c) for c in y_pl])
                y = y.full_tensor()
                gx, gw = torch.autograd.grad((y * g0).sum(), (x, w))
            return {"y": y.detach().numpy(), "gx": gx.full_tensor().numpy(),
                    "gw": gw.full_tensor().numpy()}
        checks(name, run)


def project_inputs():
    """x (4, 8, 6), w (6, 10) and the loss's weights g (4, 8, 10), float64,
    from numpy's generator at seed 0."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(s))
                 for s in ((4, 8, 6), (6, 10), (4, 8, 10)))


# context-parallel attention (models/attention.py::_on_key_shards): F1's
# reduced smollm-360m (3 query heads over 1 KV head, so that neither count
# divides the model axis of 2 and K/V shard the sequence), in float64, one
# attention layer on x (CP_BATCH, CP_SEQ, d) from numpy's generator
CP_OVERRIDES = dict(n_heads=3, n_kv_heads=1, dtype="float64")
CP_STRATEGIES = ("2d", "tp", "zero3", "sp")
CP_BATCH, CP_SEQ = 4, 16
CP_RTOL = 1e-9


def attention_run(mesh, strategy: str = "2d", seed: int = 0) -> dict:
    """One attention layer of CP_OVERRIDES's config, its weights and x
    placed by ``strategy``'s rules on ``mesh`` (None: one device):
    ``attend_train`` through B2 (its plain version here) and through the
    plain ``_sdpa``, each with the gradients of x and of the weights under
    the loss sum(out * g), and ``attend_prefill``'s output, K and V; all
    whole, float64 numpy, with the placements of the prefill's K."""
    from repro_torch.models.attention import (attend_prefill, attend_train,
                                              attn_specs)
    from repro_torch.models.common import (init_params, logical_axes,
                                           rope_cos_sin, tree_map)
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import (STRATEGIES, distribute,
                                            distribute_tree, placements,
                                            spec_for_axes, tree_shardings)

    cfg = mesh_config("smollm-360m", **CP_OVERRIDES)
    specs = attn_specs(cfg)
    params = tree_map(lambda _, t: t.double(), init_params(specs, seed, "cpu"))
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((CP_BATCH, CP_SEQ,
                                              cfg.d_model)))
    g = torch.from_numpy(rng.standard_normal(x.shape))
    pos = torch.arange(CP_SEQ)[None].expand(CP_BATCH, CP_SEQ)
    cos, sin = rope_cos_sin(pos, cfg.resolved_head_dim, cfg.rope_theta)
    scope = contextlib.nullcontext()
    if mesh is not None:
        params = distribute_tree(params, mesh, tree_shardings(
            logical_axes(specs), mesh, strategy, params))
        x = distribute(x, mesh, placements(spec_for_axes(
            ("act_batch", "act_seq", "act_embed"), STRATEGIES[strategy],
            mesh, tuple(x.shape)), mesh))
        scope = activation_sharding(mesh, strategy)
    out = {}
    with scope:
        for name, c in (("train", cfg), ("train_plain",
                                         replace(cfg, use_pallas=False))):
            w = {k: t.detach().requires_grad_() for k, t in params.items()}
            xg = x.detach().requires_grad_()
            y = _full(attend_train(c, w, xg, cos, sin))
            grads = torch.autograd.grad((y * g).sum(), [xg, *w.values()])
            out[name] = {"out": _whole(y), "grads": dict(zip(
                ["x", *w], (_whole(t) for t in _full(grads))))}
        with torch.no_grad():
            y, (k, v) = attend_prefill(cfg, params, x, cos, sin)
        out["prefill"] = _whole({"out": y, "k": k, "v": v})
        out["prefill_k_placements"] = [str(p) for p in
                                       getattr(k, "placements", ())]
    return out


def context_parallel(rank, world, out, checks, strategies: tuple):
    """``attention_run`` on a 2 x 2 ("data", "model") mesh under each
    strategy."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for strategy in strategies:
        checks(strategy, lambda strategy=strategy: attention_run(mesh,
                                                                  strategy))


def context_parallel_apart(got: dict, want: dict) -> dict:
    """{array path: its largest |got - want| in units of CP_RTOL (|want| +
    the array's largest |want|)}: each must be at most 1."""
    runs = ("train", "train_plain", "prefill")
    a = _by_path({k: got[k] for k in runs})
    b = _by_path({k: want[k] for k in runs})
    if sorted(a) != sorted(b):
        raise ValueError(f"arrays {sorted(a)} against {sorted(b)}")
    out = {}
    for k, w in b.items():
        w = np.asarray(w, dtype=np.float64)
        tol = (CP_RTOL * (np.abs(w) + np.abs(w).max())
               + np.finfo(np.float64).tiny)
        out[k] = float((np.abs(np.asarray(a[k]) - w) / tol).max())
    return out


# the LM loss on vocabulary shards (sharding/context.py::cross_entropy_on_
# shards): logits (LOSS_BATCH, LOSS_SEQ, V) and labels from numpy's
# generator, for each vocabulary size; a size the model axis of 2 divides,
# 49155 (granite-moe-3b-a800m's, which it does not) and 7 (shards of 4 and
# 3); the labels hit the first and last index and both sides of the shard
# boundary
LOSS_BATCH, LOSS_SEQ = 4, 6
LOSS_VOCABS = (64, 49155, 7)
LOSS_Z = (1e-4, 0.0, 0.1)


def loss_inputs(vocab: int, seed: int = 0):
    """logits (float64) and labels (int64) as numpy arrays; the labels'
    first four are 0, V - 1 and the last of the first shard and the first
    of the second (torch's chunking: ceil(V / 2) rows first)."""
    rng = np.random.default_rng(seed + vocab)
    logits = 3.0 * rng.standard_normal((LOSS_BATCH, LOSS_SEQ, vocab))
    labels = rng.integers(0, vocab, (LOSS_BATCH, LOSS_SEQ))
    first = -(-vocab // 2)
    labels.reshape(-1)[:4] = (0, vocab - 1, first - 1, first)
    return logits, labels


def loss_run(logits, labels, z_loss: float, mesh=None, logits_pl=None,
             labels_pl=None, partial_over=None) -> dict:
    """``cross_entropy_loss`` and the logits' gradient (both whole numpy),
    the logits placed by ``logits_pl`` on ``mesh`` (None: one device);
    ``partial_over`` a mesh dimension over which the logits arrive as a
    partial sum (each rank a share, the last rank the remainder), on the
    placements ``logits_pl`` gives elsewhere. Also the placements the
    gradient came back with."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)

    from repro_torch.models.common import cross_entropy_loss

    x = torch.from_numpy(logits)
    y = torch.from_numpy(labels)
    if mesh is not None:
        pl = list(logits_pl)
        if partial_over is None:
            x = distribute_tensor(x, mesh, pl)
        else:
            n = mesh.size(partial_over)
            me = mesh.get_local_rank(partial_over)
            share = x / n if me < n - 1 else x - (n - 1) * (x / n)
            pl[partial_over] = Replicate()
            local = distribute_tensor(share, mesh, pl).to_local()
            pl[partial_over] = Partial()
            x = DTensor.from_local(local, mesh, pl, run_check=False)
        y = distribute_tensor(y, mesh, list(labels_pl))
    x = x.detach().requires_grad_()
    loss = cross_entropy_loss(x, y, z_loss)
    g, = torch.autograd.grad(loss, x)
    out = {"loss": _whole(loss), "grad": _whole(g)}
    out["grad_pl"] = [str(p) for p in getattr(g, "placements", ())]
    return out


def loss_shards(rank, world, out, checks, cases: dict):
    """``loss_run`` on a 2 x 2 ("data", "model") mesh for each case: name ->
    (vocab, dtype name, z_loss, logits placements, labels placements,
    partial_over), the placements as codes ("R", "S0", ...)."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, (vocab, dtype, z, x_pl, y_pl, partial) in cases.items():
        def run(vocab=vocab, dtype=dtype, z=z, x_pl=x_pl, y_pl=y_pl,
                partial=partial):
            logits, labels = loss_inputs(vocab)
            return loss_run(logits.astype(dtype), labels, z, mesh,
                            [_placement(c) for c in x_pl],
                            [_placement(c) for c in y_pl], partial)
        checks(name, run)


def rows_run(vocab: int, mesh=None, table_pl=None, tokens_pl=None) -> dict:
    """``embedding_rows`` of a float64 table (vocab, 6) for tokens
    (LOSS_BATCH, LOSS_SEQ) that hit its first and last rows and both sides
    of a shard boundary, and the table's gradient under the loss
    sum(rows * g); both whole numpy. The table and the tokens placed by
    the codes on ``mesh`` (None: one device)."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.context import embedding_rows, on_mesh

    rng = np.random.default_rng(vocab)
    table = torch.from_numpy(rng.standard_normal((vocab, 6)))
    tokens = torch.from_numpy(rng.integers(0, vocab, (LOSS_BATCH, LOSS_SEQ)))
    first = -(-vocab // 2)
    tokens.view(-1)[:4] = torch.tensor((0, vocab - 1, first - 1, first))
    g = torch.from_numpy(rng.standard_normal((LOSS_BATCH, LOSS_SEQ, 6)))
    if mesh is not None:
        table = distribute_tensor(table, mesh,
                                  [_placement(c) for c in table_pl])
        tokens = distribute_tensor(tokens, mesh,
                                   [_placement(c) for c in tokens_pl])
        g = on_mesh(g, mesh)
    table.requires_grad_()
    rows = embedding_rows(table, tokens)
    grad, = torch.autograd.grad((rows * g).sum(), table)
    return {"rows": _whole(rows), "grad": _whole(grad)}


def rows_shards(rank, world, out, checks, cases: dict):
    """``rows_run`` on a 2 x 2 ("data", "model") mesh for each case: name ->
    (vocab, table codes, tokens codes)."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    for name, (vocab, table_pl, tokens_pl) in cases.items():
        checks(name, lambda v=vocab, a=table_pl, b=tokens_pl: rows_run(
            v, mesh, a, b))


def pod_mesh(rank, world, out, checks, ckpts: dict, loop_kw: dict,
             archs: tuple):
    """Reduced archs in float64 on a (2, 1, 2) ("pod", "data", "model")
    mesh under ``2d``: trained from the state in ``ckpts[arch]``
    (``train_run``) and served (``serve_run``)."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (2, 1, 2),
                            mesh_dim_names=("pod", "data", "model"))
    for arch in archs:
        cfg = mesh_config(arch, dtype="float64")
        checks(f"train/{arch}", lambda arch=arch, cfg=cfg: train_run(
            cfg, mesh, dict(loop_kw, strategy="2d"), ckpt=ckpts[arch]))
        checks(f"serve/{arch}", lambda cfg=cfg: serve_run(cfg, mesh))
