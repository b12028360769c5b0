"""The port's training path (``repro_torch.train``, ``data``,
``checkpoint``, ``runtime``, ``launch.train``, ``models.zamba.zamba_loss``)
against the reference, at ``reduced(zamba2-2.7b)`` in float32 (4 layers,
d_model 64, state 16).

Both frameworks get the same parameters: the reference's ``init`` with its
zero/one-initialized leaves perturbed by seeded numpy noise (as in
tests/test_torch_zamba.py), carried across by ``lm_params_from_arrays``.
The reference cannot differentiate through its Pallas kernels, so the
gradient oracle is its jnp path (``use_pallas=False``); the port runs with
``use_pallas`` on and off (on the CPU the kernels' plain versions, through
their autograd.Functions) and with activation checkpointing on and off.
Tolerance across frameworks in float32, as in tests/test_torch_zamba.py:
rtol 1e-4 plus an atol of 1e-4 of each tensor's largest magnitude."""
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.configs.base import ShapeConfig as RShape
from repro.data.synthetic import SyntheticLM as RSyntheticLM
from repro.models.registry import build_model as r_build
from repro.train import optimizer as r_opt
from repro.train.step import make_train_step as r_make_train_step
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import (lm_params_from_arrays,
                                      train_state_from_arrays, tree_to_arrays)
from repro_torch.data import DataPipeline, SyntheticLM
from repro_torch.kernels import watch
from repro_torch.launch.train import main as train_main
from repro_torch.models.common import leaves, tree_map
from repro_torch.models.registry import build_model
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import TrainLoopConfig, run_training
from repro_torch.train.step import loss_and_grads, make_train_step

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
CFG = reduced(get_config("zamba2-2.7b"))
R_CFG = r_reduced(R_ARCHS["zamba2-2.7b"])
# float32 on both sides with the same formulas; the global norm sums in
# another order and a multiply-add may be fused on one side, so results
# differ by a few float32 ulps (1.2e-7 each) of the largest entry
OPT_TOL = 1e-6


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _paths(tree):
    """[(path of keys, numpy leaf)] of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(p.key for p in path), np.asarray(a)) for path, a in flat]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def params():
    """Reference parameters (numpy), with the constant leaves perturbed."""
    tree = jax.tree.map(np.asarray, r_build(R_CFG).init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    paths, treedef = jax.tree_util.tree_flatten_with_path(tree)

    def perturb(path, a):
        name = str(path[-1].key)
        if name in ("q_b", "gate_b"):
            return a + 0.02 * rng.normal(size=a.shape).astype(np.float32)
        if name in ("a_log", "dt_bias", "conv_b"):
            return a + 0.3 * rng.normal(size=a.shape).astype(np.float32)
        if name in ("d_skip", "out_norm", "ln", "ln1", "ln2", "ln_f"):
            return a + 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_unflatten(
        treedef, [perturb(p, a) for p, a in paths])


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("vocab,seed", [(128, 0), (32000, 3)])
def test_synthetic_batches_equal_reference(vocab, seed):
    ref, port = RSyntheticLM(vocab, seed=seed), SyntheticLM(vocab, seed=seed)
    np.testing.assert_array_equal(port.successor, ref.successor)
    for index in (0, 1, 7):
        want, got = ref.batch(index, 3, 40), port.batch(index, 3, 40)
        assert sorted(got) == ["labels", "tokens"]
        for name in got:
            assert got[name].dtype == np.int32
            np.testing.assert_array_equal(got[name], want[name])


def test_pipeline_replays_the_stream_from_any_index():
    gen = SyntheticLM(vocab=64, seed=3)
    pipe = DataPipeline(gen, 4, 16, device="cpu", start_index=2)
    try:
        got = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    assert [i for i, _ in got] == [2, 3, 4]
    for i, batch in got:
        want = gen.batch(i, 4, 16)
        for name, t in batch.items():
            assert t.dtype == torch.int32 and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), want[name])


def test_pipeline_raises_what_the_worker_raised():
    class Broken(SyntheticLM):
        def batch(self, index, batch, seq_len):
            raise ValueError("no data")
    pipe = DataPipeline(Broken(vocab=8), 2, 4, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="batch 0 failed"):
            next(pipe)
    finally:
        pipe.close()


# ---------------------------------------------------------------- optimizer

def _tree(rng, shapes, positive=False):
    return {k: np.abs(rng.normal(size=s)).astype(np.float32) if positive
            else rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}


SHAPES = {"w": (3, 4, 5), "b": (7,), "stacked_norm": (2, 3, 6), "s": ()}


def test_schedule_matches_reference():
    for cfg in (opt.OptConfig(), opt.OptConfig(warmup_steps=0, total_steps=7),
                opt.OptConfig(lr=3e-3, warmup_steps=5, total_steps=30)):
        rcfg = r_opt.OptConfig(**vars(cfg))
        for step in range(0, cfg.total_steps + 3, max(cfg.total_steps // 9, 1)):
            want = r_opt.schedule(rcfg, jnp.asarray(step, jnp.int32))
            got = opt.schedule(cfg, torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=OPT_TOL)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_update_matches_reference(clip_norm):
    """One update from a state with nonzero moments at step 3: new params,
    moments, step, grad norm and lr. Weight decay reaches every leaf with
    more than one dimension, as in the reference (so the stacked norm
    weights decay too)."""
    rng = np.random.default_rng(1)
    p, g = _tree(rng, SHAPES), _tree(rng, SHAPES)
    g = {k: v * 3 for k, v in g.items()}
    m, v = _tree(rng, SHAPES), _tree(rng, SHAPES, positive=True)
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        clip_norm=clip_norm)
    rp, rs, rmet = r_opt.adamw_update(
        r_opt.OptConfig(**vars(cfg)), jax.tree.map(jnp.asarray, p),
        jax.tree.map(jnp.asarray, g),
        {"m": jax.tree.map(jnp.asarray, m), "v": jax.tree.map(jnp.asarray, v),
         "step": jnp.asarray(3, jnp.int32)})
    tp = {k: torch.tensor(a) for k, a in p.items()}
    state = {"m": {k: torch.tensor(a) for k, a in m.items()},
             "v": {k: torch.tensor(a) for k, a in v.items()},
             "step": torch.tensor(3, dtype=torch.int32)}
    met = opt.adamw_update(cfg, tp, {k: torch.tensor(a) for k, a in g.items()},
                           state)
    assert int(state["step"]) == 4 and state["step"].dtype == torch.int32
    for k in SHAPES:
        _close(tp[k], rp[k], OPT_TOL, f"param {k}")
        _close(state["m"][k], rs["m"][k], OPT_TOL, f"m {k}")
        _close(state["v"][k], rs["v"][k], OPT_TOL, f"v {k}")
    _close(met["grad_norm"], rmet["grad_norm"], OPT_TOL, "grad_norm")
    _close(met["lr"], rmet["lr"], OPT_TOL, "lr")


def test_clip_by_global_norm_matches_reference():
    g = _tree(np.random.default_rng(2), SHAPES)
    want, wnorm = r_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    got, norm = opt.clip_by_global_norm(
        {k: torch.tensor(a) for k, a in g.items()}, 0.5)
    _close(norm, wnorm, OPT_TOL)
    for k in SHAPES:
        _close(got[k], want[k], OPT_TOL, k)
    # under the limit nothing moves
    small, _ = opt.clip_by_global_norm({"w": torch.ones(3)}, 10.0)
    assert torch.equal(small["w"], torch.ones(3))


def test_adamw_minimizes_quadratic_and_keeps_moment_dtype():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = opt.init_opt_state(params)
    cfg = opt.OptConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                        total_steps=150, clip_norm=100.0)
    for _ in range(150):
        opt.adamw_update(cfg, params, {"w": 2 * params["w"]}, state)
    assert params["w"].abs().max() < 0.1
    params = {"w": torch.ones(4)}
    state = opt.init_opt_state(params, moment_dtype="bfloat16")
    opt.adamw_update(opt.OptConfig(), params, {"w": torch.ones(4)}, state)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["v"]["w"].dtype == torch.float32
    assert torch.isfinite(params["w"]).all()


# ------------------------------------------------------------ loss and grads

def _ref_loss_grads(params, seq_len: int):
    rm = r_build(R_CFG)
    batch = rm.make_batch(RShape("t", seq_len, 2, "train"), seed=2)
    (loss, _), grads = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, batch)
    return loss, grads


def _port_loss_grads(params, seq_len: int, **cfg):
    pm = build_model(replace(CFG, **cfg))
    pp = lm_params_from_arrays(pm.specs, params, device="cpu")
    batch = pm.make_batch(ShapeConfig("t", seq_len, 2, "train"), seed=2,
                          device="cpu")
    loss, grads = loss_and_grads(pm, pp, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    assert pm.loss(pp, batch)[1] == {}
    it = iter(grads)
    return loss, tree_map(lambda _, __: next(it), pp)


def _close_grads(got, want):
    checked = 0
    for path, a in _paths(want):
        _close(_at(got, path), a, what="/".join(path))
        checked += 1
    assert checked == len(leaves(got))


@pytest.fixture(scope="module")
def ref_loss_grads(params):
    return _ref_loss_grads(params, 16)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(params, ref_loss_grads,
                                                 use_pallas, remat):
    r_loss, r_grads = ref_loss_grads
    loss, grads = _port_loss_grads(params, 16, use_pallas=use_pallas,
                                   remat=remat)
    _close(loss, r_loss, what="loss")
    _close_grads(grads, r_grads)


def _ssd_chunked_masked(x, alog, B, C, h0, chunk: int):
    """The reference's ``models/mamba2.py::_ssd_chunked_jnp`` with one
    change: the upper triangle of the decay matrix is masked BEFORE
    ``exp`` (as the port's ``ssd_chunked`` and both kernels do), so an
    overflow there cannot turn into ``inf * 0 = NaN`` in the gradient."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
        alog = jnp.pad(alog, ((0, 0), (0, pad), (0, 0)))
        B = jnp.pad(B, ((0, 0), (0, pad), (0, 0)))
        C = jnp.pad(C, ((0, 0), (0, pad), (0, 0)))
    nck = x.shape[1] // chunk
    xc = x.reshape(b, nck, chunk, H, P).astype(jnp.float32)
    ac = alog.reshape(b, nck, chunk, H).astype(jnp.float32)
    Bc = B.reshape(b, nck, chunk, N).astype(jnp.float32)
    Cc = C.reshape(b, nck, chunk, N).astype(jnp.float32)
    cs = jnp.cumsum(ac, axis=2)
    tri = jnp.tril(jnp.ones((chunk, chunk), bool))[None, None, :, :, None]
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]
    Lmat = jnp.exp(jnp.where(tri, diff, -jnp.inf))
    G = jnp.einsum("bnsj,bntj->bnst", Cc, Bc)
    y_intra = jnp.einsum("bnsth,bnthp->bnshp", G[:, :, :, :, None] * Lmat, xc)
    decay_end = jnp.exp(cs[:, :, -1:, :] - cs)
    chunk_in = jnp.einsum("bntj,bnth,bnthp->bnhjp", Bc, decay_end, xc)
    chunk_decay = jnp.exp(cs[:, :, -1, :])

    def carry_step(h, t):
        cin, cdec = t
        return cdec[:, :, None, None] * h + cin, h

    h_fin, h_in = jax.lax.scan(
        carry_step, h0.astype(jnp.float32),
        (jnp.moveaxis(chunk_in, 1, 0), jnp.moveaxis(chunk_decay, 1, 0)))
    h_in = jnp.moveaxis(h_in, 0, 1)
    y_inter = jnp.einsum("bnsj,bnsh,bnhjp->bnshp", Cc, jnp.exp(cs), h_in)
    y = (y_intra + y_inter).reshape(b, nck * chunk, H, P)[:, :S]
    return y.astype(x.dtype), h_fin


def test_reference_gradient_is_nan_where_the_decay_overflows(params,
                                                             monkeypatch):
    """A behaviour of the reference, not of the port: its jnp chunked SSD
    takes ``exp`` of the whole decay matrix and masks the upper triangle
    afterwards, so once a chunk's log-decay sums past float32's exp range
    (here at S = 24) the forward pass is still right but ``jax.grad`` gives
    NaN in every leaf. The port masks before ``exp``: its gradients stay
    finite and equal the reference's with that one line changed."""
    _, r_grads = _ref_loss_grads(params, 24)
    assert not all(np.isfinite(a).all() for _, a in _paths(r_grads))
    import repro.models.mamba2 as r_mamba2
    monkeypatch.setattr(r_mamba2, "_ssd_chunked_jnp", _ssd_chunked_masked)
    r_loss, r_grads = _ref_loss_grads(params, 24)
    assert all(np.isfinite(a).all() for _, a in _paths(r_grads))
    loss, grads = _port_loss_grads(params, 24, use_pallas=True, remat=True)
    _close(loss, r_loss, what="loss")
    _close_grads(grads, r_grads)


def test_remat_recomputes_each_kernel_call(params):
    """How often one step calls each kernel wrapper, as ``chip_smoke.py``
    asserts on the card: without remat once per layer and microbatch; with
    the nested checkpoints the group body runs again in the backward pass
    (attention twice, Mamba twice) and each Mamba layer once more inside it
    (three times)."""
    G = CFG.n_layers // CFG.shared_attn_every
    for remat, per_mb in ((False, (G, CFG.n_layers)),
                          (True, (2 * G, 3 * CFG.n_layers))):
        pm = build_model(replace(CFG, use_pallas=True, remat=remat,
                                 microbatches=2))
        state = {"params": lm_params_from_arrays(pm.specs, params,
                                                 device="cpu")}
        state["opt"] = opt.init_opt_state(state["params"])
        step = make_train_step(pm, opt.OptConfig(), n_microbatches=2)
        batch = pm.make_batch(ShapeConfig("t", 16, 4, "train"), seed=1,
                              device="cpu")
        calls = {"flash_attention": 0, "ssd_scan": 0}

        def count(name, inputs, output):
            calls[name] += 1
        with watch.watching(count):
            step(state, batch)
        assert calls == {"flash_attention": 2 * per_mb[0],
                         "ssd_scan": 2 * per_mb[1]}, (remat, calls)


def test_train_step_matches_reference(params, monkeypatch):
    """One whole step with 2 microbatches (gradients accumulated in f32):
    loss, grad norm, lr, then params and both moments. The decay of this
    batch overflows in the reference's exp-then-mask (see the test above),
    so the reference runs with the mask moved before ``exp``."""
    import repro.models.mamba2 as r_mamba2
    monkeypatch.setattr(r_mamba2, "_ssd_chunked_jnp", _ssd_chunked_masked)
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    rm = r_build(replace(R_CFG, microbatches=2))
    r_step = jax.jit(r_make_train_step(rm, r_opt.OptConfig(**vars(ocfg)),
                                       n_microbatches=2))
    r_state = {"params": jax.tree.map(jnp.asarray, params),
               "opt": r_opt.init_opt_state(jax.tree.map(jnp.asarray, params))}
    pm = build_model(replace(CFG, remat=True))
    state = train_state_from_arrays(
        pm.specs, jax.tree.map(np.asarray, r_state), device="cpu")
    step = make_train_step(pm, ocfg, n_microbatches=2)
    r_state, r_met = r_step(r_state, rm.make_batch(RShape("t", 16, 4, "train"),
                                                   seed=10))
    state, met = step(state, pm.make_batch(ShapeConfig("t", 16, 4, "train"),
                                           seed=10, device="cpu"))
    for k in ("loss", "grad_norm", "lr"):
        _close(met[k], r_met[k], what=k)
    assert int(state["opt"]["step"]) == 1
    got = tree_to_arrays({"params": state["params"], "m": state["opt"]["m"],
                          "v": state["opt"]["v"]})
    want = {"params": r_state["params"], "m": r_state["opt"]["m"],
            "v": r_state["opt"]["v"]}
    for path, a in _paths(want):
        _close(_at(got, path), a, what="/".join(path))


def test_train_state_from_arrays_checks_its_input(params):
    pm = build_model(CFG)
    good = {"params": params, "opt": {"m": params, "v": params, "step": 3}}
    state = train_state_from_arrays(pm.specs, good, device="cpu",
                                    moment_dtype="bfloat16")
    assert state["opt"]["step"].dtype == torch.int32
    assert int(state["opt"]["step"]) == 3
    assert state["opt"]["m"]["ln_f"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="expected"):
        train_state_from_arrays(pm.specs, {"params": params}, device="cpu")


# --------------------------------------------------------------------- loop

def _quiet(*_):
    pass


def test_loss_decreases():
    pm = build_model(replace(CFG, use_pallas=True))
    out = run_training(pm, TrainLoopConfig(steps=60, batch=8, seq_len=64,
                                           log_every=1000),
                       opt_cfg=opt.OptConfig(lr=5e-3, total_steps=60,
                                             warmup_steps=5),
                       log_fn=_quiet, device="cpu")
    first = np.mean(out["losses"][:5])
    last = np.mean(out["losses"][-5:])
    assert last < first - 0.15, (first, last)
    assert len(out["monitor"].history) == 60


def test_crash_resume_continuity(tmp_path):
    """Kill training mid-run; the resumed run continues from the checkpoint
    with the uninterrupted run's losses."""
    pm = build_model(replace(CFG, use_pallas=True, remat=True))
    base = dict(steps=12, batch=4, seq_len=32, checkpoint_every=5,
                log_every=100, microbatches=2)
    ref = run_training(pm, TrainLoopConfig(
        checkpoint_dir=str(tmp_path / "ref"), **base), log_fn=_quiet,
        device="cpu")
    crash_dir = str(tmp_path / "crash")
    with pytest.raises(RuntimeError, match="injected crash"):
        run_training(pm, TrainLoopConfig(checkpoint_dir=crash_dir, **base),
                     crash_at_step=7, log_fn=_quiet, device="cpu")
    out = run_training(pm, TrainLoopConfig(checkpoint_dir=crash_dir, **base),
                       log_fn=_quiet, device="cpu")
    assert out["resumed_from"] == 5
    np.testing.assert_allclose(out["losses"], ref["losses"][5:], rtol=1e-5)


# -------------------------------------------------------------- checkpoints

def test_checkpoint_roundtrip_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"p": {"w": torch.arange(6.0).reshape(2, 3),
                   "h": torch.ones(4, dtype=torch.bfloat16) / 3},
             "step": torch.tensor(7, dtype=torch.int32),
             "t": (np.full(2, 5), [np.zeros(1)])}
    for step in (10, 20, 30):
        mgr.save(step, state, {"loss": 1.5})
        state["p"]["w"].add_(1)      # in place right after save
    mgr.wait()
    assert mgr.all_steps() == [20, 30] and mgr.latest_step() == 30
    assert not list(tmp_path.glob("*.tmp"))
    s, got = mgr.restore(step=20)
    assert s == 20
    torch.testing.assert_close(got["p"]["w"],
                               torch.arange(6.0).reshape(2, 3) + 1)
    assert got["p"]["h"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["h"], state["p"]["h"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    assert isinstance(got["t"], tuple) and isinstance(got["t"][1], list)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


# ------------------------------------------------------------------ monitor

def test_straggler_detection():
    events = []
    mon = StepMonitor(predicted_s=0.1, straggler_factor=2.0, patience=2,
                      on_straggler=events.append)
    for step in range(5):
        mon.observe(step, 0.11)
    assert not mon.flagged
    mon.observe(5, 0.5)
    mon.observe(6, 0.5)
    assert len(mon.flagged) == 1 and events == mon.flagged
    assert mon.flagged[0]["ratio"] > 2.0


# ----------------------------------------------------------------- launcher

def test_launcher_autotunes(capsys):
    """``--autotune`` (the reference's ``launch/train.py:47-53``): the step
    counted under ``2d``, ``tp`` and ``zero3`` on the launcher's mesh, the
    pick printed and trained under, two finite losses."""
    out = train_main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
                      "--autotune", "--steps", "2", "--batch", "2",
                      "--seq-len", "16"])
    tuned = out["autotune"]
    assert sorted(s for s, _ in tuned.ranked) == ["2d", "tp", "zero3"]
    assert out["strategy"] == tuned.best == tuned.ranked[0][0]
    assert all(np.isfinite(t) and t > 0 for _, t in tuned.ranked)
    assert f"autotune picked strategy {tuned.best!r}" in capsys.readouterr().out
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))


def test_launcher_trains_on_a_mesh_of_one():
    """The reference's defaults (``--strategy 2d --model-axis 1``): a world
    of one gloo rank, a (1, 1) ("data", "model") mesh, DTensor parameters;
    the world is torn down after."""
    from torch.distributed.tensor import DTensor
    import torch.distributed as dist

    out = train_main(["--reduced", "--device", "cpu", "--steps", "2"])
    assert out["mesh"] == (("data", "model"), (1, 1))
    assert out["backend"] == "gloo"
    assert all(isinstance(p, DTensor) for p in leaves(out["state"]["params"]))
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert not dist.is_initialized()


MESH_FAMILIES = {"moe": "granite-moe-3b-a800m", "vlm": "qwen2-vl-7b",
                 "xlstm": "xlstm-125m", "encdec": "whisper-medium"}


@pytest.fixture(scope="module")
def two_rank_families(tmp_path_factory):
    from _gloo import run_world

    return run_world("launcher_families", 2,
                     tmp_path_factory.mktemp("families"),
                     archs=tuple(MESH_FAMILIES.values()))


@pytest.mark.parametrize("family", list(MESH_FAMILIES))
def test_launcher_trains_every_family_on_two_ranks(two_rank_families,
                                                   family):
    """The moe, vlm, xlstm and encdec families train one step on 2 gloo
    ranks with model axis 2: a (1, 2) ("data", "model") mesh, DTensor
    parameters, the same finite loss on both ranks."""
    from _gloo import result

    arch = MESH_FAMILIES[family]
    assert ARCHS[arch].family == family
    got = [result(two_rank_families, arch, rank) for rank in (0, 1)]
    for g in got:
        assert g["mesh"] == (("data", "model"), (1, 2))
        assert g["backend"] == "gloo" and g["dtensor"]
        assert len(g["losses"]) == 1 and np.isfinite(g["losses"]).all()
    assert got[0]["losses"] == got[1]["losses"]


def test_launcher_trains_its_default_arch():
    """``train_main`` with its defaults but the size: smollm-360m (the
    reference's default) trains 2 steps to a finite loss."""
    out = train_main(["--reduced", "--device", "cpu", "--steps", "2"])
    assert ARCHS["smollm-360m"].family == "dense"
    assert out["state"]["params"]["embed"].shape == (128, 64)
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium"])
def test_launcher_feeds_the_stub_inputs(arch):
    """The VLM trains on the reference's stub patches (the text trimmed to
    its share of the sequence) and the enc-dec on its stub frames."""
    out = train_main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq-len", "16"])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()


def test_launcher_trains_on_the_host():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "zamba2-2.7b", "--reduced", "--device", "cpu", "--steps", "3",
         "--batch", "4", "--seq-len", "16", "--microbatches", "2"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "over 3 steps" in out.stdout


def test_training_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.launch.train, repro_torch.train.loop\n"
            "import repro_torch.kernels.attention, repro_torch.checkpoint\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
