"""The port's zamba2 serving path (``repro_torch.models``, ``launch.serve``)
against the reference, at ``reduced(zamba2-2.7b)`` in float32 (4 layers,
d_model 64, state 16).

Both frameworks get the same parameters: the reference's ``init`` with its
zero/one-initialized leaves (LoRA ``q_b``/``gate_b``, ``dt_bias``,
``a_log``, biases, norms) perturbed by seeded numpy noise, so every path is
exercised, carried across by ``lm_params_from_arrays``. Tolerance across
frameworks in float32: rtol 1e-4, plus an atol of 1e-4 of the tensor's
largest magnitude for entries that cancel to near zero (the SSM state
reaches 1e3 here; a sum of such terms carries an absolute error of a few
float32 ulps of the largest one)."""
import subprocess
import sys
from dataclasses import fields, replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.configs import reduced as r_reduced
from repro.configs.base import ShapeConfig as RShape
from repro.launch.serve import generate as r_generate
from repro.models.common import logical_axes as r_logical_axes
from repro.models.registry import build_model as r_build
from repro_torch.configs import ARCHS, SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import lm_params_from_arrays
from repro_torch.launch.serve import generate, place_prefill_caches
from repro_torch.models.common import leaves, logical_axes
from repro_torch.models.registry import build_model

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
CFG = reduced(get_config("zamba2-2.7b"))


def _close(got, want, tol=TOL, what=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.fixture(scope="module")
def params():
    """Reference parameters (numpy), with the constant leaves perturbed."""
    tree = jax.tree.map(np.asarray,
                        r_build(r_reduced(R_ARCHS["zamba2-2.7b"])).init(
                            jax.random.key(0)))
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


def _models(use_pallas):
    rm = r_build(replace(r_reduced(R_ARCHS["zamba2-2.7b"]),
                         use_pallas=use_pallas))
    pm = build_model(replace(CFG, use_pallas=use_pallas))
    return rm, pm


# ----------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_configs_are_copies(arch):
    ref, port = R_ARCHS[arch], ARCHS[arch]
    assert [f.name for f in fields(port)] == [f.name for f in fields(ref)]
    assert vars(port) == vars(ref)
    assert vars(reduced(port)) == vars(r_reduced(ref))
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in R_SHAPES.items()}


# --------------------------------------------------------------- parameters

def test_params_from_arrays_carries_init():
    rm = r_build(r_reduced(R_ARCHS["zamba2-2.7b"]))
    ref = jax.tree.map(np.asarray, rm.init(jax.random.key(0)))
    pm = build_model(CFG)
    port = lm_params_from_arrays(pm.specs, ref, device="cpu")
    flat_ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat_ref) == len(leaves(port))
    for path, a in flat_ref:
        t = port
        for p in path:
            t = t[p.key]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a)
    assert pm.n_params() == rm.n_params()
    assert logical_axes(pm.specs) == r_logical_axes(rm.specs)


def test_params_from_arrays_rejects_bad_trees():
    rm = r_build(r_reduced(R_ARCHS["zamba2-2.7b"]))
    pm = build_model(CFG)
    ref = jax.tree.map(np.asarray, rm.init(jax.random.key(0)))
    bad = dict(ref, ln_f=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="ln_f: shape"):
        lm_params_from_arrays(pm.specs, bad, device="cpu")
    missing = dict(ref, mamba=dict(ref["mamba"]))
    del missing["mamba"]["mix"]
    with pytest.raises(ValueError, match=r"mamba: missing \['mix'\]"):
        lm_params_from_arrays(pm.specs, missing, device="cpu")
    with pytest.raises(ValueError, match=r"extra \['bogus'\]"):
        lm_params_from_arrays(pm.specs, dict(ref, bogus=np.zeros(1)),
                              device="cpu")


def test_init_params_follows_the_specs():
    pm = build_model(CFG)
    p = pm.init(0, device="cpu")
    again = pm.init(0, device="cpu")
    other = pm.init(1, device="cpu")
    assert torch.equal(p["lm_head"], again["lm_head"])
    assert not torch.equal(p["lm_head"], other["lm_head"])
    assert (p["lora"]["q_b"] == 0).all() and (p["ln_f"] == 1).all()
    assert (p["mamba"]["mix"]["d_skip"] == 1).all()
    assert p["mamba"]["mix"]["in_proj"].shape == (2, 2, 64, 2 * 128 + 2 * 16 + 8)
    # scales: 1/sqrt(fan_in) by default, the spec's own where it sets one
    assert abs(float(p["lm_head"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(p["embed"].std()) - 0.02) < 0.002
    assert abs(float(p["mamba"]["mix"]["conv_w"].std()) - 0.5) < 0.05


# ----------------------------------------------------------------- batches

@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_make_batch_matches_reference(kind):
    rm, pm = _models(False)
    got = pm.make_batch(ShapeConfig("s", 12, 3, kind), seed=5, device="cpu")
    want = rm.make_batch(RShape("s", 12, 3, kind), seed=5)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].dtype == torch.int32
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr))


# ---------------------------------------------------------------- prefill

@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_matches_reference(params, use_pallas):
    """Logits and every cache; with use_pallas the reference runs its Pallas
    SSD kernel in interpret mode and the port its kernel's plain version."""
    rm, pm = _models(use_pallas)
    pp = lm_params_from_arrays(pm.specs, params, device="cpu")
    sh = ShapeConfig("s", 20, 2, "prefill")
    batch = pm.make_batch(sh, seed=1, device="cpu")
    r_logits, r_caches = jax.jit(rm.prefill)(
        params, rm.make_batch(RShape("s", 20, 2, "prefill"), seed=1))
    logits, caches = pm.prefill(pp, batch)
    _close(logits, r_logits, what="logits")
    _close(caches["conv"], r_caches["conv"], what="conv")
    _close(caches["ssm"], r_caches["ssm"], what="ssm")
    _close(caches["kv"][0], r_caches["kv"][0], what="k")
    _close(caches["kv"][1], r_caches["kv"][1], what="v")
    # the cache spec names these caches and their dtypes
    shapes, _ = pm.cache_spec(2, 20)
    assert caches["ssm"].shape == shapes["ssm"][0]
    assert caches["conv"].shape == shapes["conv"][0]
    assert caches["kv"][0].shape == shapes["kv"][0][0]


# ----------------------------------------------------------------- decode

def test_decode_matches_prefill(params):
    """Prefill S-1 tokens + decode token S-1 == full prefill logits (the
    reference's own check in tests/test_models.py, run on the port)."""
    _, pm = _models(False)
    pp = lm_params_from_arrays(pm.specs, params, device="cpu")
    S = 12
    batch = pm.make_batch(ShapeConfig("s", S, 2, "train"), seed=1, device="cpu")
    logits_full, _ = pm.prefill(pp, {"tokens": batch["tokens"]})
    _, caches = pm.prefill(pp, {"tokens": batch["tokens"][:, :-1]})
    caches = place_prefill_caches(pm, caches, S)
    logits_dec, _ = pm.decode(pp, {"tokens": batch["tokens"][:, -1:],
                                   "pos": S - 1}, caches)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_generate_matches_reference(params, use_pallas):
    """Greedy tokens over 4 steps equal the reference's generate, B != S."""
    rm, pm = _models(use_pallas)
    pp = lm_params_from_arrays(pm.specs, params, device="cpu")
    want, _ = r_generate(rm, params,
                         rm.make_batch(RShape("s", 6, 2, "prefill"), seed=3),
                         4)
    got, times = generate(pm, pp, pm.make_batch(ShapeConfig("s", 6, 2, "prefill"),
                                                seed=3, device="cpu"), 4)
    assert got.dtype == torch.int32 and got.shape == (2, 4) and len(times) == 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_picks_caches_by_name(params):
    """B == S: the reference's ``pad_seq`` would pad the conv/ssm caches on
    their batch axis (it pads every array whose axis 2 equals S). The port
    picks the K/V caches by name; its tokens equal the reference's prefill
    and decode run with the caches padded by name."""
    rm, pm = _models(False)
    pp = lm_params_from_arrays(pm.specs, params, device="cpu")
    B = S = 3
    steps = 3
    rb = rm.make_batch(RShape("s", S, B, "prefill"), seed=4)
    logits, caches = jax.jit(rm.prefill)(params, rb)
    caches = dict(caches, kv=tuple(
        jnp.pad(a, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
        for a in caches["kv"]))
    decode = jax.jit(rm.decode)
    cur = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    want = []
    for i in range(steps):
        want.append(np.asarray(cur))
        logits, caches = decode(params, {"tokens": cur,
                                         "pos": jnp.asarray(S + i, jnp.int32)},
                                caches)
        cur = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    got, _ = generate(pm, pp, pm.make_batch(ShapeConfig("s", S, B, "prefill"),
                                            seed=4, device="cpu"), steps)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_generate_refuses_non_finite_logits(params):
    _, pm = _models(False)
    pp = lm_params_from_arrays(pm.specs, params, device="cpu")
    pp["lm_head"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        generate(pm, pp, pm.make_batch(ShapeConfig("s", 4, 2, "prefill"),
                                       device="cpu"), 2)


# --------------------------------------------------------- families, rules

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_builds_and_runs(arch):
    """Every config of ARCHS has a model: on the host at its reduced size,
    a finite loss, prefill logits of the vocab's width and one decode step
    on the placed caches."""
    pm = build_model(reduced(ARCHS[arch]))
    p = pm.init(0, "cpu")
    loss, _ = pm.loss(p, pm.make_batch(ShapeConfig("t", 8, 2, "train"),
                                       device="cpu"))
    assert loss.dim() == 0 and bool(torch.isfinite(loss))
    batch = pm.make_batch(ShapeConfig("s", 8, 2, "prefill"), device="cpu")
    logits, caches = pm.prefill(p, batch)
    assert tuple(logits.shape) == (2, 1, pm.cfg.vocab)
    start = 8                 # cache positions (the VLM's: patches + text)
    caches = place_prefill_caches(pm, caches, start + 1)
    step, _ = pm.decode(p, {"tokens": batch["tokens"][:, -1:], "pos": start},
                        caches)
    assert tuple(step.shape) == (2, 1, pm.cfg.vocab)
    assert bool(torch.isfinite(step).all())


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a card-less host")
    pm = build_model(CFG)
    for call in (lambda: pm.init(0),
                 lambda: pm.make_batch(ShapeConfig("s", 4, 2, "prefill")),
                 lambda: pm.init_cache(2, 8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_serve_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.launch.serve, repro_torch.models.registry\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def test_scan_drift_sets_faults_apart(capsys):
    """The study behind chip_smoke.py's whole-prefill limit, at the reduced
    size on the host (S = 256, two chunks of 128): on a CPU tensor the
    served scan is the plain version itself; two correct orders of the SSD
    sums stay close through the model; both broken scans land far off on
    some tensor."""
    import json

    from repro_torch.launch.scan_drift import main
    main(["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
          "256"])
    out = json.loads(capsys.readouterr().out)["drift"]
    for dtype in ("bfloat16", "float32"):
        assert max(out[dtype]["kernel"].values()) == 0.0
    f32 = out["float32"]
    correct = max(f32["plain_chunk64"].values())
    assert correct < 1e-3
    for fault in ("fault_no_carry", "fault_shift"):
        assert max(f32[fault].values()) > 100 * correct, fault


def test_serve_main_runs_on_the_host(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu", "--batch",
          "2", "--prompt-len", "5", "--gen", "3"])
    assert "generated (2, 3) tokens" in capsys.readouterr().out


def test_serve_default_arch_matches_reference(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu``: its
    default arch is the reference's (smollm-360m), and with the reference's
    parameters (``init`` of key 0) its tokens are the reference's
    ``generate``'s on the same batch, 4 prompts of 32 tokens, 32 steps."""
    from repro_torch.launch.serve import main
    from repro_torch.models.registry import ModelBundle
    rm = r_build(r_reduced(R_ARCHS["smollm-360m"]))
    ref = jax.tree.map(np.asarray, rm.init(jax.random.key(0)))
    want, _ = r_generate(rm, ref, rm.make_batch(RShape("serve", 32, 4,
                                                       "prefill")), 32)
    monkeypatch.setattr(ModelBundle, "init", lambda self, seed=0, device="cuda":
                        lm_params_from_arrays(self.specs, ref, device=device))
    toks, times = main(["--reduced", "--device", "cpu"])
    assert "generated (4, 32) tokens" in capsys.readouterr().out
    assert len(times) == 32
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))


def test_serve_module_runs_with_its_defaults():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                          "--reduced", "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "generated (4, 32) tokens" in out.stdout
