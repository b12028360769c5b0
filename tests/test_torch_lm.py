"""The port's dense and VLM decoder LMs (``repro_torch.models.lm``, the
shared pieces in ``models/common.py``, ``mlp.py`` and ``attention.py``)
against the reference, at ``reduced(...)`` in float32, for every dense and
vlm config in ``ARCHS``.

Both frameworks get the same parameters: the reference's ``init`` with its
constant leaves perturbed by seeded numpy noise, carried across by
``lm_params_from_arrays`` (``tests/_lm_parity.py``). Tolerance: rtol 1e-4
plus an atol of 1e-4 of each tensor's largest magnitude. The reference
cannot differentiate through its Pallas kernel, so the gradient oracle is
its jnp path; the port runs with ``use_pallas`` on (kernel B2's plain
version on the CPU) and off."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _lm_parity import (batches, close, close_grads, close_trees, models,
                        pad_seq, port_loss_grads, port_params, ref_loss_grads,
                        ref_params)
from repro.configs import ARCHS as R_ARCHS
from repro.configs.base import ShapeConfig as RShape
from repro.launch.serve import generate as r_generate
from repro.models import attention as r_attention
from repro.models import common as r_common
from repro.models import lm as r_lm
from repro.models import mlp as r_mlp
from repro.models.common import logical_axes as r_logical_axes
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import watch
from repro_torch.launch.serve import generate, place_prefill_caches
from repro_torch.models import attention, common, lm, mlp
from repro_torch.models.common import logical_axes

ARCH_LIST = sorted(a for a, c in ARCHS.items() if c.family in ("dense", "vlm"))
# generate held token for token: the launchers' default, and a dense
# config with q/k/v biases
GENERATE = ["smollm-360m", "qwen2.5-14b"]


def _cached(fn):
    cache = {}

    def get(arch, **changes):
        key = (arch, tuple(sorted(changes.items())))
        if key not in cache:
            cache[key] = fn(arch, **changes)
        return cache[key]
    return get


@pytest.fixture(scope="module")
def params():
    return _cached(ref_params)


@pytest.fixture(scope="module")
def ref_grads(params):
    """The reference's (loss, gradients) of the training batch (16 x 2,
    seed 2) at ``params(arch)``."""
    def run(arch, **changes):
        rm, _ = models(arch, **changes)
        rb = rm.make_batch(RShape("s", 16, 2, "train"), seed=2)
        return ref_loss_grads(rm, params(arch, **changes), rb)
    return _cached(run)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ----------------------------------------------------------- shared pieces

def test_layer_norm_gelu_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 24)).astype(np.float32) * 3
    w, b = (rng.normal(size=24).astype(np.float32) for _ in range(2))
    close(common.layer_norm(_t(x), _t(w), _t(b), 1e-5),
          r_common.layer_norm(x, w, b, 1e-5), what="layer_norm")
    close(common.gelu(_t(x)), r_common.gelu(jnp.asarray(x)), what="gelu")
    cfg = replace(reduced(ARCHS["whisper-medium"]), d_model=24, d_ff=40)
    p = {k: rng.normal(size=s.shape).astype(np.float32)
         for k, s in r_mlp.gelu_mlp_specs(cfg).items()}
    close(mlp.gelu_mlp({k: _t(v) for k, v in p.items()}, _t(x)),
          r_mlp.gelu_mlp(p, jnp.asarray(x)), what="gelu_mlp")
    assert logical_axes(mlp.gelu_mlp_specs(cfg)) == \
        r_logical_axes(r_mlp.gelu_mlp_specs(cfg))


@pytest.mark.parametrize("sections,theta", [((16, 24, 24), 1e6),
                                            ((2, 3, 3), 1e4)])
def test_mrope_cos_sin_matches_reference(sections, theta):
    rng = np.random.default_rng(1)
    pos3 = rng.integers(0, 300, size=(2, 7, 3)).astype(np.int32)
    D = 2 * sum(sections)
    got = common.mrope_cos_sin(_t(pos3), D, theta, sections)
    want = r_common.mrope_cos_sin(jnp.asarray(pos3), D, theta, sections)
    for g, w, name in zip(got, want, ("cos", "sin")):
        close(g, w, what=name)
    with pytest.raises(ValueError, match="sum"):
        common.mrope_cos_sin(_t(pos3), D + 2, theta, sections)


@pytest.mark.parametrize("sq,skv,offset", [(4, 4, 0), (3, 7, 4), (5, 2, -1)])
def test_causal_mask_matches_reference(sq, skv, offset):
    np.testing.assert_array_equal(common.causal_mask(sq, skv, offset).numpy(),
                                  np.asarray(r_common.causal_mask(sq, skv,
                                                                  offset)))


@pytest.mark.parametrize("s_img,s_text", [(0, 5), (4, 6), (10, 3)])
def test_mrope_positions_match_reference(s_img, s_text):
    cfg = reduced(R_ARCHS["qwen2-vl-7b"])
    np.testing.assert_array_equal(
        lm.mrope_positions(s_img, s_text).numpy(),
        np.asarray(r_lm._mrope_positions(cfg, s_img, s_text)))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches_reference(qkv_bias):
    cfg = replace(reduced(ARCHS["whisper-medium"]), qkv_bias=qkv_bias)
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=s.shape).astype(np.float32) * 0.3
         for k, s in r_attention.attn_specs(cfg).items()}
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    kv = attention.cross_kv(cfg, tp, _t(enc))
    r_kv = r_attention.cross_kv(cfg, p, jnp.asarray(enc))
    close_trees(kv, r_kv, "cross_kv")
    close(attention.attend_cross(cfg, tp, _t(x), kv),
          r_attention.attend_cross(cfg, p, jnp.asarray(x), r_kv),
          what="attend_cross")


# ----------------------------------------------------------------- specs

@pytest.mark.parametrize("arch", ARCH_LIST)
def test_specs_match_reference(arch, params):
    rm, pm = models(arch)
    assert logical_axes(pm.specs) == r_logical_axes(rm.specs)
    assert pm.n_params() == rm.n_params()
    pp = port_params(pm, params(arch))          # every name and shape
    assert sorted(pp) == sorted(params(arch))


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_vlm_make_batch_matches_reference(kind):
    rm, pm = models("qwen2-vl-7b")
    want, got = batches(rm, pm, 12, 3, kind, seed=5)
    assert list(got) == list(want)
    for name, arr in want.items():
        assert got[name].dtype == getattr(torch, str(np.asarray(arr).dtype))
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr))


# --------------------------------------------------------------- serving

def _vlm_delta(pm, batch):
    """The M-RoPE offset that continues the prompt's text positions."""
    s_img = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    g = lm.mrope_positions(s_img, 1)[-1, 0].item()
    return g - s_img


@pytest.mark.parametrize("arch", ARCH_LIST + ["gqa"])
def test_prefill_and_decode_match_reference(arch, params):
    """Prefill logits and caches, then three decode steps on identical
    caches and positions: each step's logits and, at the end, every cache.
    "gqa" is smollm-360m with 2 KV heads for 4 query heads."""
    changes = {"n_kv_heads": 2} if arch == "gqa" else {}
    arch = "smollm-360m" if arch == "gqa" else arch
    rm, pm = models(arch, **changes)
    p = params(arch, **changes)
    pp = port_params(pm, p)
    rb, pb = batches(rm, pm, 12, 2, "prefill", seed=1)
    r_logits, r_caches = jax.jit(rm.prefill)(p, rb)
    logits, caches = pm.prefill(pp, pb)
    close(logits, r_logits, what="prefill logits")
    close_trees(caches, r_caches, "prefill caches")
    shapes, _ = pm.cache_spec(2, caches[0].shape[2])
    assert tuple(caches[0].shape) == shapes[0][0]

    steps = 3
    start = caches[0].shape[2]                  # s_img + S
    r_caches = pad_seq(r_caches, steps)
    caches = place_prefill_caches(pm, caches, start + steps)
    close_trees(caches, r_caches, "placed caches")
    tokens = np.random.default_rng(3).integers(0, pm.cfg.vocab, (steps, 2, 1))
    delta = _vlm_delta(pm, pb) if pm.cfg.family == "vlm" else 0
    r_decode = jax.jit(rm.decode)
    for i in range(steps):
        step = {"tokens": tokens[i].astype(np.int32), "pos": start + i}
        r_step = {"tokens": jnp.asarray(step["tokens"]),
                  "pos": jnp.asarray(start + i, jnp.int32)}
        if pm.cfg.family == "vlm":
            step["mrope_delta"] = delta
            r_step["mrope_delta"] = jnp.asarray(delta, jnp.int32)
        r_logits, r_caches = r_decode(p, r_step, r_caches)
        logits, caches = pm.decode(pp, {**step, "tokens": _t(step["tokens"])},
                                   caches)
        close(logits, r_logits, what=f"decode step {i}")
    close_trees(caches, r_caches, "caches after decode")


@pytest.mark.parametrize("arch", GENERATE)
def test_generate_matches_reference(arch, params):
    """Greedy tokens over 4 steps equal the reference's generate."""
    rm, pm = models(arch, use_pallas=True)
    p = params(arch)
    rb, pb = batches(rm, pm, 6, 2, "prefill", seed=3)
    want, _ = r_generate(rm, p, rb, 4)
    got, times = generate(pm, port_params(pm, p), pb, 4)
    assert got.dtype == torch.int32 and got.shape == (2, 4) and len(times) == 4
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vlm_generate_parts_from_reference(params):
    """Where the two generates part, and why. The reference's ``pad_seq``
    pads only caches whose axis 2 equals the TEXT length, so the VLM's
    prefill cache (s_img + S positions) stays unpadded, and its decode step
    i writes at position S + i: inside the prompt, over a text token's K/V,
    attending to the first S + i + 1 positions only. Its tokens are the
    port's prefill and decode driven that way. The port's generate writes
    after the prompt instead (position s_img + S + i), leaving the
    prompt's caches as prefill made them."""
    rm, pm = models("qwen2-vl-7b")
    p = params("qwen2-vl-7b")
    pp = port_params(pm, p)
    steps = 3
    rb, pb = batches(rm, pm, 16, 2, "prefill", seed=4)
    S, s_img = pb["tokens"].shape[1], pb["patch_embeds"].shape[1]
    assert (S, s_img) == (12, 4) and S + steps <= s_img + S
    want, _ = r_generate(rm, p, rb, steps)

    logits, caches = pm.prefill(pp, pb)
    prompt_k = caches[0].clone()
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = []
    for i in range(steps):                      # the reference's positions
        toks.append(cur)
        logits, caches = pm.decode(pp, {"tokens": cur, "pos": S + i,
                                        "mrope_delta": 0}, caches)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), np.asarray(want))
    assert not torch.equal(caches[0][:, :, S:S + steps],
                           prompt_k[:, :, S:S + steps])   # prompt overwritten

    got, _ = generate(pm, pp, pb, steps)        # the port's positions
    logits, caches = pm.prefill(pp, pb)
    caches = place_prefill_caches(pm, caches, s_img + S + steps)
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    for i in range(steps):
        assert torch.equal(cur[:, 0], got[:, i])
        logits, caches = pm.decode(pp, {"tokens": cur, "pos": s_img + S + i,
                                        "mrope_delta": 0}, caches)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    assert torch.equal(caches[0][:, :, :s_img + S], prompt_k)


# -------------------------------------------------------------- training

@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_loss_and_every_gradient_match_reference(arch, use_pallas, params,
                                                 ref_grads):
    _, pm = models(arch, use_pallas=use_pallas)
    pb = pm.make_batch(ShapeConfig("s", 16, 2, "train"), seed=2, device="cpu")
    r_loss, r_grads = ref_grads(arch)
    loss, grads = port_loss_grads(pm, port_params(pm, params(arch)), pb)
    close(loss, r_loss, what="loss")
    close_grads(grads, r_grads)


@pytest.mark.parametrize("remat,groups", [(True, 0), (True, 2)])
def test_remat_keeps_gradients_and_recomputes_attention(remat, groups,
                                                        params, ref_grads):
    """Checkpointing changes no number, only how often B2 is called: each
    layer twice per loss (forward, then again in the backward); with
    groups of layers nested, each layer's own checkpoint runs it once more,
    and the group's recomputation runs every layer of the group but its
    last (torch's non-reentrant checkpoint stops recomputing once it holds
    every tensor the backward needs: the last layer's input), so 3 L - G
    calls for G groups."""
    changes = dict(n_layers=4)
    _, pm = models("smollm-360m", use_pallas=True, remat=remat,
                   remat_groups=groups, **changes)
    assert lm.remat_grouped(pm.cfg) == bool(groups)
    p = params("smollm-360m", **changes)
    pb = pm.make_batch(ShapeConfig("s", 16, 2, "train"), seed=2, device="cpu")
    r_loss, r_grads = ref_grads("smollm-360m", **changes)
    calls = []
    with watch.watching(lambda name, i, o: calls.append(name)):
        loss, grads = port_loss_grads(pm, port_params(pm, p), pb)
    assert calls == ["flash_attention"] * (3 * 4 - groups if groups else 2 * 4)
    close(loss, r_loss, what="loss")
    close_grads(grads, r_grads)


def test_serving_launches_no_attention_kernel(params):
    """The reference's serving attention is jnp: prefill and decode call no
    kernel wrapper, with use_pallas on."""
    _, pm = models("smollm-360m", use_pallas=True)
    pp = port_params(pm, params("smollm-360m"))
    calls = []
    with watch.watching(lambda name, i, o: calls.append(name)):
        generate(pm, pp, pm.make_batch(ShapeConfig("s", 6, 2, "prefill"),
                                       device="cpu"), 2)
    assert calls == []
