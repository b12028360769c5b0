"""The port's encoder-decoder (``repro_torch.models.encdec``) against the
reference, at ``reduced(whisper-medium)`` in float32 (2 encoder and 2
decoder layers, d_model 64, 4 heads).

Held: ``encode``; the decoder's prefill logits and caches (the cross K/V
as long as the frames, the self K/V of the prompt); three decode steps on
identical caches and positions; loss and every gradient (the decoder's
self-attention through kernel B2's plain version under ``use_pallas``).
The cross cache is placed unpadded for decode; a test shows where the
port's ``generate`` parts from the reference's, which pads it. Parameters:
the reference's ``init`` with its constant leaves perturbed; tolerance
rtol 1e-4 plus an atol of 1e-4 of each tensor's largest magnitude
(``tests/_lm_parity.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.encdec as r_encdec
from _lm_parity import (TOL, batches, close, close_grads, close_trees,
                        models, pad_seq, port_loss_grads, port_params,
                        ref_loss_grads, ref_params, ulp_sensitivity)
from repro.configs.base import ShapeConfig as RShape
from repro.launch.serve import generate as r_generate
from repro.models.common import logical_axes as r_logical_axes
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import watch
from repro_torch.launch.serve import generate, place_prefill_caches
from repro_torch.models import encdec
from repro_torch.models.common import logical_axes

ARCH = "whisper-medium"
# The checks run at the parameters of seed 2, the first seed whose
# reference gradients move by less than the tolerance under a one-ulp
# nudge of every layer-norm output (``_lm_parity.ulp_sensitivity``). At
# seed 0 the nudge moves them by 1.4e-4 of their largest values, and the
# port's gradients land 1.7e-4 off the reference's.
SEED = 2


@pytest.fixture(scope="module")
def params():
    return ref_params(ARCH, seed=SEED)


@pytest.fixture(scope="module")
def ref_grads(params):
    """The reference's (batch, loss, gradients) of the training batch
    (16 x 2, seed 2)."""
    rm, _ = models(ARCH)
    rb = rm.make_batch(RShape("s", 16, 2, "train"), seed=2)
    return (rb, *ref_loss_grads(rm, params, rb))


def test_specs_and_batches_match_reference(params):
    rm, pm = models(ARCH)
    assert logical_axes(pm.specs) == r_logical_axes(rm.specs)
    assert pm.n_params() == rm.n_params()
    port_params(pm, params)
    for kind in ("prefill", "train", "decode"):
        want, got = batches(rm, pm, 10, 3, kind, seed=5)
        assert list(got) == list(want)
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(arr))


@pytest.mark.parametrize("offset", [0, 7])
def test_sinusoid_matches_reference(offset):
    close(encdec.sinusoid(9, 64, torch.float32, offset=offset),
          r_encdec._sinusoid(9, 64, jnp.float32, offset=offset))


def test_encode_matches_reference(params):
    rm, pm = models(ARCH)
    rb, pb = batches(rm, pm, 10, 2, "prefill", seed=1)
    close(encdec.encode(pm.cfg, port_params(pm, params), pb["frames"]),
          r_encdec.encode(rm.cfg, params, rb["frames"]), what="encoder out")


def test_prefill_and_decode_match_reference(params):
    """Prefill logits and caches, then three decode steps on identical
    caches and positions (the cross cache as prefill made it, on both
    sides), each step's logits and at the end every cache."""
    rm, pm = models(ARCH)
    pp = port_params(pm, params)
    rb, pb = batches(rm, pm, 10, 2, "prefill", seed=1)
    r_logits, r_caches = jax.jit(rm.prefill)(params, rb)
    logits, caches = pm.prefill(pp, pb)
    close(logits, r_logits, what="prefill logits")
    close_trees(caches, r_caches, "prefill caches")
    steps, S = 3, 10
    r_caches = {"cross": r_caches["cross"],
                "self": pad_seq(r_caches["self"], steps)}
    caches = place_prefill_caches(pm, caches, S + steps)
    assert caches["cross"][0].shape[2] == S          # unpadded
    assert caches["self"][0].shape[2] == S + steps
    tokens = np.random.default_rng(3).integers(0, pm.cfg.vocab, (steps, 2, 1))
    r_decode = jax.jit(rm.decode)
    for i in range(steps):
        r_logits, r_caches = r_decode(
            params, {"tokens": jnp.asarray(tokens[i], jnp.int32),
                     "pos": jnp.asarray(S + i, jnp.int32)}, r_caches)
        logits, caches = pm.decode(pp, {"tokens": torch.as_tensor(
            tokens[i], dtype=torch.int32), "pos": S + i}, caches)
        close(logits, r_logits, what=f"decode step {i}")
    close_trees(caches, r_caches, "caches after decode")


def test_generate_parts_from_reference_at_the_cross_cache(params):
    """Where the two generates part, and why. The reference's ``pad_seq``
    pads every cache whose axis 2 equals the prompt length; the encoder's
    frames are as long as the prompt here (``input_specs``), so it pads the
    cross K/V with zero keys too, and every decode step attends to them (no
    mask on cross-attention). Its tokens are the port's decode run on a
    cross cache padded the same way. The port keeps the cross cache as the
    encoder made it; at the first step its logits differ from those on the
    padded cache."""
    rm, pm = models(ARCH)
    pp = port_params(pm, params)
    steps = 3
    rb, pb = batches(rm, pm, 6, 2, "prefill", seed=3)
    S = pb["tokens"].shape[1]
    assert pb["frames"].shape[1] == S
    want, _ = r_generate(rm, params, rb, steps)

    logits, caches = pm.prefill(pp, pb)
    caches = place_prefill_caches(pm, caches, S + steps)
    padded = dict(caches, cross=tuple(
        torch.nn.functional.pad(a, (0, 0, 0, 0, 0, steps))
        for a in caches["cross"]))
    cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    toks = []
    for i in range(steps):
        toks.append(cur)
        step = {"tokens": cur, "pos": S + i}
        if i == 0:
            unpadded, _ = pm.decode(pp, step, {
                "cross": caches["cross"],
                "self": tuple(t.clone() for t in padded["self"])})
        logits, padded = pm.decode(pp, step, padded)
        if i == 0:
            assert not torch.allclose(unpadded, logits, rtol=1e-3, atol=1e-3)
        cur = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
    np.testing.assert_array_equal(torch.cat(toks, 1).numpy(), np.asarray(want))
    got, _ = generate(pm, pp, pb, steps)
    assert got.shape == (2, steps)


def test_reference_is_stable_at_the_seed(params, ref_grads):
    rm, _ = models(ARCH)
    rb, _, want = ref_grads
    assert ulp_sensitivity(rm, params, rb, want, r_encdec, "layer_norm") < TOL


@pytest.mark.parametrize("use_pallas,remat", [(False, False), (True, True)])
def test_loss_and_every_gradient_match_reference(params, ref_grads,
                                                 use_pallas, remat):
    """With use_pallas the decoder's self-attention goes through B2's
    wrapper (its plain version here): once per decoder layer, and once more
    in the backward under remat; the encoder and the cross-attention stay
    plain."""
    _, pm = models(ARCH, use_pallas=use_pallas, remat=remat)
    pb = pm.make_batch(ShapeConfig("s", 16, 2, "train"), seed=2, device="cpu")
    _, r_loss, r_grads = ref_grads
    calls = []
    with watch.watching(lambda name, i, o: calls.append(name)):
        loss, grads = port_loss_grads(pm, port_params(pm, params), pb)
    n = pm.cfg.n_layers * (2 if remat else 1) if use_pallas else 0
    assert calls == ["flash_attention"] * n
    close(loss, r_loss, what="loss")
    close_grads(grads, r_grads)
