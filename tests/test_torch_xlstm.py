"""The port's xLSTM (``repro_torch.models.xlstm``, ``xlstm_lm``) against
the reference, at ``reduced(xlstm-125m)`` in float32 (one group of 4
layers: 3 mLSTM + 1 sLSTM, d_model 64, 4 heads).

The mLSTM chunk scan is held to the reference's across chunk edges, with a
ragged last chunk and a carried state, and to the O(1) decode recurrence
stepped token by token; the sLSTM time loop to the reference's scan. The
whole model: prefill logits and states, three decode steps, decode after
prefill equal to a longer prefill, loss and every gradient, and greedy
generate token for token. Parameters: the reference's ``init`` with its
constant leaves perturbed; tolerance rtol 1e-4 plus an atol of 1e-4 of each
tensor's largest magnitude (``tests/_lm_parity.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.xlstm as r_xlstm
from _lm_parity import (TOL, batches, close, close_grads, close_trees,
                        models, port_loss_grads, port_params, ref_loss_grads,
                        ref_params, ulp_sensitivity)
from repro.configs.base import ShapeConfig as RShape
from repro.launch.serve import generate as r_generate
from repro.models.common import logical_axes as r_logical_axes
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.serve import generate, place_prefill_caches
from repro_torch.models import xlstm
from repro_torch.models.common import logical_axes

ARCH = "xlstm-125m"
# The checks run at the parameters of seed 1, the first seed whose
# reference gradients move by less than the tolerance under a one-ulp
# nudge of every norm output (``_lm_parity.ulp_sensitivity``); at seed 0
# the nudge moves them by 1.5e-4 of their largest values. There the second
# group's mLSTM, whose output divides by max(|n.q|, e^-m), turns a 4e-6
# difference of its input into 1.1e-4 of its output, and the states after
# decode and the gradients of out_norm miss the tolerance.
SEED = 1


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


def test_reference_is_stable_at_the_seed(params, ref_grads):
    import repro.models.xlstm_lm as r_xlstm_lm
    rm, _ = models(ARCH)
    rb, _, want = ref_grads
    assert ulp_sensitivity(rm, params, rb, want, r_xlstm_lm, "rms_norm",
                           skip=("b_i",)) < TOL


def _gates(rng, B, S, H, Dh, state=True):
    q, k, v = (rng.normal(size=(B, S, H, Dh)).astype(np.float32)
               for _ in range(3))
    logi = rng.normal(size=(B, S, H)).astype(np.float32)
    logf = np.log(1 / (1 + np.exp(-(rng.normal(size=(B, S, H)) + 2)))
                  ).astype(np.float32)
    st = (rng.normal(size=(B, H, Dh, Dh)).astype(np.float32) * 0.1,
          np.abs(rng.normal(size=(B, H, Dh))).astype(np.float32),
          rng.normal(size=(B, H)).astype(np.float32)) if state else (
        np.zeros((B, H, Dh, Dh), np.float32), np.zeros((B, H, Dh), np.float32),
        np.zeros((B, H), np.float32))
    return (q, k, v, logi, logf), st


@pytest.mark.parametrize("S,chunk", [(21, 8), (16, 8), (5, 8), (64, 64)])
def test_mlstm_chunk_scan_matches_reference(S, chunk):
    """Chunk edges (S a multiple of the chunk or not, one ragged chunk
    only), from a nonzero carried state: y and the final (C, n, m)."""
    rng = np.random.default_rng(S)
    args, st = _gates(rng, 2, S, 3, 8)
    want_y, want_st = r_xlstm._mlstm_chunk_scan(
        *map(jnp.asarray, args), tuple(map(jnp.asarray, st)), chunk)
    y, new = xlstm.mlstm_chunk_scan(*map(torch.as_tensor, args),
                                    tuple(map(torch.as_tensor, st)), chunk)
    close(y, want_y, what="y")
    close_trees(new, want_st, "state")


def test_mlstm_decode_recurrence_equals_the_chunk_scan(params):
    """The O(1) decode step run token by token gives the chunk scan's
    outputs and final state (one mLSTM layer of the model)."""
    _, pm = models(ARCH)
    lp = port_params(pm, params)["mlstm"]["cell"]
    lp = {k: v[0, 0] for k, v in lp.items()}
    x = torch.as_tensor(np.random.default_rng(1).normal(
        size=(2, 19, pm.cfg.d_model)).astype(np.float32))
    full, st_full = xlstm.mlstm_apply(pm.cfg, lp, x)
    st, outs = None, []
    for t in range(x.shape[1]):
        out, st = xlstm.mlstm_apply(pm.cfg, lp, x[:, t:t + 1], st, decode=True)
        outs.append(out)
    close(torch.cat(outs, 1), full.numpy(), what="y")
    close_trees(st, tuple(s.numpy() for s in st_full), "state")


def test_slstm_loop_matches_reference(params):
    """The sLSTM stepped over 13 positions from a nonzero state."""
    rm, pm = models(ARCH)
    sp = {k: np.array(v[0]) for k, v in params["slstm"]["cell"].items()}
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 13, pm.cfg.d_model)).astype(np.float32)
    H, Dh = pm.cfg.n_heads, pm.cfg.d_model // pm.cfg.n_heads
    st = tuple(rng.normal(size=(2, H, Dh)).astype(np.float32) * 0.3
               for _ in range(4))
    st = (st[0], np.abs(st[1]) + 0.5, st[2], st[3])
    want, want_st = r_xlstm.slstm_apply(
        rm.cfg, jax.tree.map(jnp.asarray, sp), jnp.asarray(x),
        state=tuple(map(jnp.asarray, st)))
    got, got_st = xlstm.slstm_apply(
        pm.cfg, {k: torch.as_tensor(v) for k, v in sp.items()},
        torch.as_tensor(x), state=tuple(map(torch.as_tensor, st)))
    close(got, want, what="out")
    close_trees(got_st, want_st, "state")


def test_specs_and_cache_spec_match_reference(params):
    rm, pm = models(ARCH)
    assert logical_axes(pm.specs) == r_logical_axes(rm.specs)
    assert pm.n_params() == rm.n_params()
    port_params(pm, params)
    shapes, axes = pm.cache_spec(3, 99)
    r_shapes, r_axes = rm.cache_spec(3, 99)
    assert axes == r_axes
    assert jax.tree.map(lambda s: (s.shape, str(s.dtype)), r_shapes) == \
        {k: tuple((shp, str(dt).split(".")[-1]) for shp, dt in v)
         for k, v in shapes.items()}
    caches = pm.init_cache(3, 99, device="cpu")
    assert [tuple(t.shape) for t in caches["m"] + caches["s"]] == \
        [s.shape for s in r_shapes["m"] + r_shapes["s"]]


def test_prefill_and_decode_match_reference(params):
    """Prefill logits and states, then three decode steps on identical
    states; decode after a prefill of S - 1 tokens equals the prefill of S
    (the reference's own check, run on the port)."""
    rm, pm = models(ARCH)
    pp = port_params(pm, params)
    rb, pb = batches(rm, pm, 12, 2, "prefill", seed=1)
    r_logits, r_states = jax.jit(rm.prefill)(params, rb)
    logits, states = pm.prefill(pp, pb)
    close(logits, r_logits, what="prefill logits")
    close_trees(states, r_states, "prefill states")
    states = place_prefill_caches(pm, states, 15)
    tokens = np.random.default_rng(3).integers(0, pm.cfg.vocab, (3, 2, 1))
    r_decode = jax.jit(rm.decode)
    for i in range(3):
        r_logits, r_states = r_decode(
            params, {"tokens": jnp.asarray(tokens[i], jnp.int32),
                     "pos": jnp.asarray(12 + i, jnp.int32)}, r_states)
        logits, states = pm.decode(pp, {"tokens": torch.as_tensor(
            tokens[i], dtype=torch.int32), "pos": 12 + i}, states)
        close(logits, r_logits, what=f"decode step {i}")
    close_trees(states, r_states, "states after decode")

    full, _ = pm.prefill(pp, pb)
    _, st = pm.prefill(pp, {"tokens": pb["tokens"][:, :-1]})
    last, _ = pm.decode(pp, {"tokens": pb["tokens"][:, -1:], "pos": 11}, st)
    np.testing.assert_allclose(last.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("use_pallas,remat", [(False, False), (True, True)])
def test_loss_and_every_gradient_match_reference(params, ref_grads,
                                                 use_pallas, remat):
    """With remat the group and each mLSTM layer inside it are
    checkpointed (the reference's nesting); no number changes.

    The input-gate bias b_i is held against the scale of its gate's
    gradient: the mLSTM's output is num / max(|norm|, e^-m), and a shift of
    a head's log input gate moves num, norm and m alike, so wherever
    |norm| > e^-m the loss does not depend on b_i, and its exact gradient
    there is 0. Both frameworks then return the float32 rounding of a sum
    of terms that cancel (1e-7 here), terms as large as those of w_i's
    gradient (the same sum, each term times h). So b_i gets an atol of 1e-4
    of w_i's gradient's largest value; every other leaf the usual rule."""
    _, pm = models(ARCH, use_pallas=use_pallas, remat=remat)
    pb = pm.make_batch(ShapeConfig("s", 16, 2, "train"), seed=2, device="cpu")
    _, r_loss, r_grads = ref_grads
    r_grads = jax.tree.map(np.asarray, r_grads)
    loss, grads = port_loss_grads(pm, port_params(pm, params), pb)
    close(loss, r_loss, what="loss")
    b_i, r_b_i = grads["mlstm"]["cell"].pop("b_i"), r_grads["mlstm"]["cell"].pop("b_i")
    np.testing.assert_allclose(
        b_i.numpy(), np.asarray(r_b_i), rtol=1e-4,
        atol=1e-4 * float(np.abs(np.asarray(r_grads["mlstm"]["cell"]["w_i"])).max()))
    grads["mlstm"]["cell"]["b_i"] = b_i         # counted by close_grads
    r_grads["mlstm"]["cell"]["b_i"] = np.asarray(b_i)
    close_grads(grads, r_grads)


def test_generate_matches_reference(params):
    rm, pm = models(ARCH)
    rb, pb = batches(rm, pm, 6, 2, "prefill", seed=3)
    want, _ = r_generate(rm, params, rb, 4)
    got, _ = generate(pm, port_params(pm, params), pb, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
