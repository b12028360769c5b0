"""The port's MoE layer (``repro_torch.models.moe``) and the MoE LMs
(granite-moe, olmoe, through ``models/lm.py``) against the reference, at
``reduced(...)`` in float32.

Routing is held exactly: the same top-k experts per token (ties included)
and, at a capacity that drops tokens, the same dispatched buffer, bit for
bit (the same tokens kept, in the same slots, the same dropped). Output,
aux loss, logits, caches, loss and gradients are held at rtol 1e-4 plus an
atol of 1e-4 of each tensor's largest magnitude (``tests/_lm_parity.py``),
the parameters the reference's ``init`` with its constant leaves
perturbed."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.lm as r_lm
import repro.models.moe as r_moe
from _lm_parity import (TOL, batches, close, close_grads, close_trees,
                        models, pad_seq, port_loss_grads, port_params,
                        ref_loss_grads, ref_params, ulp_sensitivity)
from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.configs.base import ShapeConfig as RShape
from repro.launch.serve import generate as r_generate
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.serve import generate, place_prefill_caches
from repro_torch.models import moe

MOE = sorted(a for a, c in ARCHS.items() if c.family == "moe")


def _layer(arch, seed, router=None, **changes):
    """A reduced config (``changes`` on both sides), its MoE parameters as
    numpy (normal draws at the specs' scales; ``router`` replaces the
    router) and one batch of activations x (2, 64, d)."""
    cfg = replace(reduced(ARCHS[arch]), **changes)
    rng = np.random.default_rng(seed)
    p = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[-2])).astype(np.float32)
         for k, s in moe.moe_specs(cfg).items()}
    if router is not None:
        p["router"] = router
    x = rng.normal(size=(2, 64, cfg.d_model)).astype(np.float32)
    return cfg, p, x


def _ref_run(monkeypatch, cfg, p, x):
    """The reference's moe_apply run eagerly, recording what its
    ``lax.top_k`` returned and each choice's dispatched buffer."""
    seen = {"top_k": [], "buf": []}
    top_k = jax.lax.top_k

    def rec_top_k(a, k):
        out = top_k(a, k)
        seen["top_k"].append(tuple(np.asarray(o) for o in out))
        return out

    def rec_buf(a, name):
        seen["buf"].append(np.asarray(a))
        return a
    monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
    monkeypatch.setattr(r_moe, "checkpoint_name", rec_buf)
    rcfg = replace(r_reduced(R_ARCHS[cfg.name.removesuffix("-reduced")]),
                   capacity_factor=cfg.capacity_factor,
                   n_experts=cfg.n_experts, experts_per_tok=cfg.experts_per_tok)
    out, aux = r_moe.moe_apply(rcfg, jax.tree.map(jnp.asarray, p),
                               jnp.asarray(x))
    return np.asarray(out), float(aux), seen


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
def test_routing_drops_and_output_match_reference(arch, capacity_factor,
                                                  monkeypatch):
    cfg, p, x = _layer(arch, 0, capacity_factor=capacity_factor)
    r_out, r_aux, seen = _ref_run(monkeypatch, cfg, p, x)
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    xt = torch.as_tensor(x).reshape(-1, cfg.d_model)
    _, top_p, top_e = moe.route(cfg, tp, xt)
    (r_top_p, r_top_e), = seen["top_k"]
    np.testing.assert_array_equal(top_e.numpy(), r_top_e)
    close(top_p * top_p.new_ones(()), r_top_p / np.maximum(
        r_top_p.sum(-1, keepdims=True), 1e-9), what="top_p")
    cap = moe.capacity(cfg, xt.shape[0])
    kept = []
    for c, r_buf in enumerate(seen["buf"]):
        keep, slot = moe.dispatch_slots(top_e[:, c], cfg.n_experts, cap)
        buf = moe.dispatch(xt, top_e[:, c], keep, slot, cfg.n_experts, cap)
        np.testing.assert_array_equal(buf.numpy(), r_buf)
        kept.append(int(keep.sum()))
    assert len(kept) == cfg.experts_per_tok
    if capacity_factor < 1:                     # the capacity drops tokens
        assert min(kept) < xt.shape[0], kept
    out, aux = moe.moe_apply(cfg, tp, torch.as_tensor(x))
    close(out, r_out, what="out")
    close(aux, r_aux, what="aux")


def test_ties_route_to_the_lower_expert(monkeypatch):
    """Experts 1 and 2 (and 5 and 6) have the same router column, so every
    token's probabilities tie between them: ``lax.top_k`` lists the lower
    index first, and so does the port."""
    cfg, p, x = _layer("olmoe-1b-7b", 1)
    router = p["router"].copy()
    router[:, 2] = router[:, 1]
    router[:, 6] = router[:, 5]
    router[:, 1] *= 3                           # ties often at the top
    router[:, 2] = router[:, 1]
    p["router"] = router
    _, _, seen = _ref_run(monkeypatch, cfg, p, x)
    _, _, top_e = moe.route(cfg, {k: torch.as_tensor(v) for k, v in p.items()},
                            torch.as_tensor(x).reshape(-1, cfg.d_model))
    (_, r_top_e), = seen["top_k"]
    assert ((r_top_e == 1)[:, :1] & (r_top_e == 2)[:, 1:2]).any()
    np.testing.assert_array_equal(top_e.numpy(), r_top_e)


@pytest.mark.parametrize("T", [1, 2, 8, 9, 100, 128, 4096, 32768])
def test_capacity_matches_reference(T):
    """The capacity per expert: the reference's buffer has capacity + 1
    rows (read off its dispatched buffer's shape)."""
    cfg = reduced(ARCHS["granite-moe-3b-a800m"])
    rcfg = r_reduced(R_ARCHS["granite-moe-3b-a800m"])
    shapes = []
    r_moe.checkpoint_name, orig = (lambda a, name: shapes.append(a.shape) or a,
                                   r_moe.checkpoint_name)
    try:
        jax.eval_shape(lambda p, x: r_moe.moe_apply(rcfg, p, x),
                       jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                           s.shape, jnp.float32), r_moe.moe_specs(rcfg),
                           is_leaf=lambda s: hasattr(s, "axes")),
                       jax.ShapeDtypeStruct((1, T, rcfg.d_model), jnp.float32))
    finally:
        r_moe.checkpoint_name = orig
    assert shapes[0][1] == moe.capacity(cfg, T) + 1
    assert (moe.capacity(cfg, T) + 1) % 16 == 0


# ---------------------------------------------------------- through the LM

# The LM-level checks run at the parameters of seed 3, the first seed
# whose reference gradients move by less than the tolerance under a
# one-ulp nudge of every norm output (``_lm_parity.ulp_sensitivity``). At
# seed 0 that nudge moves the reference's own gradients by 2.6e-4 (olmoe)
# and 5.7e-4 (granite) of their largest values, and 5 of the 8192 entries
# of olmoe's layer-0 wq gradient land up to 2.1e-4 of the largest value
# off the reference's, where the tolerance is 1e-4.
SEED = 3


@pytest.fixture(scope="module")
def params():
    return {a: ref_params(a, seed=SEED) for a in MOE}


@pytest.fixture(scope="module")
def ref_grads(params):
    """The reference's (loss, gradients) of the training batch (16 x 2,
    seed 2), per arch."""
    out = {}
    for a in MOE:
        rm, _ = models(a)
        rb = rm.make_batch(RShape("s", 16, 2, "train"), seed=2)
        out[a] = (rm, rb, *ref_loss_grads(rm, params[a], rb))
    return out


@pytest.mark.parametrize("arch", MOE)
def test_reference_is_stable_at_the_seed(arch, params, ref_grads):
    rm, rb, _, want = ref_grads[arch]
    assert ulp_sensitivity(rm, params[arch], rb, want, r_lm, "rms_norm") < TOL


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch", MOE)
def test_loss_and_every_gradient_match_reference(arch, use_pallas, params,
                                                 ref_grads):
    """The loss adds 0.01 x the aux loss; gradients reach the router."""
    _, pm = models(arch, use_pallas=use_pallas)
    rm, rb, r_loss, r_grads = ref_grads[arch]
    pb = pm.make_batch(ShapeConfig("s", 16, 2, "train"), seed=2, device="cpu")
    loss, grads = port_loss_grads(pm, port_params(pm, params[arch]), pb)
    close(loss, r_loss, what="loss")
    close_grads(grads, r_grads)
    _, metrics = pm.loss(port_params(pm, params[arch]), pb)
    _, r_metrics = jax.jit(rm.loss)(params[arch], rb)
    close(metrics["aux_loss"], r_metrics["aux_loss"], what="aux")


@pytest.mark.parametrize("arch", MOE)
def test_prefill_decode_and_generate_match_reference(arch, params):
    """Prefill logits and caches, three decode steps on identical caches
    and positions, then greedy generate token for token."""
    rm, pm = models(arch)
    p = params[arch]
    pp = port_params(pm, p)
    rb, pb = batches(rm, pm, 12, 2, "prefill", seed=1)
    r_logits, r_caches = jax.jit(rm.prefill)(p, rb)
    logits, caches = pm.prefill(pp, pb)
    close(logits, r_logits, what="prefill logits")
    close_trees(caches, r_caches, "prefill caches")
    steps, S = 3, 12
    r_caches = pad_seq(r_caches, steps)
    caches = place_prefill_caches(pm, caches, S + steps)
    tokens = np.random.default_rng(3).integers(0, pm.cfg.vocab, (steps, 2, 1))
    r_decode = jax.jit(rm.decode)
    for i in range(steps):
        r_logits, r_caches = r_decode(
            p, {"tokens": jnp.asarray(tokens[i], jnp.int32),
                "pos": jnp.asarray(S + i, jnp.int32)}, r_caches)
        logits, caches = pm.decode(pp, {"tokens": torch.as_tensor(
            tokens[i], dtype=torch.int32), "pos": S + i}, caches)
        close(logits, r_logits, what=f"decode step {i}")
    close_trees(caches, r_caches, "caches after decode")

    rb, pb = batches(rm, pm, 6, 2, "prefill", seed=3)
    want, _ = r_generate(rm, p, rb, 4)
    got, _ = generate(pm, pp, pb, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
