"""The norms' float32 work and a prefill's caches held once (fault F24,
ROADMAP section 3; ``models/common.py``, ``sharding/context.py::
LayerStack``).

Without a gradient, ``in_row_chunks`` normalizes a chunk of rows at a time
(the mesh path's serving norms): each row's numbers are the whole call's,
so the output equals the parent's formula, ``(f32(x) * rsqrt(mean(f32(x)^2)
+ eps)).to(x.dtype) * w``, bit for bit, in bfloat16 and float32. With a
gradient, ``_RMSNorm`` and ``_LayerNorm`` keep x in its own dtype and the
(..., 1) float32 statistics for their backward: their forward is the
parent's to the bit, their backward passes float64 ``gradcheck``, and both
are held to the reference's ``rms_norm`` / ``layer_norm`` under
``jax.grad`` at ``tests/_lm_parity.py``'s tolerance. A plain-tensor
prefill of reduced smollm-360m and zamba2-2.7b gives the logits and caches
of the parent's construction (each layer's K/V, conv and SSM states kept
in lists and stacked at the end) bit for bit."""
import numpy as np
import pytest
import torch

from _lm_parity import close
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import common as C
from repro_torch.models import lm, zamba
from repro_torch.models.registry import build_model
from repro_torch.sharding.context import project

EPS = 1e-5
# (rows, width): the first is split into chunks (at least ROW_MIN
# elements), the second runs whole
SHAPES = [(3, 700, 1024), (5, 37)]


def _parent_rms(x, w, eps=EPS):
    xf = C.f32(x)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _parent_layer(x, w, b, eps=EPS):
    xf = C.f32(x)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return out.to(x.dtype) * w.to(x.dtype) + b.to(x.dtype)


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = torch.from_numpy(3.0 * rng.standard_normal(shape) + 0.5).to(dtype)
    w = torch.from_numpy(1.0 + 0.1 * rng.standard_normal(d)).float()
    b = torch.from_numpy(0.1 * rng.standard_normal(d)).float()
    return x, w, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_row_chunks_equal_the_whole(dtype, shape):
    x, w, b = _inputs(shape, dtype)
    rows = int(np.prod(shape[:-1]))
    assert (C.row_chunk(rows, shape[-1]) < rows) == (x.numel() >= C.ROW_MIN)
    got = C.in_row_chunks(C._rms_rows, x, EPS) * w.to(dtype)
    assert torch.equal(got, _parent_rms(x, w))
    got = C.in_row_chunks(C._layer_rows, x, EPS) * w.to(dtype) + b.to(dtype)
    assert torch.equal(got, _parent_layer(x, w, b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("grad", [False, True])
def test_norms_forward_equal_the_parent(dtype, grad):
    x, w, b = _inputs(SHAPES[0], dtype, seed=1)
    x.requires_grad_(grad)
    with torch.no_grad():
        want_rms, want_layer = _parent_rms(x, w), _parent_layer(x, w, b)
    assert torch.equal(C.rms_norm(x, w, EPS).detach(), want_rms)
    assert torch.equal(C.layer_norm(x, w, b, EPS).detach(), want_layer)


@pytest.mark.parametrize("fn", [C._RMSNorm, C._LayerNorm],
                         ids=["rms", "layer"])
def test_gradcheck(fn):
    x, _, _ = _inputs((3, 4, 9), torch.float64, seed=2)
    x.requires_grad_()
    assert torch.autograd.gradcheck(lambda t: fn.apply(t, EPS), (x,))


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_forward_and_gradient_against_the_reference(kind):
    import jax
    import jax.numpy as jnp

    from repro.models import common as R

    x, w, b = _inputs((4, 16, 96), torch.float32, seed=3)
    g = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    xr, wr, br = (jnp.asarray(t.numpy()) for t in (x, w, b))
    if kind == "rms":
        def ref(x_, w_, b_):
            return R.rms_norm(x_, w_, EPS)

        def port(x_, w_, b_):
            return C.rms_norm(x_, w_, EPS)
    else:
        def ref(x_, w_, b_):
            return R.layer_norm(x_, w_, b_, EPS)

        def port(x_, w_, b_):
            return C.layer_norm(x_, w_, b_, EPS)
    want = ref(xr, wr, br)
    want_grads = jax.grad(lambda *a: jnp.sum(ref(*a) * g), argnums=(0, 1, 2))(
        xr, wr, br)
    ins = [t.clone().requires_grad_() for t in (x, w, b)]
    got = port(*ins)
    close(got.detach().numpy(), np.asarray(want), what=f"{kind} forward")
    grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(), ins,
                                allow_unused=True)
    for name, a, r in zip("xwb", grads, want_grads):
        if kind == "rms" and name == "b":
            continue
        close(a.numpy(), np.asarray(r), what=f"{kind} d{name}")


def _lm_parent_prefill(cfg, params, batch):
    """The parent's prefill of a decoder-only LM: each layer's K/V kept in
    lists and stacked at the end."""
    x, s_img = lm._embed_inputs(cfg, params, batch)
    cos, sin = lm._tables(cfg, lm._positions(cfg, x, s_img,
                                             batch["tokens"].shape[1]),
                          x.shape[0])
    ks, vs = [], []
    for lp in C.unstack(params["blocks"]):
        x, (k, v), _ = lm._block_apply(cfg, lm._cast_block(cfg, lp), x, cos,
                                       sin, "prefill")
        ks.append(k)
        vs.append(v)
    return lm._logits(cfg, params, x[:, -1:]), (torch.stack(ks),
                                                torch.stack(vs))


def _zamba_parent_prefill(cfg, params, batch):
    """The parent's prefill of zamba2: each Mamba layer's states and each
    shared block's K/V kept in lists and stacked at the end."""
    x = zamba._embed(cfg, params, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    cos, sin = C.rope_cos_sin(positions, cfg.resolved_head_dim,
                              cfg.rope_theta)
    groups = [C.unstack(g) for g in C.unstack(params["mamba"])]
    convs, ssms, ks, vs = [], [], [], []
    for layers, lora in zip(groups, C.unstack(params["lora"])):
        for lp in layers:
            out, (nc, ns) = zamba.mamba_mix(cfg, lp["mix"], C.rms_norm(
                x, lp["ln"], cfg.norm_eps))
            convs.append(nc)
            ssms.append(ns)
            x = x + out
        x, (k, v) = zamba._shared_block(cfg, params["shared"], lora, x, cos,
                                        sin, "prefill")
        ks.append(k)
        vs.append(v)
    G, E = len(groups), len(groups[0])
    caches = {"conv": torch.stack(convs).unflatten(0, (G, E)),
              "ssm": torch.stack(ssms).unflatten(0, (G, E)),
              "kv": (torch.stack(ks), torch.stack(vs))}
    x = C.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    return project(x, params["lm_head"]), caches


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch,parent", [
    ("smollm-360m", _lm_parent_prefill),
    ("zamba2-2.7b", _zamba_parent_prefill)])
def test_plain_prefill_equals_the_parents_construction(arch, parent):
    from repro_torch.configs.base import ShapeConfig

    model = build_model(reduced(ARCHS[arch]))
    params = model.init(0, "cpu")
    batch = model.make_batch(ShapeConfig("s", 24, 2, "prefill"), seed=5,
                             device="cpu")
    with torch.no_grad():
        logits, caches = model.prefill(params, batch)
        want_logits, want_caches = parent(model.cfg, params, batch)
    assert torch.equal(logits, want_logits)
    got, want = _leaves(caches), _leaves(want_caches)
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(a, b)
