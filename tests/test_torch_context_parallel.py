"""Context-parallel attention (``repro_torch.models.attention``): B2's
log-sum-exp output, the merge of partial softmaxes (``merge_partials``) and
the attention on each rank's own key shard (``_on_key_shards``), which the
port runs where the reference's ``_qkv`` shards K/V over the sequence (a
model axis that divides neither head count).

(a) ``attention_ref(return_lse=True)`` against a float64 ``torch.logsumexp``
    over the masked, scaled scores, rows that see no key included (-inf,
    with finite gradients); its o against the reference's jnp
    ``attention_ref`` at tests/test_kernels.py's tolerances.
(b) The keys cut into 2 and 4 shards, each through ``flash_attention`` (its
    plain version here) and ``_sdpa`` with its offset, merged over a stacked
    dimension: held to the whole-key version at rtol 1e-9 in float64,
    forward and q / k / v gradients, and to the reference's ``_sdpa`` in
    float32 (rtol 2e-4, atol 2e-5).
(c) On 4 gloo ranks, a 2 x 2 ("data", "model") mesh, fault F1's reduced
    smollm-360m (3 query heads over 1 KV head) under ``2d``, ``tp``,
    ``zero3`` and ``sp``: ``attend_train`` (through B2's plain version and
    through ``_sdpa``, with its gradients) and ``attend_prefill`` (with its
    K/V) held to one device at rtol 1e-9 in float64 (``_gloo.attention_run``);
    the prefill's K keeps its sequence shard.
(d) The cost counter on a fake (2, 2) mesh, one ``attend_train`` of that
    model: the attention core's matmul FLOPs a rank are half the parent's
    route's (which gathered K/V and ran the whole attention on each rank),
    and no all-gather carries K/V over the model dimension.
"""
from __future__ import annotations

import math
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _gloo import (CP_BATCH, CP_OVERRIDES, CP_SEQ, CP_STRATEGIES,
                   attention_run, context_parallel_apart, mesh_config, result,
                   run_world)
from _mesh_cells import fake_mesh
from repro.kernels.attention import attention_ref as r_attention_ref
from repro.models.attention import _sdpa as r_sdpa
from repro_torch.kernels.attention import attention_ref, flash_attention
from repro_torch.models.attention import _sdpa, merge_partials, stacked

F32 = dict(rtol=2e-4, atol=2e-5)          # tests/test_kernels.py's
F64 = dict(rtol=1e-9, atol=1e-9)
# the reference's five shapes (B, Hq, Hkv, Sq, Skv, D, causal)
SHAPES = [(2, 4, 2, 64, 64, 32, True),
          (1, 2, 2, 33, 33, 16, True),
          (2, 8, 2, 17, 40, 8, False),
          (1, 4, 1, 128, 128, 64, True),
          (1, 2, 1, 16, 48, 8, True)]
# (B, Hq, Hkv, S, D): GQA groups of 3, and one sequence longer than
# _sdpa's query chunk of 512
SPLITS = [(2, 6, 2, 48, 16), (1, 2, 1, 1024, 8)]


def _arrays(*shapes, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) for s in shapes]


def _lse64(q, k, causal, kv_offset):
    """ln sum exp over each row's valid keys of the scaled scores, float64,
    -inf where none is valid: the definition, written out."""
    B, Hq, Sq, D = q.shape
    Skv = k.shape[2]
    kk = np.repeat(k, Hq // k.shape[1], axis=1)
    s = torch.from_numpy(np.einsum("bhqd,bhkd->bhqk", q / math.sqrt(D), kk))
    if causal:
        off = Skv - Sq if kv_offset is None else kv_offset
        valid = (np.arange(Sq)[:, None] + off) >= np.arange(Skv)[None, :]
        s = s.masked_fill(~torch.from_numpy(valid), -math.inf)
    return torch.logsumexp(s, dim=-1).numpy()


# ------------------------------------------------------------------ (a)

@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", SHAPES)
def test_lse_is_the_log_sum_exp(B, Hq, Hkv, Sq, Skv, D, causal):
    q, k, v = _arrays((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
                      seed=B * 100 + Hq * 10 + Sq)
    o, lse = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           return_lse=True)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float64
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, causal, None),
                               rtol=1e-12, atol=1e-12)
    o32, lse32 = attention_ref(*(torch.from_numpy(a).float()
                                 for a in (q, k, v)), causal=causal,
                               return_lse=True)
    want = r_attention_ref(*(jnp.asarray(a, jnp.float32) for a in (q, k, v)),
                           causal=causal)
    np.testing.assert_allclose(o32.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(lse32.numpy(), lse.numpy(), **F32)
    # the lse option changes nothing of o
    assert torch.equal(o32, attention_ref(*(torch.from_numpy(a).float()
                                            for a in (q, k, v)),
                                          causal=causal))


@pytest.mark.parametrize("kv_offset", [-4, -11, 3])
def test_rows_that_see_no_key(kv_offset):
    """A negative offset hides every key from the first rows: their lse is
    -inf and their o 0, and the gradients of o and of the finite lse are
    finite everywhere."""
    q, k, v, g, h = _arrays((1, 4, 12, 8), (1, 2, 10, 8), (1, 2, 10, 8),
                            (1, 4, 12, 8), (1, 4, 12), seed=7)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = flash_attention(qt, kt, vt, causal=True, kv_offset=kv_offset,
                             return_lse=True)
    want = _lse64(q, k, True, kv_offset)
    np.testing.assert_allclose(lse.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    hidden = max(0, -kv_offset)
    assert bool(torch.isneginf(lse[:, :, :hidden]).all())
    assert bool(torch.isfinite(lse[:, :, hidden:]).all())
    assert not bool(o[:, :, :hidden].any())
    seen = torch.isfinite(lse)
    loss = (o * torch.from_numpy(g)).sum() + (
        lse[seen] * torch.from_numpy(h)[seen]).sum()
    grads = torch.autograd.grad(loss, (qt, kt, vt))
    assert all(bool(torch.isfinite(t).all()) for t in grads)
    assert not bool(grads[0][:, :, :hidden].any())


# ------------------------------------------------------------------ (b)

def _split(fn, k, v, m: int, seq_dim: int):
    """fn(k shard, v shard, start) over m shards of the key sequence,
    each (o, lse), stacked."""
    n = k.shape[seq_dim] // m
    parts = [fn(k.narrow(seq_dim, r * n, n), v.narrow(seq_dim, r * n, n),
                r * n) for r in range(m)]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]))


def _routes(q, k, v):
    """{route: (whole-key o, merged o of 2 shards, of 4 shards)} through
    B2's wrapper (its plain version: kernel layout (B, H, S, D)) and
    through ``_sdpa`` (the model's (B, S, H, D))."""
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
    b2 = [flash_attention(q, k, v, causal=True)] + [
        merge_partials(*_split(lambda ks, vs, st: flash_attention(
            q, ks, vs, causal=True, kv_offset=-st, return_lse=True),
            k, v, m, 2), stacked) for m in (2, 4)]
    sdpa = [_sdpa(qm, km, vm, causal=True)] + [
        merge_partials(*_split(lambda ks, vs, st: _sdpa(
            qm, ks, vs, causal=True, q_offset=-st, return_lse=True),
            km, vm, m, 1), stacked) for m in (2, 4)]
    return {"b2": b2, "sdpa": [t.transpose(1, 2) for t in sdpa]}


@pytest.mark.parametrize("B,Hq,Hkv,S,D", SPLITS)
def test_split_keys_merge_to_the_whole(B, Hq, Hkv, S, D):
    q, k, v, g = _arrays((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D),
                         (B, Hq, S, D), seed=S + Hq)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    for route, (whole, *merged) in _routes(*ins).items():
        want = torch.autograd.grad((whole * torch.from_numpy(g)).sum(), ins)
        for m, got in zip((2, 4), merged):
            what = f"{route} over {m} key shards"
            torch.testing.assert_close(got, whole, **F64, msg=what)
            grads = torch.autograd.grad((got * torch.from_numpy(g)).sum(),
                                        ins, retain_graph=True)
            for name, a, b in zip("qkv", grads, want):
                torch.testing.assert_close(a, b, **F64, msg=f"{what} d{name}")


@pytest.mark.parametrize("B,Hq,Hkv,S,D", SPLITS)
def test_split_keys_match_the_reference_sdpa(B, Hq, Hkv, S, D):
    q, k, v = (a.astype(np.float32) for a in _arrays(
        (B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D), seed=S + 2 * Hq))
    want = np.asarray(r_sdpa(None, *map(jnp.asarray, (q, k, v)),
                             causal=True))
    t = [torch.from_numpy(a).transpose(1, 2) for a in (q, k, v)]
    with torch.no_grad():
        for route, (_, *merged) in _routes(*t).items():
            for m, got in zip((2, 4), merged):
                np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                           **F32, err_msg=f"{route}/{m}")


# ------------------------------------------------------------------ (c)

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("context_parallel", 4,
                     tmp_path_factory.mktemp("context_parallel"),
                     strategies=CP_STRATEGIES)


@pytest.fixture(scope="module")
def one_device():
    return attention_run(None)


@pytest.mark.parametrize("strategy", CP_STRATEGIES)
def test_mesh_matches_one_device(world, one_device, strategy):
    got = result(world, strategy)
    apart = context_parallel_apart(got, one_device)
    assert max(apart.values()) <= 1.0, {k: a for k, a in apart.items()
                                        if a > 1.0}
    # the prefill's K stays sharded over the sequence on the model axis
    assert got["prefill_k_placements"] == ["S(0)", "S(1)"]
    for rank in range(1, 4):
        assert context_parallel_apart(result(world, strategy, rank),
                                      got) == pytest.approx(
            dict.fromkeys(apart, 0.0))


# ------------------------------------------------------------------ (d)

class _Gathers(TorchDispatchMode):
    """Records each all-gather's input shape and process group name."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if "all_gather" in func._opname:
            group = [a for a in (*args, *kwargs.values())
                     if isinstance(a, str)]
            self.seen.append((tuple(args[0].shape), group[-1]))
        return func(*args, **kwargs)


def _count_attend_train(parent_route: bool, monkeypatch) -> dict:
    """One ``attend_train`` of the F1 config under ``2d`` on a fake (2, 2)
    mesh (rank 0), counted: the whole call, the core's own count (the
    inputs B2's wrapper saw, through its plain version), the all-gathers
    and the model dimension's group name."""
    from repro_torch.core.hlo_analysis import count_program
    from repro_torch.kernels.watch import watching
    from repro_torch.models import attention
    from repro_torch.models.common import (init_params, logical_axes,
                                           rope_cos_sin)
    from repro_torch.sharding.context import activation_sharding
    from repro_torch.sharding.rules import (STRATEGIES, distribute,
                                            distribute_tree, placements,
                                            spec_for_axes, tree_shardings)

    cfg = mesh_config("smollm-360m", **CP_OVERRIDES)
    if parent_route:             # K/V gathered, the whole attention a rank
        def gathered(kernel, q, k, v, cos, sin):
            fn, args = attention._core_on_shards(
                partial(attention._attend_core, cfg), q, k, v, cos, sin)
            return fn(*args), None
        monkeypatch.setattr(attention, "_on_key_shards", gathered)
    specs = attention.attn_specs(cfg)
    params = init_params(specs, 0, "cpu")
    x = torch.zeros(CP_BATCH, CP_SEQ, cfg.d_model)
    cos, sin = rope_cos_sin(torch.arange(CP_SEQ)[None].expand(CP_BATCH, -1),
                            cfg.resolved_head_dim, cfg.rope_theta)
    cores = []
    with fake_mesh((2, 2)) as mesh:
        params = distribute_tree(params, mesh, tree_shardings(
            logical_axes(specs), mesh, "2d", params))
        x = distribute(x, mesh, placements(spec_for_axes(
            ("act_batch", "act_seq", "act_embed"), STRATEGIES["2d"], mesh,
            tuple(x.shape)), mesh))
        gathers = _Gathers()
        with activation_sharding(mesh, "2d"), watching(
                lambda name, inputs, out: cores.append(inputs)), gathers:
            run = count_program(attention.attend_train, cfg, params, x, cos,
                                sin)
        model_group = mesh.get_group("model").group_name
    assert len(cores) == 1
    c = cores[0]
    core = count_program(attention_ref, c["q"], c["k"], c["v"],
                         causal=c["causal"], kv_offset=c["kv_offset"],
                         return_lse=c["return_lse"])
    return {"run": run, "core": core, "gathers": gathers.seen,
            "model_group": model_group, "k_shape": tuple(c["k"].shape)}


def test_cost_counter_sees_half_the_core_and_no_kv_gather(monkeypatch):
    cp = _count_attend_train(False, monkeypatch)
    parent = _count_attend_train(True, monkeypatch)
    # the core's matmul FLOPs a rank halve (every query, half the keys)
    assert cp["core"].library_flops == 0.5 * parent["core"].library_flops
    ratio = cp["core"].costs.flops / parent["core"].costs.flops
    assert 0.5 <= ratio <= 0.55, ratio
    # K/V's local shard, (batch / 2, heads, seq / 2, head_dim) in B2's
    # layout; the parent gathered K and V over the model axis, the
    # context-parallel route gathers neither
    B, H, S, D = cp["k_shape"]
    assert parent["k_shape"] == (B, H, 2 * S, D)
    kv = (B, S, H, D)

    def kv_gathers(got):
        return [g for g in got["gathers"]
                if g == (kv, got["model_group"])]
    assert len(kv_gathers(parent)) == 2, parent["gathers"]
    assert kv_gathers(cp) == [], cp["gathers"]
    # the merge's all-reduces take their place
    assert cp["run"].costs.collective_counts.get("all-reduce", 0) >= 3
