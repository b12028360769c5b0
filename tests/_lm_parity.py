"""Shared helpers of the LM-family parity tests (``test_torch_lm.py``,
``test_torch_moe.py``, ``test_torch_xlstm.py``, ``test_torch_encdec.py``):
the reference's parameters with their constant leaves perturbed, carried
into the port, and the cross-framework tolerance.

Tolerance across frameworks in float32, as in tests/test_torch_zamba.py:
rtol 1e-4 plus an atol of 1e-4 of the tensor's largest magnitude (entries
that cancel to near zero carry an absolute error of a few float32 ulps of
the largest one)."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.configs import reduced as r_reduced
from repro.configs.base import ShapeConfig as RShape
from repro.models.registry import build_model as r_build
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.convert import lm_params_from_arrays
from repro_torch.models.common import leaves, tree_map
from repro_torch.models.registry import build_model
from repro_torch.train.step import loss_and_grads

TOL = 1e-4


def close(got, want, tol=TOL, what=""):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def paths(tree):
    """[(path of keys, numpy leaf)] of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(p.key for p in path), np.asarray(a)) for path, a in flat]


def at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def models(arch: str, **changes):
    """(reference bundle, port bundle) of ``reduced(arch)`` with the same
    ``changes`` on both sides."""
    return (r_build(replace(r_reduced(R_ARCHS[arch]), **changes)),
            build_model(replace(reduced(ARCHS[arch]), **changes)))


def ref_params(arch: str, seed: int = 0, **changes):
    """The reference's ``init`` as numpy, every leaf that ``init`` makes
    constant perturbed by seeded normal noise, so no path is exercised only
    at its initial value: the ones (norm gains, forget-gate biases) by 0.1
    x noise, as tests/test_torch_zamba.py perturbs its norms, the zeros
    (biases) by 0.02 x noise, as it perturbs its zero LoRA factors. Biases
    of 0.1 would outweigh the reduced models' activations (about 0.04) in
    q and k: then every query scores every key almost alike, and the f32
    gradient of the reduced VLM is ill-conditioned. The reference's own
    q/k gradients there move by 2e-4 of their largest value when its norm
    outputs move by one float32 ulp, twice the tolerance."""
    rm, _ = models(arch, **changes)
    tree = jax.tree.map(np.asarray, rm.init(jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten(tree)

    def perturb(a):
        if a.size > 1 and np.all(a == a.flat[0]):
            scale = 0.02 if a.flat[0] == 0 else 0.1
            return a + scale * rng.normal(size=a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_unflatten(treedef, [perturb(a) for a in flat])


def ulp_sensitivity(rm, params, batch, want, module, norm: str,
                    skip: tuple = ()) -> float:
    """How far the reference's own gradients move, as a share of each
    leaf's largest value (the tolerance's scale), when every output of the
    norm ``module.<norm>`` is scaled by 1 + 2^-22, about one float32 ulp.
    The reduced models at the reference's init can be ill-conditioned in
    float32 (its init scales a stacked matrix by 1/sqrt of its layer axis,
    so activations and gate pre-activations come out several times larger
    than 1/sqrt(fan_in) would make them): where a one-ulp nudge moves the
    reference's gradients by more than the tolerance, no float32
    implementation can be held to it there. The gradient tests run at a
    parameter seed where this stays below the tolerance. ``want``: the
    reference's gradients at ``params``; leaves named in ``skip`` are left
    out."""
    orig = getattr(module, norm)

    def nudged(*args, **kw):
        return orig(*args, **kw) * jnp.float32(1 + 2.0 ** -22)
    setattr(module, norm, nudged)
    try:
        _, moved = ref_loss_grads(rm, params, batch)
    finally:
        setattr(module, norm, orig)
    return max(float(np.abs(a - at(moved, path)).max() / np.abs(a).max())
               for path, a in paths(want)
               if np.abs(a).max() > 0 and path[-1] not in skip)


def port_params(pm, params):
    return lm_params_from_arrays(pm.specs, params, device="cpu")


def batches(rm, pm, seq_len: int, batch: int, kind: str, seed: int):
    """The reference's and the port's ``make_batch`` of one shape."""
    return (rm.make_batch(RShape("s", seq_len, batch, kind), seed=seed),
            pm.make_batch(ShapeConfig("s", seq_len, batch, kind), seed=seed,
                          device="cpu"))


def ref_loss_grads(rm, params, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(rm.loss, has_aux=True))(
        params, batch)
    return loss, grads


def port_loss_grads(pm, pp, batch):
    """(loss, gradient tree shaped as the params)."""
    loss, grads = loss_and_grads(pm, pp, batch)
    it = iter(grads)
    return loss, tree_map(lambda _, __: next(it), pp)


def close_grads(got, want):
    checked = 0
    for path, a in paths(want):
        close(at(got, path), a, what="/".join(path))
        checked += 1
    assert checked == len(leaves(got))


def pad_seq(pair, steps: int):
    """A reference (k, v) cache pair grown by ``steps`` zero positions on
    axis 2."""
    return tuple(jnp.pad(a, ((0, 0), (0, 0), (0, steps), (0, 0), (0, 0)))
                 for a in pair)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_numpy(v) for v in tree)
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def close_trees(got, want, what=""):
    """Every leaf of a port cache tree beside the reference's."""
    got, want = to_numpy(got), want
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (what, sorted(got), sorted(want))
        for k in want:
            close_trees(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            close_trees(g, w, f"{what}/{i}")
    else:
        close(got, want, what=what)
