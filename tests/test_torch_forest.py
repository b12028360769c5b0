"""The port's torch inference paths (``repro_torch.core.forest_torch``)
against the reference's JAX paths (``repro.core.forest_jax``), on the same
forest and rows, within rtol 1e-5: the walks are the same, only the float32
order of the mean over trees may differ."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import ExtraTreesRegressor
from repro.core.forest_jax import (DenseForestJax, FlatForestJax,
                                   dense_leaf_sum as r_leaf_sum)
from repro_torch.core import convert
from repro_torch.core.forest_torch import (DenseForestTorch, FlatForestTorch,
                                           dense_leaf_sum, resolve_device,
                                           to_dense)

RTOL = 1e-5


@pytest.fixture(scope="module")
def fitted():
    """The reference's own kernel fixture (tests/test_kernels.py), fitted
    by the reference and carried into the port."""
    rng = np.random.default_rng(0)
    X = rng.lognormal(1, 1.5, size=(150, 12)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3) + 0.1 * rng.normal(size=150)
    ref = ExtraTreesRegressor(n_estimators=12, seed=2).fit(X, y)
    port = convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())
    return ref, port


def _rows(seed, n=20):
    rng = np.random.default_rng(seed)
    return rng.lognormal(1, 1.5, size=(n, 12)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 7, 20])
def test_flat_torch_matches_flat_jax(fitted, n):
    ref, port = fitted
    X = _rows(4, n)
    got = FlatForestTorch(port.to_flat(), device="cpu")(X)
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = np.asarray(FlatForestJax(ref.to_flat())(X))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), ref.predict(X), rtol=RTOL)


@pytest.mark.parametrize("depth", [2, 6, 10, 14])
def test_dense_torch_matches_dense_jax(fitted, depth):
    ref, port = fitted
    X = _rows(depth)
    from repro.core.forest_jax import to_dense as r_to_dense
    got = DenseForestTorch(to_dense(port, depth), device="cpu")(X).numpy()
    want = np.asarray(DenseForestJax(r_to_dense(ref, depth))(X))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_dense_leaf_sum_matches(fitted):
    ref, port = fitted
    X = _rows(5)
    d = to_dense(port, 8)
    got = dense_leaf_sum(torch.as_tensor(d.feature),
                         torch.as_tensor(d.threshold),
                         torch.as_tensor(d.value), torch.as_tensor(X), 8)
    want = r_leaf_sum(jnp.asarray(d.feature), jnp.asarray(d.threshold),
                      jnp.asarray(d.value), jnp.asarray(X), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


def test_deep_dense_is_exact_on_shallow_trees():
    rng = np.random.default_rng(1)
    X = rng.lognormal(1, 1.5, size=(80, 12)).astype(np.float32)
    y = np.log(X[:, 1] + 1)
    from repro_torch.core.forest import ExtraTreesRegressor as PortTrees
    est = PortTrees(n_estimators=5, max_depth=4, seed=0).fit(X, y)
    got = DenseForestTorch(to_dense(est, 6), device="cpu")(X).numpy()
    np.testing.assert_allclose(got, est.predict(X), rtol=RTOL)


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
