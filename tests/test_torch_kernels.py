"""The port's forest kernel package (``repro_torch.kernels.forest``).

On the CPU ``forest_predict`` takes its plain version; it is held to the
reference's Pallas kernel (interpret mode, as tests/test_kernels.py runs it)
and to the reference's ``forest_predict_ref`` over the same sweep, at
rtol 1e-5 / atol 1e-6. The CUDA kernel itself runs only on a card: the one
``gpu`` test holds it to its plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import ExtraTreesRegressor
from repro.core.forest_jax import to_dense as r_to_dense
from repro.kernels.forest import forest_predict as r_forest_predict
from repro.kernels.forest import forest_predict_ref as r_forest_predict_ref
from repro_torch.core import convert
from repro_torch.core.forest_torch import to_dense
from repro_torch.kernels.forest import (forest_predict,
                                        forest_predict_from_dense,
                                        forest_predict_packed,
                                        forest_predict_ref, ops, pack_tables)
from repro_torch.kernels.forest.kernel import TREE_GROUP

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    X = rng.lognormal(1, 1.5, size=(150, 12)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3) + 0.1 * rng.normal(size=150)
    ref = ExtraTreesRegressor(n_estimators=12, seed=2).fit(X, y)
    port = convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())
    return ref, port


def _tables(dense):
    return (torch.as_tensor(dense.feature), torch.as_tensor(dense.threshold),
            torch.as_tensor(dense.value))


@pytest.mark.parametrize("depth", [2, 5, 8, 10])
@pytest.mark.parametrize("batch", [1, 7, 32])
def test_forest_predict_vs_reference(fitted, depth, batch):
    ref, port = fitted
    rng = np.random.default_rng(depth * 100 + batch)
    X = rng.lognormal(1, 1.5, size=(batch, 12)).astype(np.float32)
    dense = to_dense(port, depth)
    got = forest_predict(torch.as_tensor(X), *_tables(dense), depth=depth)
    assert got.dtype == torch.float32 and got.shape == (batch,)
    rd = r_to_dense(ref, depth)
    pallas = r_forest_predict(X, rd.feature, rd.threshold, rd.value,
                              depth=depth, block_b=8, block_t=8)
    oracle = r_forest_predict_ref(jnp.asarray(X), jnp.asarray(rd.feature),
                                  jnp.asarray(rd.threshold),
                                  jnp.asarray(rd.value), depth=depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=RTOL, atol=ATOL)


def test_deep_dense_approaches_exact(fitted):
    _, port = fitted
    rng = np.random.default_rng(3)
    X = rng.lognormal(1, 1.5, size=(32, 12)).astype(np.float32)
    out = forest_predict_from_dense(to_dense(port, 14), torch.as_tensor(X))
    assert np.abs(out.numpy() - port.predict(X)).max() < 0.05


def test_nonfinite_rows_follow_ref(fitted):
    """ref.py's semantics, not the Pallas kernel's: a NaN goes right and an
    inf in a column the node does not test leaves the walk alone."""
    ref, port = fitted
    depth = 8
    rng = np.random.default_rng(5)
    X = rng.lognormal(1, 1.5, size=(6, 12)).astype(np.float32)
    X[0, :] = np.nan
    X[1, 3] = np.inf
    X[2, 5] = -np.inf
    X[3, 0] = np.nan
    got = forest_predict(torch.as_tensor(X), *_tables(to_dense(port, depth)),
                         depth=depth).numpy()
    rd = r_to_dense(ref, depth)
    want = np.asarray(r_forest_predict_ref(
        jnp.asarray(X), jnp.asarray(rd.feature), jnp.asarray(rd.threshold),
        jnp.asarray(rd.value), depth=depth))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got).all()


def _pad(tables, rows):
    """The contract's inert trees: feature 0, threshold +inf, value 0."""
    f, t, v = tables
    n, N = f.shape
    return (torch.cat([f, f.new_zeros((rows - n, N))]),
            torch.cat([t, t.new_full((rows - n, N), float("inf"))]),
            torch.cat([v, v.new_zeros((rows - n, N))]))


@pytest.mark.parametrize("n_trees", [1, 12])
def test_padding_contract(fitted, n_trees):
    """Inert padded trees (feature 0, threshold +inf, value 0) change
    nothing when the sum is divided by the real tree count: past
    ``n_trees`` the tables are never read, and the packed tables pad to
    the kernel's tree group with inert trees of their own."""
    _, port = fitted
    dense = to_dense(port, 6, n_trees=n_trees)
    X = torch.as_tensor(np.random.default_rng(6).lognormal(
        1, 1.5, size=(9, 12)).astype(np.float32))
    f, t, v = _pad(_tables(dense), 3 * TREE_GROUP + 1)
    plain = forest_predict(X, *_tables(dense), depth=6)
    padded = forest_predict(X, f, t, v, depth=6, n_trees=n_trees)
    torch.testing.assert_close(padded, plain, rtol=0, atol=0)
    # summing the inert rows as trees gives the same total
    total = forest_predict_ref(X, f, t, v, 6) * f.shape[0]
    torch.testing.assert_close(total / n_trees, plain, rtol=RTOL, atol=ATOL)
    packed = pack_tables(f, t, v, depth=6, n_trees=n_trees, n_features=12)
    assert packed.n_trees == n_trees
    assert packed.nodes.shape[0] == -(-n_trees // TREE_GROUP) * TREE_GROUP
    assert (packed.leaves[n_trees:] == 0).all()
    assert (packed.nodes[n_trees:, :, 1] == -1).all()
    torch.testing.assert_close(forest_predict_packed(X, packed), plain,
                               rtol=RTOL, atol=ATOL)


def test_cpu_path_launches_nothing(fitted):
    _, port = fitted
    before = ops.launches
    forest_predict(torch.ones(3, 12), *_tables(to_dense(port, 4)), depth=4)
    assert ops.launches == before


def test_kernel_wrapper_checks_inputs(fitted):
    _, port = fitted
    tables = _tables(to_dense(port, 4))
    packed = pack_tables(*tables, depth=4, n_features=12)
    x = torch.ones(3, 12)
    with pytest.raises(ValueError, match="packed forest on cpu"):
        forest_predict_packed(x.to("meta"), packed)
    with pytest.raises(ValueError):
        forest_predict(x.to(torch.float64).to("meta"), *tables, depth=4)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(fitted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _, port = fitted
    rng = np.random.default_rng(7)
    for depth in (2, 5, 8, 10):
        raw = [t.cuda() for t in _tables(to_dense(port, depth))]
        packed = pack_tables(*raw, depth=depth, n_features=12)
        for batch in (1, 7, 32, 1000):
            x = torch.as_tensor(rng.lognormal(1, 1.5, size=(batch, 12)),
                                dtype=torch.float32, device="cuda")
            before = ops.launches
            got = forest_predict_packed(x, packed)
            again = forest_predict(x, *raw, depth=depth, n_trees=12)
            want = forest_predict_ref(x, *raw, depth)
            torch.cuda.synchronize()
            assert ops.launches == before + 2
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
            assert torch.equal(got, again)
