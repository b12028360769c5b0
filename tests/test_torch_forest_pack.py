"""The forest kernel's packed tables (``repro_torch.kernels.forest.ops.
pack_tables``) and the plain walk over them (``ref.forest_predict_packed_ref``,
the kernel's plain version, which a packed forest takes on the CPU).

The same numpy inputs, made from a seed, go to ``repro`` and ``repro_torch``:
the packed walk is held to the reference's ``forest_predict_ref`` and to its
Pallas kernel in interpret mode (as tests/test_kernels.py runs it) at
rtol 1e-5 / atol 1e-6, with a tree count that is not a multiple of the
kernel's tree group."""
import sys
from pathlib import Path

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
from repro_torch.kernels.forest import (forest_predict_packed,
                                        forest_predict_packed_ref, ops,
                                        pack_tables)
from repro_torch.kernels.forest.kernel import (SMEM_TABLE_BYTES, TREE_GROUP,
                                               leaf_stride, split_levels)
from repro_torch.kernels.forest.ref import SUM_RUNS
from repro_torch.serve.backend import build_backends

RTOL, ATOL = 1e-5, 1e-6
N_TREES = 11                      # not a multiple of TREE_GROUP


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    X = rng.lognormal(1, 1.5, size=(150, 12)).astype(np.float32)
    y = np.log(2 * X[:, 0] + 0.5 * X[:, 3] + 3) + 0.1 * rng.normal(size=150)
    ref = ExtraTreesRegressor(n_estimators=N_TREES, seed=2).fit(X, y)
    port = convert.estimator_from_arrays(
        [vars(t) for t in ref.trees_], ref.n_features_, ref.get_params())
    return ref, port


def _tables(dense):
    return (torch.as_tensor(dense.feature), torch.as_tensor(dense.threshold),
            torch.as_tensor(dense.value))


def _rows(seed: int, batch: int) -> np.ndarray:
    """Feature rows with NaN and +-inf entries: a row of NaN, a NaN in a
    tested column, and infinities in others."""
    X = np.random.default_rng(seed).lognormal(
        1, 1.5, size=(batch, 12)).astype(np.float32)
    X[0, :] = np.nan
    X[1, 3] = np.inf
    X[2, 5] = -np.inf
    X[3, 0] = np.nan
    X[4, 0] = np.inf
    X[5, 0] = -np.inf
    return X


@pytest.mark.parametrize("depth", [0, 1, 2, 5, 8, 10, 14])
def test_packed_layout_round_trips_to_dense(fitted, depth):
    """Records 0 .. 2^D - 2 of a tree are its internal nodes as {threshold
    bits, feature}; the leaves are level D of ``value``; the padded trees
    are inert."""
    _, port = fitted
    dense = to_dense(port, depth)
    f, t, v = _tables(dense)
    packed = pack_tables(f, t, v, depth=depth, n_features=12)
    inner, T = 2 ** depth - 1, N_TREES
    assert packed.nodes.shape == (-(-T // TREE_GROUP) * TREE_GROUP,
                                  2 ** depth, 2)
    assert packed.nodes.dtype == torch.int32
    assert packed.leaves.shape[1] == leaf_stride(depth) >= 2 ** depth
    thr = packed.nodes[..., 0].view(torch.float32)
    assert torch.equal(packed.nodes[:T, :inner, 1], f[:, :inner])
    assert torch.equal(thr[:T, :inner], t[:, :inner])
    assert torch.equal(packed.leaves[:T, :2 ** depth],
                       v[:, inner:inner + 2 ** depth])
    assert (packed.nodes[T:, :, 1] == -1).all()
    assert (packed.leaves[T:] == 0).all() and (packed.leaves[:, 2 ** depth:]
                                               == 0).all()
    assert packed.groups == -(-T // TREE_GROUP)
    assert packed.split == split_levels(depth)


@pytest.mark.parametrize("depth", [2, 5, 8, 10, 14])
def test_packed_walk_matches_reference(fitted, depth):
    ref, port = fitted
    X = _rows(depth, 16)
    packed = pack_tables(*_tables(to_dense(port, depth)), depth=depth,
                         n_features=12)
    got = forest_predict_packed(torch.as_tensor(X), packed)
    assert got.dtype == torch.float32 and got.shape == (16,)
    assert torch.isfinite(got).all()
    rd = r_to_dense(ref, depth)
    oracle = r_forest_predict_ref(jnp.asarray(X), jnp.asarray(rd.feature),
                                  jnp.asarray(rd.threshold),
                                  jnp.asarray(rd.value), depth=depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                               rtol=RTOL, atol=ATOL)
    # the Pallas kernel takes the finite rows: its one-hot contraction turns
    # a NaN or an inf anywhere in a row into NaN at every node (ROADMAP
    # queue 3)
    finite = X[6:]
    pallas = r_forest_predict(finite, rd.feature, rd.threshold, rd.value,
                              depth=depth, block_b=8, block_t=8)
    np.testing.assert_allclose(got.numpy()[6:], np.asarray(pallas),
                               rtol=RTOL, atol=ATOL)


def test_packed_walk_sums_in_the_kernels_order(fitted):
    """Each group's trees in tree order, then the groups' partials in eight
    strided runs, the runs in order, over the real tree count: a row's bits
    do not depend on the batch it rides in."""
    _, port = fitted
    packed = pack_tables(*_tables(to_dense(port, 8)), depth=8, n_features=12)
    X = torch.as_tensor(_rows(1, 40))
    got = forest_predict_packed_ref(X, packed)
    assert torch.equal(forest_predict_packed_ref(X[:7], packed), got[:7])
    # one walk per tree, then the kernel's order of additions, by hand
    leaf = torch.stack([
        forest_predict_packed_ref(X, pack_tables(
            *(t[i:i + 1] for t in _tables(to_dense(port, 8))), depth=8,
            n_features=12)) for i in range(N_TREES)], dim=1)
    leaf = torch.cat([leaf, leaf.new_zeros((40, 4 * packed.groups
                                            - N_TREES))], dim=1)
    part = []
    for g in range(packed.groups):
        p = torch.zeros(40)
        for j in range(TREE_GROUP):
            p = p + leaf[:, g * TREE_GROUP + j]
        part.append(p)
    total = torch.zeros(40)
    for w in range(SUM_RUNS):
        run = torch.zeros(40)
        for g in range(w, packed.groups, SUM_RUNS):
            run = run + part[g]
        total = total + run
    assert torch.equal(got, total / N_TREES)


@pytest.mark.parametrize("depth,split", [
    (0, 0), (1, 1), (2, 2), (5, 5), (8, 8), (10, 10), (11, 11), (12, 11),
    (14, 11), (20, 11)])
def test_split_levels_fill_the_budget(depth, split):
    """Every level and the leaves in shared memory while a group fits the
    budget (through depth 11), then the top 11 levels only."""
    assert split_levels(depth) == split
    nbytes = TREE_GROUP * ((8 << split)
                           + (4 * leaf_stride(depth) if split == depth
                              else 0))
    assert nbytes <= SMEM_TABLE_BYTES


def test_engine_forest_packs_to_half_the_dense_bytes():
    """512 trees at depth 10: 12 KB a tree packed (1,024 records of 8 bytes
    and 1,024 leaves), 6.3 MB; the dense tables hold 3 x 2,047 x 4 bytes
    a tree (12.6 MB)."""
    rng = np.random.default_rng(2)
    T, depth = 512, 10
    N = 2 ** (depth + 1) - 1
    f = torch.as_tensor(rng.integers(-1, 12, size=(T, N)), dtype=torch.int32)
    t = torch.as_tensor(rng.normal(size=(T, N)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(T, N)), dtype=torch.float32)
    packed = pack_tables(f, t, v, depth=depth, n_features=12)
    assert packed.nbytes == T * 12288 == 6_291_456
    assert packed.n_features == 12 and packed.groups == 128
    # a -1 node carries +inf, so the kernel's -inf column sends it left
    thr = packed.nodes[..., 0].view(torch.float32)
    assert torch.isinf(thr[packed.nodes[..., 1] < 0]).all()


@pytest.mark.parametrize("bad", ["device", "dtype", "width", "rank",
                                 "strided"])
def test_rows_check_raises(fitted, bad):
    _, port = fitted
    packed = pack_tables(*_tables(to_dense(port, 4)), depth=4, n_features=12)
    x = torch.ones(6, 12)
    x = {"device": x.to("meta"), "dtype": x.double(), "width": x[:, :11],
         "rank": x[0], "strided": torch.ones(12, 6).t()}[bad]
    before = ops.launches
    with pytest.raises(ValueError):
        forest_predict_packed(x, packed)
    assert ops.launches == before


@pytest.mark.parametrize("bad", ["feature-high", "feature-low", "short",
                                 "trees", "dtype", "shape", "device"])
def test_pack_tables_rejects(fitted, bad):
    _, port = fitted
    f, t, v = _tables(to_dense(port, 5))
    kw = dict(depth=5, n_features=12)
    if bad == "feature-high":
        f = f.clone()
        f[3, 4] = 12
    elif bad == "feature-low":
        f = f.clone()
        f[0, 0] = -2
    elif bad == "short":
        f, t, v = (a[:, :-1] for a in (f, t, v))
    elif bad == "trees":
        kw["n_trees"] = N_TREES + 1
    elif bad == "dtype":
        f = f.long()
    elif bad == "shape":
        v = v[:-1]
    elif bad == "device":
        t = t.to("meta")
    with pytest.raises(ValueError):
        pack_tables(f, t, v, **kw)


def test_feature_past_the_walk_is_not_checked(fitted):
    """Only the internal levels are read: the leaf level's feature entries
    may hold anything."""
    _, port = fitted
    f, t, v = _tables(to_dense(port, 5))
    f = f.clone()
    f[:, 2 ** 5 - 1:] = 99
    packed = pack_tables(f, t, v, depth=5, n_features=12)
    assert packed.n_features == 12


def test_backend_packs_once(fitted, monkeypatch):
    """The kernel backend checks and packs the tables when it is built; a
    call checks only the rows."""
    _, port = fitted
    packs, checks = [], []
    real_pack, real_check = ops.pack_tables, ops.check_rows
    monkeypatch.setattr(ops, "pack_tables",
                        lambda *a, **k: packs.append(1) or real_pack(*a, **k))
    monkeypatch.setattr(ops, "check_rows",
                        lambda *a: checks.append(1) or real_check(*a))
    fn = build_backends(port, dense_depth=6, only=("hopper",),
                        device="cpu")["hopper"]
    X = _rows(9, 10)[6:]
    first = fn(X)
    for _ in range(3):
        np.testing.assert_array_equal(fn(X), first)
    assert len(packs) == 1 and len(checks) == 4
    plain = build_backends(port, dense_depth=6, only=("dense-torch",),
                           device="cpu")["dense-torch"]
    np.testing.assert_allclose(first, plain(X), rtol=RTOL, atol=ATOL)


def test_forest_ab_times_the_served_path(fitted):
    """``tools/forest_ab.py`` calls the kernel wrapper as the serving
    backend does (tables packed once), and needs a card to time it."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import forest_ab
    _, port = fitted
    dense = to_dense(port, 6)
    call = forest_ab.served_call(ops, dense, torch.device("cpu"))
    X = torch.as_tensor(_rows(11, 9)[6:])
    want = forest_predict_packed(
        X, pack_tables(*_tables(dense), depth=6, n_features=12))
    assert torch.equal(call(X), want)
    if not torch.cuda.is_available():
        assert forest_ab.main([]) == 2
