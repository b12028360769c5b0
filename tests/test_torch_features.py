"""The port's feature walker (``repro_torch.core.features``, over
``torch.export`` graphs) against the reference's StableHLO walker
(``repro.core.features``): each test of ``tests/test_features.py`` with the
function written in both frameworks and the port's ``extract`` held to the
reference's live ``extract`` at the tolerance the test states."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops import scan

from repro.core import features as r_feat
from repro_torch.core import features as p_feat


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


def _t(*shape):
    return torch.randn(shape, generator=torch.Generator().manual_seed(0))


def _loop(step, init, length):
    carry, _ = scan(lambda c, _: step(c), init, init.new_zeros(length, 0))
    return carry


@pytest.mark.parametrize("m,k,n", [(32, 48, 64), (7, 5, 3), (128, 1, 9)])
def test_matmul_flops_exact(m, k, n):
    want = 2 * m * k * n
    ref = r_feat.extract(lambda a, b: a @ b, _spec(m, k), _spec(k, n))
    port = p_feat.extract(lambda a, b: a @ b, _t(m, k), _t(k, n))
    assert ref.aux["flops"] == port.aux["flops"] == want
    assert port.aux["io_bytes"] == ref.aux["io_bytes"] == 4 * (m * k + k * n
                                                              + m * n)


def test_scan_trip_count_weighting():
    L = 9

    def ref_f(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), ()
        c, _ = jax.lax.scan(body, x, None, length=L)
        return c

    def port_f(x, w):
        return _loop(lambda c: (torch.tanh(c @ w), ()), x.clone(), L)

    ref = r_feat.extract(ref_f, _spec(8, 16), _spec(16, 16))
    port = p_feat.extract(port_f, _t(8, 16), _t(16, 16))
    want = L * (2 * 8 * 16 * 16) + L * 8 * 16
    assert ref.aux["flops"] == pytest.approx(want, rel=0.05)
    # both: the dot's flops times the trip count, plus the loop's own ops
    assert port.aux["flops"] == pytest.approx(ref.aux["flops"], rel=0.05)
    assert port["special_ops"] == ref["special_ops"] == L * 8 * 16
    # the while and its branches: 1 + L
    assert port["control_ops"] >= 1 + L


def test_nested_scan_multiplies():
    def ref_f(x):
        def outer(c, _):
            def inner(c2, _):
                return c2 * 2.0 + 1.0, ()
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, ()
        c, _ = jax.lax.scan(outer, x, None, length=4)
        return c

    def port_f(x):
        def outer(c):
            return _loop(lambda c2: (c2 * 2.0 + 1.0, ()), c, 3), ()
        return _loop(outer, x, 4)

    ref = r_feat.extract(ref_f, _spec(16))
    port = p_feat.extract(port_f, _t(16))
    want = 4 * 3 * 16 * 2
    assert ref["arith_ops"] == pytest.approx(want, rel=0.15)
    assert port["arith_ops"] == pytest.approx(want, rel=0.15)
    assert port["arith_ops"] == pytest.approx(ref["arith_ops"], rel=0.15)
    # the outer loop's 1 + 4, and the inner loop's 1 + 3 on each of its 4 trips
    assert port["control_ops"] == 5 + 4 * 4


def test_special_vs_logic_grouping():
    ref = r_feat.extract(lambda x: jnp.where(x > 0, jnp.exp(x), jnp.sin(x)),
                         _spec(100))
    port = p_feat.extract(
        lambda x: torch.where(x > 0, torch.exp(x), torch.sin(x)), _t(100))
    assert ref["special_ops"] == port["special_ops"] == 200   # exp + sin
    assert ref["logic_ops"] >= 200 and port["logic_ops"] >= 200


def test_launch_config_features():
    launch = p_feat.LaunchConfig(work_items=4096, n_shards=16,
                                 shared_mem_bytes=1024)
    port = p_feat.extract(lambda x: x + 1.0, _t(64), launch=launch)
    ref = r_feat.extract(lambda x: x + 1.0, _spec(64),
                         launch=r_feat.LaunchConfig(work_items=4096,
                                                    n_shards=16,
                                                    shared_mem_bytes=1024))
    for name, want in (("work_per_shard", 256.0), ("num_shards", 16.0),
                       ("shared_mem_vol", 1024.0)):
        assert port[name] == ref[name] == want
    assert port.aux["work_items"] == 4096 and port.aux["n_shards"] == 16


def test_memory_volumes_cover_io():
    n = 128
    ref = r_feat.extract(lambda a, b: a + b, _spec(n, n), _spec(n, n))
    port = p_feat.extract(lambda a, b: a + b, _t(n, n), _t(n, n))
    io = 3 * n * n * 4
    assert port.aux["io_bytes"] == ref.aux["io_bytes"] == io
    assert port["global_mem_vol"] >= io and ref["global_mem_vol"] >= io


def test_vector_matches_names():
    fv = p_feat.extract(lambda x: x * 2, _t(8))
    assert p_feat.FEATURE_NAMES == r_feat.FEATURE_NAMES
    assert fv.values.shape == (len(p_feat.FEATURE_NAMES),)
    d = fv.as_dict()
    assert set(d) == set(p_feat.FEATURE_NAMES)
    assert all(np.isfinite(v) for v in d.values())
    assert set(fv.aux) == set(r_feat.extract(lambda x: x * 2,
                                             _spec(8)).aux)


def test_collectives_counted_as_sync():
    import socket

    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        fv = p_feat.extract(
            lambda x: funcol.all_reduce(x, "sum", dist.group.WORLD), _t(8))
    finally:
        dist.destroy_process_group()
    assert fv["sync_ops"] >= 1
    assert fv.aux["collective_bytes"] == 8 * 4


def test_robust_to_a_program_without_ops():
    fv = p_feat.extract(lambda x: x, _t(4))
    assert np.isfinite(fv.values).all()
    assert fv["total_instr"] == 0 and fv.aux["io_bytes"] == 32


def test_never_runs_the_function():
    """Export traces on fake tensors: inputs on the meta device (no data)
    give the features that CPU inputs give."""
    def f(a, b):
        return torch.tanh(a @ b).sum(0)
    cpu = p_feat.extract(f, _t(16, 8), _t(8, 4))
    meta = p_feat.extract(f, torch.empty(16, 8, device="meta"),
                          torch.empty(8, 4, device="meta"))
    np.testing.assert_array_equal(cpu.values, meta.values)
    assert cpu.aux == meta.aux


def test_first_result_counts_as_io_as_in_the_reference():
    """The reference reads an entry's results up to the first result's
    attributes, so a function of two results counts the first's bytes."""
    ref = r_feat.extract(lambda a: (a + 1.0, jnp.zeros((64,)) + a.sum()),
                         _spec(8))
    port = p_feat.extract(lambda a: (a + 1.0, torch.zeros(64) + a.sum()),
                          _t(8))
    assert port.aux["io_bytes"] == ref.aux["io_bytes"] == 2 * 8 * 4
