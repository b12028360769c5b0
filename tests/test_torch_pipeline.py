"""The port's GPipe schedule (``train/pipeline.py``) on 4 gloo ranks laid
out as ("stage", "mdl") = (2, 2), with 6 microbatches: every rank's output
is within 1e-5 of the sequential stack, computed by the reference's
``jax.lax.scan`` (the reference's ``test_pipeline_matches_sequential``)
and by plain torch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _gloo import result, run_world
from repro.train.pipeline import split_stages as r_split_stages
from repro_torch.train.pipeline import split_stages


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("pipeline", 4, tmp_path_factory.mktemp("pipeline"))


def _sequential_jax(Ws, xs):
    def body(x, w):
        return jnp.tanh(x @ w), ()
    M, mb, d = xs.shape
    flat = jax.vmap(lambda x0: jax.lax.scan(body, x0, jnp.asarray(Ws))[0])(
        jnp.asarray(xs).reshape(M * mb, d))
    return np.asarray(flat).reshape(M, mb, d)


@pytest.mark.parametrize("rank", range(4))
def test_pipeline_matches_sequential(world, rank):
    got = result(world, "forward", rank)
    want = _sequential_jax(got["Ws"], got["xs"])
    assert float(np.abs(got["y"] - want).max()) < 1e-5
    x = torch.tensor(got["xs"])
    for w in torch.tensor(got["Ws"]):
        x = torch.tanh(x @ w)
    assert float(np.abs(got["y"] - x.numpy()).max()) < 1e-5


def test_stage_sharded_params_give_the_same_outputs(world):
    """Stage params as a DTensor sharded over the stage axis (each rank
    holding its stage's 4 layers of 8) give the same outputs, bit for
    bit."""
    for rank in range(4):
        got = result(world, "forward", rank)
        assert got["local_layers"] == (1, 4, 16, 16)
        np.testing.assert_array_equal(got["y_sharded"], got["y"])


def test_every_rank_returns_the_same_outputs(world):
    y0 = result(world, "forward", 0)["y"]
    for rank in range(1, 4):
        np.testing.assert_array_equal(result(world, "forward", rank)["y"], y0)


def test_split_stages_is_the_reference_s():
    a = np.arange(8 * 3 * 2, dtype=np.float32).reshape(8, 3, 2)
    got = split_stages({"w": torch.tensor(a)}, 4)["w"]
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(r_split_stages({"w": jnp.asarray(a)}, 4)["w"]))
    with pytest.raises(ValueError, match="do not split"):
        split_stages(torch.zeros(6, 2), 4)
