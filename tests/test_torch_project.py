"""``sharding.context.project``, the one route of a projection on a mesh
(fault F6), and tests/_mesh_cells.py's guard for torch 2.11's DTensor view
rule, which every fake-mesh cell runs under.

The guard: a plain ``x @ w`` of a sequence-sharded x raises under it on a
fake (2, 2) mesh, in the forward; so does its backward when the product's
gradient comes back sequence-sharded. ``project`` does neither.

The products: on 4 gloo ranks ((2, 2) mesh, under the guard) in float64,
``project(x, w)`` and the gradients of x and w, gathered whole, against
``x @ w`` on the whole tensors at rtol 1e-9 (plus 1e-9 of the largest
value). With x's sequence sharded over ``data`` the product runs on the
shards (``product_on_shards``), beside each of that function's cases on
``model``: x's rows, a contracted dimension, w's outputs, and a shard of w
that x does not meet (gathered). With x's batch over ``data`` instead it
is DTensor's own matmul, the same four cases; and once with a
sequence-sharded zero tensor added to the product, whose gradient then
comes back sequence-sharded."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from _gloo import project_inputs, result, run_world
from _mesh_cells import fake_mesh, view_rule_2_11

# name: (x's placements, w's placements, those of a zero tensor added to
# the product before the loss)
CASES = {
    "seq-rows": (("S1", "S0"), ("S0", "S1"), ()),
    "seq-contracted": (("S1", "S2"), ("S0", "S0"), ()),
    "seq-outputs": (("S1", "R"), ("S0", "S1"), ()),
    "seq-replicated": (("S1", "R"), ("R", "S0"), ()),
    "batch-rows": (("S0", "S0"), ("S0", "S1"), ()),
    "batch-contracted": (("S0", "S2"), ("S0", "S0"), ()),
    "batch-outputs": (("S0", "R"), ("S0", "S1"), ()),
    "batch-replicated": (("S0", "R"), ("R", "S0"), ()),
    "batch-seq-gradient": (("S0", "R"), ("S0", "S1"), ("S0", "S1")),
}
TOL = 1e-9


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("project_cases", 4, tmp_path_factory.mktemp("project"),
                     cases=CASES)


@pytest.fixture(scope="module")
def plain():
    x, w, g = project_inputs()
    x.requires_grad_()
    w.requires_grad_()
    y = x @ w
    gx, gw = torch.autograd.grad((y * g).sum(), (x, w))
    return {"y": y.detach().numpy(), "gx": gx.numpy(), "gw": gw.numpy()}


@pytest.mark.parametrize("case", list(CASES))
def test_project_matches_the_plain_product(world, plain, case):
    for rank in range(4):
        got = result(world, case, rank)
        for k, want in plain.items():
            np.testing.assert_allclose(got[k], want, rtol=TOL,
                                       atol=TOL * np.abs(want).max(),
                                       err_msg=f"{case} {k} rank {rank}")


@pytest.mark.parametrize("where", ["forward", "backward"])
def test_guard_refuses_what_torch_2_11_refuses(where):
    """On meta tensors over a fake (2, 2) process group: x (B, S, d)
    sequence-sharded in the forward, or batch-sharded with the product's
    gradient sequence-sharded (a sequence-sharded zero tensor added to it);
    the plain matmul raises torch 2.11's error under the guard,
    ``project`` runs."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.sharding.context import project

    x_pl = [Shard(0), Shard(1) if where == "forward" else Replicate()]
    seq = [Shard(0), Shard(1)]
    with fake_mesh((2, 2)) as mesh:
        x = DTensor.from_local(
            torch.empty(2, 4 if where == "forward" else 8, 6, device="meta"),
            mesh, x_pl, run_check=False).requires_grad_()     # (4, 8, 6)
        w = DTensor.from_local(torch.empty(6, 10, device="meta"), mesh,
                               [Replicate(), Replicate()],
                               run_check=False).requires_grad_()

        zero = DTensor.from_local(torch.empty(2, 4, 10, device="meta"),
                                  mesh, seq, run_check=False)  # (4, 8, 10)

        def step(product):
            y = product(x, w) + zero
            torch.autograd.grad(y.to_local().sum(), (x, w))
            return y

        with view_rule_2_11():
            with pytest.raises(RuntimeError,
                               match="Attempted to flatten multiple "
                                     "dimensions, with dimension 1"):
                step(torch.matmul)
            assert tuple(step(project).shape) == (4, 8, 10)
