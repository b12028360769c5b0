"""Elastic scaling and failure recovery (the port of
``repro.runtime.elastic``).

Both reduce to ONE primitive because checkpoints restore mesh-agnostically
(``checkpoint/manager.py``): build a new mesh over the surviving or
available ranks, recompute the placements from the SAME logical-axes
rules, and redistribute the state. The failure path is the same, with the
new mesh the old one minus the dead ranks.

A mesh over a subset of the world is made by every rank of the world
(``DeviceMesh`` creates its groups collectively); a rank outside it holds
nothing of a state resharded onto it (empty local tensors). The global
batch is kept constant across rescaling (the per-rank batch changes), so
training curves compare before and after.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..sharding.rules import distribute, tree_shardings


@dataclass
class ElasticPlan:
    mesh: DeviceMesh
    state_placements: object
    batch_placements: object


def plan_for_devices(ranks, model, shape, strategy: str,
                     model_axis: int | None = None,
                     device_type: str = "cuda") -> ElasticPlan:
    """Mesh and placements for an arbitrary set of global ranks (after a
    failure or a change of scale). ``model_axis`` defaults, as the
    reference's, to the largest of 16, 8, 4 and 2 that divides the rank
    count (else 1)."""
    from ..train.step import abstract_train_state, train_state_axes

    n = len(ranks)
    if model_axis is None:
        model_axis = 1
        for cand in (16, 8, 4, 2):
            if n % cand == 0:
                model_axis = cand
                break
    mesh = DeviceMesh(device_type,
                      torch.tensor(list(ranks)).reshape(n // model_axis,
                                                        model_axis),
                      mesh_dim_names=("data", "model"))
    state_pl = tree_shardings(train_state_axes(model), mesh, strategy,
                              abstract_train_state(model))
    batch_pl = tree_shardings(model.input_axes(shape), mesh, strategy,
                              model.abstract_inputs(shape))
    return ElasticPlan(mesh=mesh, state_placements=state_pl,
                       batch_placements=batch_pl)


def reshard_state(state, plan: ElasticPlan):
    """Move a (restored or live) train state onto the plan's mesh: each
    leaf whole (a DTensor is gathered over its mesh, a collective its
    ranks all call), then distributed onto the plan."""
    def move(x, pl):
        if isinstance(x, dict):
            return {k: move(v, pl[k]) for k, v in x.items()}
        full = x.full_tensor() if isinstance(x, DTensor) else x
        return distribute(full, plan.mesh, pl)
    return move(state, plan.state_placements)
