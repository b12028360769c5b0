"""Pipeline parallelism, GPipe-style (the port of ``repro.train.pipeline``).

The layer stack is split into P stages laid out along a mesh dimension.
Microbatches stream through the stages with a ring shift per tick; the
classic (P - 1)-bubble schedule:

  tick t: stage s processes microbatch (t - s) if 0 <= t - s < M

Every rank runs the same loop; its stage is its coordinate on the stage
axis. The reference's ``ppermute`` ring is a ``batch_isend_irecv`` on the
stage axis's group (point-to-point ops take global ranks), and its final
masked ``psum``, which broadcasts the last stage's outputs, an
``all_reduce``. An inactive stage skips its compute (the reference
computes and masks; the outputs are the same).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models.common import tree_map


def pipeline_forward(mesh, axis: str, stage_fn, n_microbatches: int):
    """Returns ``fn(stage_params, xs) -> ys``.

    stage_params: a nested dict (or one tensor) with a leading stage axis
    (P, ...): DTensors
    sharded over ``axis`` (each rank holds its stage's slice) or whole
    tensors (each rank takes its stage's slice); xs: (M, mb, ...)
    microbatched input, the same on every rank. ``stage_fn(params_slice,
    x) -> y`` applies ONE stage's layers. Every rank returns all M
    outputs."""
    dim = list(mesh.mesh_dim_names).index(axis)
    n_stages = mesh.size(dim)
    group = mesh.get_group(axis)
    stage = mesh.get_coordinate()[dim]
    nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
    prv = dist.get_global_rank(group, (stage - 1) % n_stages)

    def own(_, a):
        if isinstance(a, DTensor):
            return a.to_local()[0]
        return a[stage]

    def fn(stage_params, xs):
        sp = tree_map(own, stage_params)
        M = xs.shape[0]
        if M != n_microbatches:
            raise ValueError(f"{M} microbatches, expected {n_microbatches}")
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(M + n_stages - 1):
            if stage == 0 and t < M:
                buf = xs[t]
            if 0 <= t - stage < M:
                buf = stage_fn(sp, buf)
                if stage == n_stages - 1:
                    outs[t - stage] = buf
            if n_stages == 1:
                continue
            incoming = torch.empty_like(buf)
            ops = [dist.P2POp(dist.isend, buf.contiguous(), nxt, group),
                   dist.P2POp(dist.irecv, incoming, prv, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            buf = incoming
        outs = outs * float(stage == n_stages - 1)
        dist.all_reduce(outs, op=dist.ReduceOp.SUM, group=group)
        return outs

    return fn


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked layer params -> (P, L / P, ...)."""
    def re(_, a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))
    return tree_map(re, stacked_params)
