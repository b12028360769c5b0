"""Logical-axis -> mesh-axis sharding rules (the port of
``repro.sharding.rules``).

Every parameter, activation and cache declares LOGICAL axes
(``models/common.py``); a named STRATEGY maps them onto mesh axes. The
strategies are plain dicts, copied from the reference as data, so they stay
enumerable: they are the search space of the autotuner (ROADMAP item 10).

Mesh axes: ("pod", "data", "model") multi-pod / ("data", "model")
single-pod. Conventions, as the reference's:
  * activations' ``batch`` shards over (pod, data): pure DP across pods;
  * parameters 2-D shard over (data, model): FSDP x TP within a pod,
    REPLICATED across pods;
  * a mesh axis may appear once per spec: later logical dims that map to an
    already-used axis stay replicated (first come, first served).

``spec_for_axes`` gives the reference's per-TENSOR-dimension spec (a tuple
of None, a mesh axis name, or a tuple of names, trailing Nones dropped, as
``PartitionSpec``). DTensor takes placements per MESH dimension instead:
``placements`` turns a spec into one ``Shard(i)`` or ``Replicate()`` per
mesh dimension. A tensor dimension over ("pod", "data") becomes ``Shard(i)``
on both mesh dimensions, pod major, as the ``PartitionSpec`` lays it out.

A mesh is anything with ``mesh_dim_names`` and ``shape`` (the sizes, in
that order): a ``torch.distributed.DeviceMesh`` or a plain stand-in.
"""
from __future__ import annotations

from torch.distributed.tensor import Replicate, Shard

# strategy: logical axis name -> tuple of mesh axis names (in preference order)
STRATEGIES: dict[str, dict] = {
    # FSDP x TP: params 2-D sharded; the workhorse default.
    "2d": {
        "batch": ("pod", "data"),
        "seq": (),
        "embed": ("data",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),     # fallback TP: claims model only when the
                                    # heads dim could not shard (dedup rule)
        "cache_seq": ("model",),    # context-parallel KV cache (decode)
        "vocab": ("model",),
        "expert": ("model",),
        "inner": ("model",),
        "state": (),
        "conv": (),
        "lora": (),
        "layers": (),
    },
    # pure tensor parallel + data parallel (params replicated over data —
    # more HBM, fewer weight all-gathers)
    "tp": {
        "batch": ("pod", "data"),
        "seq": (),
        "embed": (),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),     # fallback TP: claims model only when the
                                    # heads dim could not shard (dedup rule)
        "cache_seq": ("model",),    # context-parallel KV cache (decode)
        "vocab": ("model",),
        "expert": ("model",),
        "inner": ("model",),
        "state": (),
        "conv": (),
        "lora": (),
        "layers": (),
    },
    # ZeRO-3 across pods too: params sharded over (pod, data) x model
    "zero3": {
        "batch": ("pod", "data"),
        "seq": (),
        "embed": ("pod", "data"),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),     # fallback TP: claims model only when the
                                    # heads dim could not shard (dedup rule)
        "cache_seq": ("model",),    # context-parallel KV cache (decode)
        "vocab": ("model",),
        "expert": ("model",),
        "inner": ("model",),
        "state": (),
        "conv": (),
        "lora": (),
        "layers": (),
    },
    # sequence parallelism for long-context inference: shard seq over model
    "sp": {
        "batch": ("pod", "data"),
        "seq": ("model",),
        "embed": ("data",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),     # fallback TP: claims model only when the
                                    # heads dim could not shard (dedup rule)
        "cache_seq": ("model",),    # context-parallel KV cache (decode)
        "vocab": ("model",),
        "expert": ("model",),
        "inner": ("model",),
        "state": (),
        "conv": (),
        "lora": (),
        "layers": (),
    },
    # decode-oriented: KV-cache batch over data, heads over model, params TP
    # (FSDP weight gathers per token are wasteful at batch 1 token)
    "serve": {
        "batch": ("pod", "data"),
        "seq": (),
        "embed": (),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),     # fallback TP: claims model only when the
                                    # heads dim could not shard (dedup rule)
        "cache_seq": ("model",),    # context-parallel KV cache (decode)
        "vocab": ("model",),
        "expert": ("model",),
        "inner": ("model",),
        "state": (),
        "conv": (),
        "lora": (),
        "layers": (),
    },
}


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def spec_for_axes(axes: tuple, strategy: dict, mesh,
                  shape: tuple | None = None) -> tuple:
    """The spec of one leaf. Drops mesh axes absent from the mesh,
    deduplicates (a mesh axis may appear only once per spec), and, when the
    concrete ``shape`` is known, drops mesh axes whose size does not divide
    the dimension (smollm's 5 KV heads stay replicated on a model=16 mesh).
    DTensor would accept uneven shards; the reference's rule does not."""
    sizes = _sizes(mesh)
    used: set[str] = set()
    parts = []
    for i, ax in enumerate(axes):
        if ax is None:
            parts.append(None)
            continue
        want = strategy.get(ax, ())
        cand = [m for m in want if m in sizes and m not in used]
        got: list[str] = []
        if shape is not None and i < len(shape):
            dim = shape[i]
            prod = 1
            for m in cand:                   # greedy prefix while divisible
                if dim % (prod * sizes[m]) == 0:
                    got.append(m)
                    prod *= sizes[m]
        else:
            got = cand
        used.update(got)
        if len(got) == 0:
            parts.append(None)
        elif len(got) == 1:
            parts.append(got[0])
        else:
            parts.append(tuple(got))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements (one per mesh dimension) of a ``spec_for_axes``
    spec: ``Shard(i)`` on each mesh dimension that tensor dimension i is
    split over, ``Replicate()`` on the others. A mesh dimension of size 1
    is ``Replicate()`` whatever the spec says: a split over one rank is no
    split, and DTensor cannot view away a tensor dimension sharded over it
    (a batch of 1 on a data axis of 1)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for i, part in enumerate(spec):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(m) for m in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} is not in the mesh's "
                             f"order {names}")
        for j in idx:
            if sizes[j] > 1:
                out[j] = Shard(i)
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(
        isinstance(a, (str, type(None))) for a in x)


def _map2(fn, axes, shapes):
    """Map ``fn(axes_leaf, shapes_leaf)`` over the axes tree; ``shapes``
    follows its structure (or is None)."""
    if axes is None or _is_axes_leaf(axes):
        return fn(axes, shapes)
    if isinstance(axes, dict):
        return {k: _map2(fn, v, None if shapes is None else shapes[k])
                for k, v in axes.items()}
    seq = [_map2(fn, a, None if shapes is None else shapes[i])
           for i, a in enumerate(axes)]
    return seq if isinstance(axes, list) else tuple(seq)


def tree_shardings(axes_tree, mesh, strategy: str | dict, shapes_tree=None):
    """Tree of placements matching a logical-axes tree (nested dicts, lists
    and tuples; its leaves are tuples of axis names, possibly empty for
    scalars). ``shapes_tree`` (the same structure, leaves with ``.shape``:
    tensors, on the ``meta`` device too) enables the divisibility rule."""
    strat = STRATEGIES[strategy] if isinstance(strategy, str) else strategy

    def to_placements(axes, shaped):
        if axes is None:
            return replicated(mesh)
        shape = None if shaped is None else tuple(shaped.shape)
        return placements(spec_for_axes(tuple(axes), strat, mesh, shape),
                          mesh)

    return _map2(to_placements, axes_tree, shapes_tree)


def replicated(mesh) -> tuple:
    return (Replicate(),) * len(tuple(mesh.mesh_dim_names))


def to_local(t):
    """A DTensor's local shard; a plain tensor itself."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def local_chunk(t, sizes: tuple, coord: tuple, placements: tuple):
    """The chunk of ``t`` that the rank at mesh coordinate ``coord`` (mesh
    sizes ``sizes``) holds under ``placements``: each ``Shard(i)`` splits
    dim i evenly, in mesh-dimension order (the first mesh dimension
    major)."""
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            t = t.chunk(sizes[j], dim=p.dim)[coord[j]]
    return t


def distribute(t, mesh, placements: tuple):
    """``t``, which every rank holds whole and alike, as a DTensor on
    ``mesh`` with ``placements``: each rank keeps its own chunk
    (``local_chunk``), with no communication (``distribute_tensor`` would
    scatter from one rank), in a storage of its own: a chunk of the
    leading dimension is a view of the whole, which would keep the whole
    alive (and a dry-run would count it whole). A rank outside the mesh
    keeps an empty local tensor."""
    from torch.distributed.tensor import DTensor

    coord = mesh.get_coordinate()
    if coord is None:
        local = t.new_empty((0,))
    else:
        local = local_chunk(t, tuple(mesh.shape), coord,
                            placements).contiguous()
        if local.untyped_storage().nbytes() > \
                local.numel() * local.element_size():
            local = local.clone()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, mesh, placements_tree):
    """``distribute`` over a tree of tensors (nested dicts, lists and
    tuples) and the matching tree of placements."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, mesh, placements_tree[k])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        seq = [distribute_tree(v, mesh, p)
               for v, p in zip(tree, placements_tree)]
        return seq if isinstance(tree, list) else tuple(seq)
    return distribute(tree, mesh, placements_tree)
