"""Distributed-optimization building blocks with EXPLICIT communication
(the port of ``repro.train.grad``), over ``torch.distributed`` process
groups where the reference uses ``shard_map`` collectives:

  * int8 gradient compression with error feedback for the data-parallel
    all-reduce (a 4x volume cut; the compression error is re-injected into
    the next step's gradient);
  * an explicit data-parallel gradient step (``make_dp_grad_fn``) for
    where the communication must be controlled or compressed;
  * bucketed reduction: leaves flattened and concatenated into fixed-size
    buckets, so small tensors amortize the collective launches.

The quantizer is the reference's bit for bit: float32 throughout, and
``torch.round`` rounds half to even as ``jnp.round`` does. Trees are nested
dicts, lists and tuples of tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _flatten(tree) -> tuple[list, object]:
    """(leaves, structure); ``_unflatten`` rebuilds the tree. A dict's
    leaves come in sorted key order, as ``jax.tree.flatten`` gives them."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]
        return ([l for ls, _ in parts for l in ls],
                ("dict", keys, [s for _, s in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        return ([l for ls, _ in parts for l in ls],
                (type(tree).__name__, None, [s for _, s in parts]))
    return [tree], None


def _unflatten(structure, leaves: list):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, keys, subs = s
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, subs)}
        seq = [build(c) for c in subs]
        return seq if kind == "list" else tuple(seq)
    return build(structure)


def _map(fn, *trees):
    flats = [_flatten(t) for t in trees]
    return _unflatten(flats[0][1], [fn(*ls) for ls in
                                    zip(*(f[0] for f in flats))])


# ------------------------------------------------------ int8 + error feedback

def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_residual(x, error):
    """Error-feedback compression: quantize (x + carried error); returns
    (q, scale, new_error)."""
    target = x.float() + error
    q, scale = quantize_int8(target)
    new_error = target - dequantize_int8(q, scale)
    return q, scale, new_error


def init_error_state(params):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)


# ----------------------------------------------------------- compressed psum

def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce an int8-quantized tensor over ``group``: the int8 values
    are summed in int32 (no overflow for up to 2^23 ranks), the scales
    combined by their maximum, which keeps the dequantization sound."""
    q, scale = quantize_int8(x)
    qsum = q.to(torch.int32)
    dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
    smax = scale.clone()
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    return qsum.float() * smax


def psum_tree(tree, group=None, compress: bool = False):
    def reduce(g):
        if compress:
            return compressed_psum(g, group)
        g = g.clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g
    return _map(reduce, tree)


# -------------------------------------------------------------- bucketing

def bucket_tree(tree, bucket_bytes: int = 4 * 2**20):
    """Flatten a tree of float32 leaves into (buckets (n, per), spec);
    ``unbucket_tree`` restores it."""
    leaves, structure = _flatten(tree)
    sizes = [int(l.numel()) for l in leaves]
    flat = torch.cat([l.reshape(-1).float() for l in leaves])
    per = max(bucket_bytes // 4, 1)
    n_buckets = -(-flat.shape[0] // per)
    pad = n_buckets * per - flat.shape[0]
    flat = torch.nn.functional.pad(flat, (0, pad))
    buckets = flat.reshape(n_buckets, per)
    spec = (structure, [tuple(l.shape) for l in leaves], sizes, pad)
    return buckets, spec


def unbucket_tree(buckets, spec):
    structure, shapes, sizes, pad = spec
    flat = buckets.reshape(-1)
    if pad:
        flat = flat[:-pad]
    leaves = []
    off = 0
    for shp, n in zip(shapes, sizes):
        leaves.append(flat[off:off + n].reshape(shp))
        off += n
    return _unflatten(structure, leaves)


# ------------------------------------------------- explicit-DP gradient step

def make_dp_grad_fn(loss_fn, mesh, axis_name: str = "data",
                    compress: bool = False, error_feedback: bool = True):
    """Data-parallel gradient over the mesh dimension ``axis_name``: params
    replicated (every rank holds them whole), the batch split along its
    first axis, rank c of the D ranks taking rows c * B / D ... (c + 1) *
    B / D - 1 of every leaf. The gradients are averaged over that
    dimension's group, optionally int8-compressed with error feedback.
    ``loss_fn(params, batch) -> (loss, aux)``. Returns
    ``grad_step(params, batch, err) -> (loss, grads, new_err)``, the loss
    averaged too."""
    group = mesh.get_group(axis_name)
    dim = list(mesh.mesh_dim_names).index(axis_name)
    n = mesh.size(dim)
    coord = mesh.get_coordinate()[dim]

    def shard(v):
        if not v.dim():
            return v
        rows = v.shape[0] // n
        return v[coord * rows:(coord + 1) * rows]

    def grad_step(params, batch, err):
        local = _map(shard, batch)
        flat, structure = _flatten(params)
        flat = [p.detach().requires_grad_() for p in flat]
        loss = loss_fn(_unflatten(structure, flat), local)[0]
        grads = list(torch.autograd.grad(loss, flat))
        loss = loss.detach().clone()
        if compress:
            errs = _flatten(err)[0]
            out, new_errs = [], []
            for g, e in zip(grads, errs):
                target = g.float() + (e if error_feedback else 0.0)
                q, scale = quantize_int8(target)
                new_errs.append(target - dequantize_int8(q, scale)
                                if error_feedback
                                else torch.zeros_like(target))
                qsum = q.to(torch.int32)
                dist.all_reduce(qsum, op=dist.ReduceOp.SUM, group=group)
                dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
                out.append(qsum.float() * scale / n)
            grads = out
            new_err = _unflatten(structure, new_errs)
        else:
            for g in grads:
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                g.div_(n)
            new_err = err
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return loss / n, _unflatten(structure, grads), new_err

    return grad_step
