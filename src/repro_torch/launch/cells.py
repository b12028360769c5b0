"""Cell construction shared by the dry-run, the autotuner and tests (the
port of ``repro.launch.cells``): (fn, abstract args, placements, donation)
for one (model x shape x strategy x mesh) cell. The abstract args are
tensors on the ``meta`` device; the placements are ``tree_shardings``'s.
No import-time side effects."""
from __future__ import annotations

from functools import partial


def cell_fns(model, shape, strategy, mesh, opt_cfg=None):
    """Returns (fn, args on the meta device, in placements, out placements,
    donate)."""
    from ..sharding.rules import tree_shardings
    from ..train.optimizer import OptConfig
    from ..train.step import (abstract_train_state, make_train_step,
                              train_state_axes)

    cfg = model.cfg
    batch_meta = model.abstract_inputs(shape)
    batch_pl = tree_shardings(model.input_axes(shape), mesh, strategy,
                              batch_meta)

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig()
        step = make_train_step(model, opt_cfg,
                               n_microbatches=n_microbatches(cfg, shape,
                                                             mesh))
        state_meta = abstract_train_state(model)
        state_pl = tree_shardings(train_state_axes(model), mesh, strategy,
                                  state_meta)
        return (step, (state_meta, batch_meta), (state_pl, batch_pl),
                (state_pl, None), (0,))

    params_meta = model.abstract(dtype=cfg.dtype)       # serving precision
    params_pl = tree_shardings(model.param_axes(), mesh, strategy,
                               params_meta)
    cache_meta = model.abstract_cache(shape.global_batch, shape.seq_len)
    cache_pl = tree_shardings(model.cache_axes(shape.global_batch,
                                               shape.seq_len),
                              mesh, strategy, cache_meta)
    if shape.kind == "prefill":
        return (model.prefill, (params_meta, batch_meta),
                (params_pl, batch_pl), (None, cache_pl), ())
    # decode: one new token against a seq_len cache, at its last position
    return (partial(_decode_at, model.decode, shape.seq_len - 1),
            (params_meta, batch_meta, cache_meta),
            (params_pl, batch_pl, cache_pl), (None, cache_pl), (2,))


def n_microbatches(cfg, shape, mesh) -> int:
    """A train cell's count of microbatches: the config's, capped so that
    a microbatch still covers every data-parallel shard (else each shard's
    microbatches are uneven)."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    dp = 1
    for ax in ("pod", "data"):
        dp *= sizes.get(ax, 1)
    return max(1, min(cfg.microbatches, shape.global_batch // max(dp, 1)))


def _decode_at(decode, pos: int, params, batch, cache):
    """``decode`` of the token at ``pos`` (the VLM's M-RoPE delta 0): a
    position on the meta device has no value to read, and the step's work
    is the same at every position (the reference's is a traced scalar)."""
    fixed = {"pos": pos}
    if "mrope_delta" in batch:
        fixed["mrope_delta"] = 0
    return decode(params, {**batch, **fixed}, cache)
