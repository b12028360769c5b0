"""The cells' collective faults (F14-F22), each on a reduced cell
on fake (4, 2) and (2, 2, 2) meshes under ``2d``, counted by
``core/autotune.py::strategy_costs``, against the reference's count of the
same cell (lowered and compiled on 8 host devices in a subprocess, its
``analyze_cell``): the port moves no more than 1.25x the reference's
collective bytes. Before the repairs the port moved 1.55-1.59x (the dense
decode: an attention output replicated over the model axis gathered its
out-projection whole, F14, and the embedding table was gathered over the
data axis, F15), 2.45-2.93x (whisper: the cross-attention gathered the
sequence of its cross cache, F16), 2.06-2.41x (the MoEs: every routing
choice gathered the expert weights and the whole expert output, F17) and
1.87-5.97x (zamba2: the mixer gathered its in-projection whole, F18);
the prefills 1.31-2.22x (the residual stream was left a partial sum over
the model axis after each block and reduced in float32 by the next norm,
where the reference reduces it at the block's end, F20; with F14 and
F17); the training steps 1.44-1.90x (torch 2.13's DTensor kept a
sublayer's partial output partial through the residual add, F22; the
MoE's whole expert output gathered for every choice, F17). The xLSTM's
fault (F19) shows at full width only: its ``long_500k`` cell on the
multi-pod mesh, (2, 16, 16), moved 2.17x the reference's bytes (its
recurrence sharded its heads over the pod axis, where the cache
replicates them, and every new state was gathered there); it is counted
against the reference's same cell on 512 host devices. Fault F21 (a
leading shard kept the whole tensor's storage) is held by the last
test."""
import pytest

import test_distributed
from _mesh_cells import fake_mesh
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotune import strategy_costs
from repro_torch.models.registry import build_model

LIMIT = 1.25
# (name, arch, config overrides, kind, seq_len, global batch)
CELLS = [
    # 4 q heads over 2 KV heads, and a vocabulary of 4,096 rows
    ("dense", "qwen2.5-14b", dict(d_model=256, n_heads=4, n_kv_heads=2,
                                  head_dim=64, d_ff=512, vocab=4096),
     "decode", 64, 8),
    ("cross", "whisper-medium", {}, "decode", 64, 8),
    ("moe", "olmoe-1b-7b", {}, "decode", 64, 8),
    # 3 experts: the model axis shards the capacity slots instead
    ("moe-slots", "granite-moe-3b-a800m", dict(n_experts=3), "decode", 64,
     8),
    ("mixer", "zamba2-2.7b", {}, "decode", 64, 8),
    ("mixer-b1", "zamba2-2.7b", {}, "decode", 64, 1),
    # prefills: the residual reduced once a block (F20)
    ("dense-prefill", "qwen2.5-14b", dict(d_model=256, n_heads=4,
                                          n_kv_heads=2, head_dim=64,
                                          d_ff=512, vocab=4096),
     "prefill", 64, 8),
    ("residual", "smollm-360m", {}, "prefill", 64, 8),
    ("moe-prefill", "olmoe-1b-7b", {}, "prefill", 64, 8),
    ("vlm-prefill", "qwen2-vl-7b", {}, "prefill", 64, 8),
    # training steps: the residual's partial sums (F22), the MoE (F17)
    ("residual-train", "whisper-medium", {}, "train", 64, 8),
    ("moe-train", "olmoe-1b-7b", {}, "train", 64, 8),
]
MESHES = [(4, 2), (2, 2, 2)]


@pytest.fixture(scope="module")
def reference():
    """{name/mesh: the reference's collective bytes a device}."""
    return test_distributed.run_sub(f"""
        from dataclasses import replace
        from jax.sharding import Mesh
        from repro.configs import ARCHS, reduced
        from repro.configs.base import ShapeConfig
        from repro.launch.cells import cell_fns
        from repro.launch.roofline import analyze_cell
        from repro.models.registry import build_model
        from repro.sharding.context import activation_sharding

        out = {{}}
        for name, arch, kw, kind, seq, batch in {CELLS!r}:
            for m in {MESHES!r}:
                mesh = Mesh(np.asarray(jax.devices()).reshape(m),
                            ("pod", "data", "model")[-len(m):])
                cfg = replace(reduced(ARCHS[arch]), **kw)
                shape = ShapeConfig("c", seq, batch, kind)
                fn, args, in_sh, out_sh, donate = cell_fns(
                    build_model(cfg), shape, "2d", mesh)
                with mesh, activation_sharding(mesh, "2d"):
                    c = jax.jit(fn, in_shardings=in_sh,
                                out_shardings=out_sh,
                                donate_argnums=donate).lower(*args).compile()
                rep = analyze_cell(c, arch=arch, shape=shape, mesh_name="m",
                                   n_devices=8, strategy="2d", cfg=cfg)
                out[f"{{name}}/{{m}}"] = rep.collective_bytes
        print("RESULT:" + json.dumps(out))
    """)


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name,arch,kw,kind,seq,batch", CELLS,
                         ids=[c[0] for c in CELLS])
def test_serving_cell_moves_no_more_than_the_reference(
        reference, name, arch, kw, kind, seq, batch, mesh_shape):
    from dataclasses import replace

    cfg = replace(reduced(ARCHS[arch]), **kw)
    with fake_mesh(mesh_shape) as mesh:
        run = strategy_costs(build_model(cfg),
                             ShapeConfig("c", seq, batch, kind), mesh, "2d")
    want = reference[f"{name}/{mesh_shape}"]
    got = run.costs.collective_bytes
    assert 0 < got <= LIMIT * want, (got, want, got / want)


@pytest.fixture(scope="module")
def reference_pod():
    """The reference's collective bytes a device of xlstm-125m's
    ``long_500k`` cell on the (2, 16, 16) production mesh."""
    return test_distributed.run_sub("""
        from jax.sharding import Mesh
        from repro.configs import ARCHS, SHAPES
        from repro.launch.cells import cell_fns
        from repro.launch.roofline import analyze_cell
        from repro.models.registry import build_model
        from repro.sharding.context import activation_sharding

        mesh = Mesh(np.asarray(jax.devices()).reshape(2, 16, 16),
                    ("pod", "data", "model"))
        cfg, shape = ARCHS["xlstm-125m"], SHAPES["long_500k"]
        fn, args, in_sh, out_sh, donate = cell_fns(build_model(cfg), shape,
                                                   "2d", mesh)
        with mesh, activation_sharding(mesh, "2d"):
            c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                        donate_argnums=donate).lower(*args).compile()
        rep = analyze_cell(c, arch="xlstm-125m", shape=shape, mesh_name="m",
                           n_devices=512, strategy="2d", cfg=cfg)
        print("RESULT:" + json.dumps(rep.collective_bytes))
    """, devices=512)


def test_xlstm_decode_state_stays_on_its_cache_shards(reference_pod):
    from repro_torch.configs import SHAPES

    with fake_mesh((2, 16, 16)) as mesh:
        run = strategy_costs(build_model(ARCHS["xlstm-125m"]),
                             SHAPES["long_500k"], mesh, "2d")
    got = run.costs.collective_bytes
    assert 0 < got <= LIMIT * reference_pod, (got, reference_pod,
                                              got / reference_pod)


def test_a_leading_shard_keeps_no_view_of_the_whole():
    """Fault F21: ``sharding/rules.py::distribute`` kept a chunk of the
    leading dimension as a view of the whole tensor, so a dry-run counted
    every rank's batch whole (whisper-medium's ``prefill_32k`` frames, 2
    GiB a rank of a 4.42 GiB peak). Each rank's chunk is its own
    storage."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.sharding.rules import distribute

    with fake_mesh((4, 2)) as mesh:
        for device in ("meta", "cpu"):
            t = distribute(torch.zeros(8, 3, 5, device=device), mesh,
                           (Shard(0), Replicate()))
            local = t.to_local()
            assert tuple(local.shape) == (2, 3, 5)
            assert local.untyped_storage().nbytes() == 2 * 3 * 5 * 4
        cfg = reduced(ARCHS["whisper-medium"])
        shape = ShapeConfig("c", 64, 8, "prefill")
        run = strategy_costs(build_model(cfg), shape, mesh, "2d")
    # the frames (8, 64, d_model) sharded over 4 data ranks, the tokens
    # (8, 64) int32, and the parameters' shards: under the whole frames
    assert run.arg_bytes < 8 * 64 * cfg.d_model * 4
