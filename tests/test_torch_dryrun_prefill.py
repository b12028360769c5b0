"""Faults F24 and F26 (ROADMAP section 3): the dry-run's ``prefill_32k``
peaks a rank, 1.22-4.40x the reference's, and smollm-360m's ``train_4k``
peak on the (2, 16, 16) pod mesh, 1.154x.

The tally (``tools/mesh_peaks.py --tally``) named these causes, each held
here by one cell cut in depth at full width and length, on a fake (16, 16)
and (2, 16, 16) mesh under ``2d`` with torch 2.11's view rule, within
1.15x the reference's count of the same cut cell (``peak_bytes_tpu``,
lowered and compiled on 512 host devices in a subprocess that runs beside
the counts). The parent's count of each, over the reference's, on (16, 16)
/ (2, 16, 16):

- the K/V caches: every layer's K/V whole over the model axis, kept in
  lists and stacked, so twice (``sharding/context.py::LayerStack``):
  qwen1.5-110b cut to 2 layers, 1.431 / 1.384;
- the norms' whole float32 copies of the residual (``models/common.py::
  in_row_chunks``) and activations that Python frames kept alive
  (the embedding, a block's input beside its output): zamba2-2.7b cut to
  one group of 6 layers, 1.809 / 1.913;
- the context-parallel merge's float32 products of the whole output and
  ``_sdpa``'s float32 chunk outputs (``models/attention.py::
  merge_in_rows``, ``_sdpa_lean``): smollm-360m cut to 2 layers, 2.418 /
  2.723;
- the MoE's dispatch buffer made twice by an out-of-place scatter
  (``models/moe.py::_scatter_rows``): olmoe-1b-7b cut to 1 layer, 1.336 /
  1.222.

Every cell's rotary tables were also made whole for the global batch on
every rank (``sharding/context.py::batch_tables``). F26: smollm-360m's
``train_4k`` at full depth on (2, 16, 16), 1.154x (at 8 layers the parent
is already within, 0.986x): the norms kept float32 copies of their input
for the backward (``_RMSNorm`` keeps x and its root), and the rotary
tables."""
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import pytest

import test_distributed
from _mesh_cells import fake_mesh, view_rule_2_11
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core.autotune import strategy_costs
from repro_torch.models.registry import build_model

PEAK_LIMIT = 1.15
MESHES = [(16, 16), (2, 16, 16)]
# cause: (arch, layers, shape, meshes)
CELLS = {
    "caches": ("qwen1.5-110b", 2, "prefill_32k", MESHES),
    "norms": ("zamba2-2.7b", 6, "prefill_32k", MESHES),
    "merge": ("smollm-360m", 2, "prefill_32k", MESHES),
    "dispatch": ("olmoe-1b-7b", 1, "prefill_32k", MESHES),
    "f26": ("smollm-360m", 32, "train_4k", [(2, 16, 16)]),
}
CASES = [(cause, m) for cause, cell in CELLS.items() for m in cell[3]]


def _reference_code() -> str:
    cells = [(a, n, s, m) for a, n, s, ms in CELLS.values() for m in ms]
    return f"""
        from dataclasses import replace
        from jax.sharding import Mesh
        from repro.configs import ARCHS, SHAPES
        from repro.launch.cells import cell_fns
        from repro.launch.roofline import analyze_cell
        from repro.models.registry import build_model
        from repro.sharding.context import activation_sharding

        out = {{}}
        for arch, layers, shape_name, m in {cells!r}:
            n = int(np.prod(m))
            mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(m),
                        ("pod", "data", "model")[-len(m):])
            cfg = replace(ARCHS[arch], n_layers=layers)
            shape = SHAPES[shape_name]
            fn, args, in_sh, out_sh, donate = cell_fns(
                build_model(cfg), shape, "2d", mesh)
            with mesh, activation_sharding(mesh, "2d"):
                c = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,
                            donate_argnums=donate).lower(*args).compile()
            rep = analyze_cell(c, arch=arch, shape=shape, mesh_name="m",
                               n_devices=n, strategy="2d", cfg=cfg)
            out[f"{{arch}}:{{layers}}:{{shape_name}}:{{m}}"] = \\
                rep.peak_bytes_tpu
        print("RESULT:" + json.dumps(out))
    """


@pytest.fixture(scope="module", autouse=True)
def reference_peaks():
    """{cell: the reference's peak_bytes_tpu a device}, compiled in a
    subprocess started before the first count and read after it."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(test_distributed.run_sub, _reference_code(),
                          devices=512)


@pytest.mark.parametrize("cause,mesh_shape", CASES,
                         ids=lambda v: v if isinstance(v, str)
                         else "x".join(map(str, v)))
def test_peak_within_the_reference(reference_peaks, cause, mesh_shape):
    arch, layers, shape, _ = CELLS[cause]
    model = build_model(replace(ARCHS[arch], n_layers=layers))
    with fake_mesh(mesh_shape) as mesh, view_rule_2_11():
        run = strategy_costs(model, SHAPES[shape], mesh, "2d")
    want = reference_peaks.result()[f"{arch}:{layers}:{shape}:{mesh_shape}"]
    assert 0 < run.peak_bytes <= PEAK_LIMIT * want, (
        run.peak_bytes, want, run.peak_bytes / want)
