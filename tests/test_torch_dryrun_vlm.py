"""qwen2-vl's dry-run records (fault F13): every cell of the family failed
in the feature trace, because ``models/common.py::mrope_cos_sin`` made its
band index from ``torch.tensor(sections)``, a constant outside the trace's
fake mode ("Please convert all Tensors to FakeTensors first ... Found in
aten.repeat_interleave.Tensor"). The index is now made from ``arange``
alone. Its reduced ``train_4k``, ``prefill_32k`` and ``decode_32k`` cells
go through ``launch/dryrun.py::dry_run`` with features on a fake (4, 2)
mesh and record ``ok``; the M-RoPE tables equal the reference's."""
import math
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _mesh_cells import fake_mesh
from repro.models.common import mrope_cos_sin as r_mrope_cos_sin
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.features import FEATURE_NAMES
from repro_torch.launch import dryrun
from repro_torch.models.common import mrope_cos_sin, rope_freqs
from repro_torch.models.registry import build_model

KINDS = {"train_4k": "train", "prefill_32k": "prefill",
         "decode_32k": "decode"}


@pytest.mark.parametrize("shape", list(KINDS))
def test_reduced_cell_records_with_features(shape):
    cfg = reduced(ARCHS["qwen2-vl-7b"])
    with fake_mesh((4, 2)) as mesh:
        rec = dryrun.dry_run(build_model(cfg),
                             ShapeConfig(shape, 64, 8, KINDS[shape]), mesh,
                             mesh_name="4x2", strategy="2d")
    assert rec["status"] == "ok"
    assert list(rec["features"]) == FEATURE_NAMES
    assert all(math.isfinite(v) for v in rec["features"].values())
    assert rec["features"]["total_instr"] > 0


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (16, (2, 3, 3))])
def test_mrope_tables_match_reference(head_dim, sections):
    """qwen2-vl-7b's bands and the reduced config's, on seeded (t, h, w)
    ids: the reference's cos and sin at rtol 1e-6, and bit for bit the
    tables of the repeat_interleave index the port used before."""
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (2, 9, 3)).astype(np.int32)
    cos, sin = mrope_cos_sin(torch.as_tensor(pos), head_dim, 1e6, sections)
    r_cos, r_sin = r_mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6, sections)
    np.testing.assert_allclose(cos.numpy(), np.asarray(r_cos), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(r_sin), rtol=1e-6,
                               atol=1e-6)

    freqs = rope_freqs(head_dim, 1e6)
    ang = torch.as_tensor(pos).float()[..., None, :] * freqs[None, None, :,
                                                             None]
    sel = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
    ang = torch.gather(ang, -1, sel[None, None, :, None].expand(
        *ang.shape[:-1], 1))[..., 0]
    assert torch.equal(cos, torch.cos(ang)) and torch.equal(sin,
                                                            torch.sin(ang))


def test_full_width_tables_trace_on_the_meta_device():
    """The table of the full-width config traces under ``make_fx``'s fake
    mode, as the dry-run's feature trace runs it."""
    from torch.fx.experimental.proxy_tensor import make_fx

    cfg = replace(ARCHS["qwen2-vl-7b"])
    pos = torch.empty(2, 7, 3, dtype=torch.int32, device="meta")
    graph = make_fx(lambda p: mrope_cos_sin(p, cfg.resolved_head_dim,
                                            cfg.rope_theta,
                                            cfg.mrope_sections),
                    tracing_mode="fake")(pos)
    assert any(n.op == "call_function" for n in graph.graph.nodes)
