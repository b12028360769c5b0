"""The port's autotuner (``repro_torch.core.autotune``) against the
reference's (``repro.core.autotune``): the reference's three ranking cases
(tests/test_autotune.py) on fx graphs in place of StableHLO text, the
features of the one-device step, and ``autotune_strategy`` on the small
cell over a (4, 2) mesh, the port on a fake process group and the
reference in a subprocess with 8 host devices."""
from dataclasses import replace

import numpy as np
import pytest
import torch

import test_distributed
from _mesh_cells import fake_mesh
from repro.core.devices import (ROOFLINE_HBM_BW, ROOFLINE_ICI_BW,
                                ROOFLINE_PEAK_FLOPS)
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.autotune import (autotune_strategy, cell_features,
                                       rank_candidates, strategy_costs)
from repro_torch.core.devices import TPU_V5E
from repro_torch.core.features import FEATURE_NAMES, LaunchConfig, trace_graph
from repro_torch.core.hlo_analysis import HloCosts
from repro_torch.models.registry import build_model


def _graph(n: int):
    """The reference's ``_lowered_text``: n steps of c = tanh(c @ w) and a
    sum, on (8, 32) and (32, 32) float32."""
    def f(x, w):
        c = x
        for _ in range(n):
            c = torch.tanh(c @ w)
        return c.sum()
    return trace_graph(f, torch.empty(8, 32, device="meta"),
                      torch.empty(32, 32, device="meta"))


def test_rank_candidates_orders_by_cost():
    res = rank_candidates({"cheap": _graph(2), "pricey": _graph(40)},
                          LaunchConfig(work_items=256, n_shards=4))
    assert res.best == "cheap"
    assert res.ranked[0][1] <= res.ranked[1][1]


def test_compiled_costs_break_ties():
    g = _graph(4)
    costs = {
        "a": HloCosts(flops=1e9, hbm_bytes=1e6, collective_bytes=1e3,
                      collective_counts={"all-reduce": 2}),
        "b": HloCosts(flops=1e9, hbm_bytes=1e6, collective_bytes=1e12,
                      collective_counts={"all-gather": 90}),
    }
    res = rank_candidates({"a": g, "b": g},
                          LaunchConfig(work_items=256, n_shards=4),
                          compiled_costs=costs)
    assert res.best == "a"
    assert res.features["b"]["sync_ops"] == 90.0


def test_trained_predictor_path():
    def predictor(X):
        # pretend-forest: log-time proportional to arith_ops
        return np.log(X[:, FEATURE_NAMES.index("arith_ops")] + 1.0)

    res = rank_candidates({"x": _graph(2), "y": _graph(20)},
                          LaunchConfig(work_items=8, n_shards=1),
                          predictor=predictor)
    assert res.best == "x"
    assert res.predict_seconds < 0.5          # paper §7.1 budget


SMALL = dict(d_model=64, n_layers=4)
SHAPE = (64, 8)                               # seq_len, global batch
STRATEGIES = ("2d", "tp", "zero3")


def _small_model():
    return build_model(replace(reduced(ARCHS["smollm-360m"]), **SMALL))


def _dominant(flops, hbm, coll) -> str:
    """The roofline's dominant term on v5e (the reference's constants)."""
    terms = {"compute": flops / ROOFLINE_PEAK_FLOPS,
             "memory": hbm / ROOFLINE_HBM_BW,
             "collective": coll / ROOFLINE_ICI_BW}
    return max(terms, key=terms.get)


@pytest.fixture(scope="module")
def reference():
    """The reference's autotune on the small cell over a (4, 2) mesh of 8
    host devices, and each strategy's per-device costs."""
    return test_distributed.run_sub(f"""
        from dataclasses import replace
        from jax.sharding import Mesh
        from repro.configs import ARCHS, reduced
        from repro.configs.base import ShapeConfig
        from repro.core import hlo_analysis
        from repro.core.autotune import autotune_strategy
        from repro.models.registry import build_model

        seen = []
        analyze = hlo_analysis.analyze_hlo_text

        def recording(*args, **kwargs):
            c = analyze(*args, **kwargs)
            seen.append([c.flops, c.hbm_bytes, c.collective_bytes,
                         c.collective_counts])
            return c
        hlo_analysis.analyze_hlo_text = recording
        mesh = Mesh(np.asarray(jax.devices()).reshape(4, 2),
                    ("data", "model"))
        cfg = replace(reduced(ARCHS["smollm-360m"]), **{SMALL!r})
        res = autotune_strategy(build_model(cfg),
                                ShapeConfig("t", *{SHAPE!r}, "train"), mesh,
                                strategies={STRATEGIES!r})
        print("RESULT:" + json.dumps({{
            "ranked": res.ranked, "costs": dict(zip({STRATEGIES!r}, seen))}}))
    """)


def test_autotune_order_and_dominant_term_match_reference(reference):
    """``autotune_strategy`` with the reference's device (v5e) ranks the
    three strategies in the reference's order (``2d`` and ``zero3`` are
    one program on a mesh without a pod axis, so they tie on both sides,
    kept in the order given), and each strategy's dominant roofline term
    is the reference's (collective, on both sides). DTensor's
    redistributions are not XLA's collectives: the counts differ (under
    ``2d`` 76 all-gathers, 46 all-reduces and 33 reduce-scatters against
    the reference's 77, 30, no reduce-scatter, 2 all-to-alls and a
    collective-permute; under ``tp`` 13, 57 and 11 against 27
    all-reduces), not the order."""
    from repro_torch.core import autotune

    costs = {}

    def recording(model, shape, mesh, strategy):
        run = strategy_costs(model, shape, mesh, strategy)
        costs[strategy] = run.costs
        return run
    with fake_mesh((4, 2)) as mesh, pytest.MonkeyPatch.context() as mp:
        mp.setattr(autotune, "strategy_costs", recording)
        res = autotune_strategy(_small_model(),
                                ShapeConfig("t", *SHAPE, "train"), mesh,
                                strategies=STRATEGIES, device=TPU_V5E)
    assert [s for s, _ in res.ranked] == [s for s, _ in reference["ranked"]]
    assert res.best == reference["ranked"][0][0] == "tp"
    for s in STRATEGIES:
        c = costs[s]
        want = _dominant(*reference["costs"][s][:3])
        assert _dominant(c.flops, c.hbm_bytes, c.collective_bytes) == want
        assert sum(c.collective_counts.values()) > 0
    assert all(np.isfinite(t) and t > 0 for _, t in res.ranked)


def test_step_features_where_the_reference_has_them():
    """The one-device step's 12 features (``make_fx`` through the
    gradient) are finite, and nonzero wherever the reference's (its
    pre-partition StableHLO of the same cell) are, but ``control_ops``: the
    eager graph unrolls the layers the reference scans (34 there, 0
    here)."""
    import jax

    from repro.configs import ARCHS as R_ARCHS
    from repro.configs import reduced as r_reduced
    from repro.configs.base import ShapeConfig as RShapeConfig
    from repro.core.features import LaunchConfig as RLaunchConfig
    from repro.core.features import extract_from_text
    from repro.models.registry import build_model as r_build
    from repro.train import OptConfig as ROptConfig
    from repro.train import abstract_train_state as r_abstract
    from repro.train import make_train_step as r_make_step

    r_model = r_build(replace(r_reduced(R_ARCHS["smollm-360m"]), **SMALL))
    text = jax.jit(r_make_step(r_model, ROptConfig())).lower(
        r_abstract(r_model),
        r_model.input_specs(RShapeConfig("t", *SHAPE, "train"))).as_text()
    want = extract_from_text(text, RLaunchConfig(work_items=512.0,
                                                 n_shards=8)).as_dict()
    with fake_mesh((4, 2)) as mesh:
        got = cell_features(_small_model(), ShapeConfig("t", *SHAPE, "train"),
                            mesh, LaunchConfig(work_items=512.0, n_shards=8))
    got = got.as_dict()
    assert all(np.isfinite(v) for v in got.values())
    for name in FEATURE_NAMES:
        if name != "control_ops" and want[name]:
            assert got[name] > 0, name
    assert got["control_ops"] == 0.0 and want["control_ops"] > 0
    assert got["arith_ops"] == pytest.approx(want["arith_ops"], rel=0.10)
