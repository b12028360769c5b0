"""Predictive sharding auto-tuner (the port of ``repro.core.autotune``): the
paper's model applied to the framework's own scheduling problem (paper §1:
"predictions of execution time allow to select the fastest
processor/configuration for a given workload").

For every candidate sharding strategy:
  1. run the train step under that strategy once on meta arguments, on the
     caller's mesh, under the cost counter (``core/hlo_analysis.py``): the
     per-rank FLOPs, bytes and collectives;
  2. take the hardware-independent feature vector of the step,
  3. predict step time with the trained forest,
  4. rank.

Without a trained forest the analytic roofline estimate (the paper's AM
baseline, §7.2, generalised with the collective term) ranks them.

The reference reads its features from each strategy's StableHLO before
partitioning, which is the same text for every strategy (shardings are
annotations), and separates the candidates by the partitioned programs'
collectives. The port takes that one pre-partition vector directly: the
features of the ONE-DEVICE train step, traced on meta tensors by
``features.trace_graph`` (``make_fx``, which follows
``torch.autograd.grad`` where ``torch.export`` cannot) and walked by
``features.extract_from_graph``;
each strategy's counted collectives are injected into it. An eager graph
has no loops, so its ``control_ops`` is 0 where the reference counts its
scans.

``autotune_strategy``'s default device is ``H100``, a ``DeviceModel`` of
the card's data-sheet constants (``launch/roofline.py``). It is local to
this module and not in ``core/devices.py``'s registry.
``launch/train.py --autotune`` calls it.
"""
from __future__ import annotations

import copy
import time
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..launch.roofline import (HBM_PER_CHIP, ROOFLINE_HBM_BW,
                               ROOFLINE_LINK_BW, ROOFLINE_PEAK_FLOPS)
from .devices import DeviceModel, TPU_V5E
from .features import (FEATURE_NAMES, FeatureVector, LaunchConfig,
                       extract_from_graph, trace_graph)

# The card's constants: only peak_flops, hbm_bw and ici_bw are read (by
# ``_roofline_estimate``); the rest are the data sheet's where it has them
# (50 MB of L2, 700 W) and 0 where it has none.
H100 = DeviceModel(
    name="nvidia-h100-80gb-hbm3", clazz="server",
    peak_flops=ROOFLINE_PEAK_FLOPS, hbm_bw=ROOFLINE_HBM_BW,
    ici_bw=ROOFLINE_LINK_BW, vmem_bytes=50 * 2**20, hbm_bytes=HBM_PER_CHIP,
    idle_w=0.0, peak_w=700.0, latency_floor_us=0.0, freq_jitter=0.0,
    sample_hz=0.0, simulated=False)


@dataclass
class AutotuneResult:
    best: str
    ranked: list            # [(strategy, predicted_seconds)]
    features: dict          # strategy -> feature dict
    lower_seconds: float
    predict_seconds: float


def _roofline_estimate(fv, device: DeviceModel) -> float:
    """Fallback analytical ranker (paper's AM baseline, §7.2) — roofline over
    the same hardware-independent features the forest consumes. Collective
    bytes are per-device when injected from compiled costs."""
    aux = fv.aux
    n = max(aux.get("n_shards", 1), 1)
    t_comp = aux["flops"] / n / device.peak_flops
    t_mem = aux["hbm_bytes"] / n / device.hbm_bw
    t_coll = aux["collective_bytes"] / max(device.ici_bw, 1.0)
    return max(t_comp, t_mem, t_coll) + 0.3 * min(t_comp, t_mem)


def rank_candidates(programs: dict, launch: LaunchConfig,
                    predictor=None, device: DeviceModel = TPU_V5E,
                    log_target: bool = True, compiled_costs: dict | None = None,
                    ) -> AutotuneResult:
    """programs: {name: FeatureVector, or an fx graph (``trace_graph``)}.

    ``compiled_costs`` ({name: HloCosts}, per rank) injects each strategy's
    counted collective volumes and counts, and its FLOPs and bytes scaled
    to the whole mesh: the pre-partition features are the same for every
    strategy, so candidates only separate by what runs on the shards."""
    t0 = time.perf_counter()
    feats = {}
    for name, prog in programs.items():
        fv = (copy.deepcopy(prog) if isinstance(prog, FeatureVector)
              else extract_from_graph(prog, launch))
        cc = (compiled_costs or {}).get(name)
        if cc is not None:
            fv.aux["collective_bytes"] = cc.collective_bytes
            n_sync = float(sum(cc.collective_counts.values()))
            fv.values[FEATURE_NAMES.index("sync_ops")] = n_sync
            # per-rank flops/bytes: rescale to globals
            fv.aux["flops"] = cc.flops * launch.n_shards
            fv.aux["hbm_bytes"] = cc.hbm_bytes * launch.n_shards
        feats[name] = fv
    t_feat = time.perf_counter() - t0

    t0 = time.perf_counter()
    scores = {}
    if predictor is not None:
        X = np.stack([feats[n].values for n in feats]).astype(np.float32)
        pred = predictor(X)
        pred = np.exp(pred) if log_target else pred
        for n, p in zip(feats, np.asarray(pred)):
            scores[n] = float(p) * 1e-6          # predictor outputs us
    else:
        for n, fv in feats.items():
            scores[n] = _roofline_estimate(fv, device)
    t_pred = time.perf_counter() - t0

    ranked = sorted(scores.items(), key=lambda kv: kv[1])
    return AutotuneResult(
        best=ranked[0][0], ranked=ranked,
        features={n: fv.as_dict() for n, fv in feats.items()},
        lower_seconds=t_feat, predict_seconds=t_pred)


def strategy_costs(model, shape, mesh, strategy: str):
    """The counted run (``hlo_analysis.CountedRun``) of ``model``'s
    ``shape`` cell under ``strategy`` on ``mesh``: ``cell_fns``'s step on
    its meta arguments, placed by the cell."""
    from ..launch.cells import cell_fns
    from ..launch.mesh import mesh_devices
    from ..sharding.context import activation_sharding
    from ..sharding.rules import distribute_tree
    from .hlo_analysis import count_program

    fn, args, in_pl, _, _ = cell_fns(model, shape, strategy, mesh)
    args = [distribute_tree(a, mesh, pl) for a, pl in zip(args, in_pl)]
    with activation_sharding(mesh, strategy):
        return count_program(fn, *args, n_devices=mesh_devices(mesh))


def cell_features(model, shape, mesh, launch: LaunchConfig
                  ) -> FeatureVector:
    """The pre-partition features of ``model``'s ``shape`` cell on
    ``mesh``: the cell's function (a train step with the cell's
    microbatches) traced on its meta arguments unplaced, as one device
    runs it."""
    from ..launch.cells import cell_fns

    fn, args, _, _, _ = cell_fns(model, shape, "2d", mesh)
    return extract_from_graph(trace_graph(fn, *args), launch)


def _plain_model(model):
    """``model`` with its kernels' plain versions (``use_pallas`` off):
    the cells run on the meta device, where no kernel launches, and a
    kernel launch counts its plain version's FLOPs anyway."""
    if not model.cfg.use_pallas:
        return model
    from ..models.registry import build_model

    return build_model(replace(model.cfg, use_pallas=False))


def autotune_strategy(model, shape, mesh, strategies=("2d", "tp", "zero3"),
                      predictor=None, device: DeviceModel = H100
                      ) -> AutotuneResult:
    """Count the model's train step under each named strategy on ``mesh``
    (meta arguments) and rank."""
    from ..launch.mesh import mesh_devices

    model = _plain_model(model)
    n_dev = mesh_devices(mesh)
    costs = {s: strategy_costs(model, shape, mesh, s).costs
             for s in strategies}
    launch = LaunchConfig(work_items=float(shape.tokens), n_shards=n_dev)
    fv = cell_features(model, shape, mesh, launch)
    return rank_candidates({s: fv for s in strategies}, launch,
                           predictor=predictor, device=device,
                           compiled_costs=costs)
