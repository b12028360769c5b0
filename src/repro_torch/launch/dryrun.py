"""Multi-pod dry-run (the port of ``repro.launch.dryrun``).

The reference forces 512 placeholder host devices and lowers and compiles
each (architecture x input shape x mesh) cell. The port has no compiler to
ask: each cell starts a ``fake`` process group of 256 or 512 ranks (no
rank runs, no collective moves data), builds the production mesh over it
(``make_production_mesh``; (16, 16) single-pod, (2, 16, 16) multi-pod)
and runs the cell once on the meta device (no storage, no numbers):

  1. build the model and its cell (``launch/cells.py``): the step (train,
     prefill or decode) and its meta arguments, placed by the strategy;
  2. run the step once under the cost counter (``core/hlo_analysis.py``):
     sharding mismatches and unsupported redistributions surface here as
     hard failures, and the counter records one rank's FLOPs, bytes,
     collectives and live-bytes peak;
  3. derive the roofline terms (``launch/roofline.py``);
  4. take the portable feature vector of the cell's one-device program
     (``core/autotune.py::cell_features``): the predictor's dataset, the
     paper's pipeline applied to the framework itself;
  5. write the record to ``artifacts/dryrun_torch/<tag>.json``, beside
     (never over) the reference's ``artifacts/dryrun``.

The record has the reference's keys. ``lower_s`` is the counting run's
seconds and ``compile_s`` 0.0: nothing compiles. A full-attention arch's
``long_500k`` cell is written ``skipped``, as the reference writes it.

A cell runs every layer op by op on the meta device (some 100-200 us an
op), so its time grows with depth and, for the xLSTM's loops, with the
sequence: smollm-360m's ``train_4k`` takes a minute or two on a host CPU,
an xLSTM prefill of 32,768 tokens far longer.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from dataclasses import asdict
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"


def dry_run(model, shape, mesh, *, mesh_name: str, strategy: str = "2d",
            tag: str | None = None, extract_features: bool = True) -> dict:
    """The record of ``model``'s ``shape`` cell on ``mesh`` under
    ``strategy`` (steps 1-4 of the module docstring), for any mesh and
    any process group."""
    from ..core.autotune import cell_features, strategy_costs
    from ..core.features import LaunchConfig
    from ..core.hlo_analysis import xla_cost_analysis
    from .mesh import mesh_devices
    from .roofline import analyze_cell

    cfg = model.cfg
    n_dev = mesh_devices(mesh)
    tag = tag or f"{cfg.name}__{shape.name}__{mesh_name}__{strategy}"
    run = strategy_costs(model, shape, mesh, strategy)
    rep = analyze_cell(run.costs, peak_bytes=run.peak_bytes,
                       arg_bytes=run.arg_bytes, out_bytes=run.out_bytes,
                       xla_flops=xla_cost_analysis(run)["flops"], arch=cfg.name,
                       shape=shape, mesh_name=mesh_name, n_devices=n_dev,
                       strategy=strategy, cfg=cfg)
    rec = {"tag": tag, "status": "ok", "lower_s": run.seconds,
           "compile_s": 0.0, "report": asdict(rep)}
    if extract_features:
        fv = cell_features(model, shape, mesh, LaunchConfig(
            work_items=float(shape.tokens), n_shards=n_dev))
        rec["features"] = fv.as_dict()
        rec["feature_aux"] = {k: float(v) for k, v in fv.aux.items()}
    return rec


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             strategy: str = "2d", verbose: bool = True,
             save: bool = True, extract_features: bool = True) -> dict:
    """One production cell on a fake process group of 256 or 512 ranks
    (started here and destroyed after)."""
    import torch.distributed as dist

    from ..configs import SHAPES, get_config, supports_shape
    from ..models.registry import build_model
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape.name}__{mesh_name}__{strategy}"

    if not supports_shape(cfg, shape):
        rec = {"tag": tag, "status": "skipped",
               "reason": "full-attention arch: long_500k requires "
                         "sub-quadratic decode (DESIGN.md §4)"}
        if save:
            _save_json(rec, ARTIFACTS / f"{tag}.json")
        if verbose:
            print(f"SKIP {tag}: {rec['reason']}")
        return rec

    # importing it registers torch's "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec = dry_run(build_model(cfg), shape, mesh, mesh_name=mesh_name,
                      strategy=strategy, tag=tag,
                      extract_features=extract_features)
    finally:
        dist.destroy_process_group()
    if verbose:
        rep = rec["report"]
        print(f"CELL {tag}")
        print(f"  counted in {rec['lower_s']:.1f}s (nothing compiles)")
        print(f"  memory: peak {rep['peak_bytes']/2**30:.2f} GiB "
              f"(arguments {rep['arg_bytes']/2**30:.2f}, temporaries "
              f"{rep['temp_bytes']/2**30:.2f}, outputs "
              f"{rep['out_bytes']/2**30:.2f})")
        print(f"  FlopCounterMode: flops={rep['xla_flops']:.3e}; counted "
              f"per rank: flops={rep['hlo_flops']:.3e} "
              f"bytes={rep['hlo_bytes']:.3e}")
        from .roofline import RooflineReport
        print(f"  roofline: {RooflineReport(**rep).row()}")
    if save:
        _save_json(rec, ARTIFACTS / f"{tag}.json")
    return rec


def _save_json(obj, path: Path):
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    tmp.replace(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"], default="pod")
    ap.add_argument("--strategy", default="2d")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    from ..configs import ARCHS, SHAPES

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]

    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "pod2x16x16" if mp else "pod16x16"
                tag = f"{arch}__{shape}__{mesh_name}__{args.strategy}"
                path = ARTIFACTS / f"{tag}.json"
                if args.skip_existing and path.exists():
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"EXISTS {tag}")
                            continue
                try:
                    run_cell(arch, shape, multi_pod=mp,
                             strategy=args.strategy)
                except Exception as e:          # recorded, and the run fails
                    traceback.print_exc()
                    failures.append(tag)
                    _save_json({"tag": tag, "status": "error",
                                "error": f"{type(e).__name__}: {e}"}, path)
    if failures:
        print(f"\nFAILURES ({len(failures)}):")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nDRY-RUN COMPLETE")


if __name__ == "__main__":
    main()
