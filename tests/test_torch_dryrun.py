"""The port's dry-run (``repro_torch.launch.dryrun``): one reduced cell end
to end on a fake (4, 2) mesh, its record in the reference's schema and its
features read back by ``workloads.collect.cells_dataset``; the ``skipped``
record of a full-attention arch's ``long_500k``, as the reference writes
it."""
import dataclasses
import json
from dataclasses import replace

import numpy as np

from _mesh_cells import fake_mesh
from repro.launch.roofline import RooflineReport as RRooflineReport
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.features import FEATURE_NAMES
from repro_torch.launch import dryrun
from repro_torch.models.registry import build_model
from repro_torch.workloads.collect import cells_dataset

# the keys of the reference's record of a cell (launch/dryrun.py::run_cell)
RECORD_KEYS = {"tag", "status", "lower_s", "compile_s", "report", "features",
               "feature_aux"}


def test_reduced_cell_end_to_end(tmp_path):
    """Reduced smollm-360m (d_model 64, 4 layers), a (8, 64) training step
    under ``2d`` on a fake (4, 2) mesh: counted, reported and featured; the
    sharded step communicates; ``cells_dataset`` reads the record back."""
    cfg = replace(reduced(ARCHS["smollm-360m"]), d_model=64, n_layers=4)
    with fake_mesh((4, 2)) as mesh:
        rec = dryrun.dry_run(build_model(cfg), ShapeConfig("t", 64, 8, "train"),
                             mesh, mesh_name="4x2", strategy="2d")
    assert set(rec) == RECORD_KEYS
    assert rec["tag"] == f"{cfg.name}__t__4x2__2d" and rec["status"] == "ok"
    assert rec["lower_s"] > 0 and rec["compile_s"] == 0.0
    rep = rec["report"]
    assert list(rep) == [f.name for f in dataclasses.fields(RRooflineReport)]
    assert rep["hlo_flops"] > 0 and rep["hlo_bytes"] > 0
    assert sum(rep["collective_breakdown"].values()) > 0
    assert rep["dominant"] in ("compute", "memory", "collective")
    assert rep["fits_hbm"] and rep["peak_bytes"] >= rep["arg_bytes"] > 0
    assert rep["n_devices"] == 8 and rep["model_flops"] > 0
    assert list(rec["features"]) == FEATURE_NAMES
    assert rec["feature_aux"]["n_shards"] == 8.0

    dryrun._save_json(rec, tmp_path / f"{rec['tag']}.json")
    ds = cells_dataset(tmp_path)
    assert len(ds.samples) == 1
    s = ds.samples[0]
    assert s.app == f"framework-{cfg.name}" and s.kernel == "t"
    np.testing.assert_array_equal(
        np.asarray(s.features),
        [rec["features"][n] for n in FEATURE_NAMES])


def test_long_context_cell_of_a_full_attention_arch_is_skipped(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k"])
    tag = "smollm-360m__long_500k__pod16x16__2d"
    rec = json.loads((tmp_path / f"{tag}.json").read_text())
    assert rec == {"tag": tag, "status": "skipped",
                   "reason": "full-attention arch: long_500k requires "
                             "sub-quadratic decode (DESIGN.md §4)"}
    out = capsys.readouterr().out
    assert f"SKIP {tag}" in out and "DRY-RUN COMPLETE" in out
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                 "--skip-existing"])
    assert f"EXISTS {tag}" in capsys.readouterr().out


def test_cells_dataset_reads_the_ports_records():
    """The port's dataset of dry-run cells comes from the port's own
    records, never the reference's ``artifacts/dryrun``."""
    from repro_torch.workloads import collect

    assert collect.DRYRUN_DIR == dryrun.ARTIFACTS
    assert dryrun.ARTIFACTS.parts[-2:] == ("artifacts", "dryrun_torch")
