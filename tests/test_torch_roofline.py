"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``): the analytic model FLOPs of every
(arch, shape), the report's schema, and ``finalize``'s terms, dominant term
and ratios bit for bit on the reference's constants."""
import dataclasses
import json

import pytest

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.core.devices import (ROOFLINE_HBM_BW, ROOFLINE_ICI_BW,
                                ROOFLINE_PEAK_FLOPS)
from repro.launch import roofline as r_roofline
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.core.hlo_analysis import HloCosts
from repro_torch.launch import roofline


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_model_flops_match_reference(arch, shape):
    assert roofline.model_flops_for(ARCHS[arch], SHAPES[shape]) == \
        r_roofline.model_flops_for(R_ARCHS[arch], R_SHAPES[shape])


def test_report_has_the_reference_fields():
    names = [f.name for f in dataclasses.fields(roofline.RooflineReport)]
    assert names == [f.name for f in
                     dataclasses.fields(r_roofline.RooflineReport)]


# per-device (flops, bytes, collective bytes): one cell each of compute,
# memory and collective dominance on v5e, and one with nothing counted
COSTS = [(3.1e15, 2.2e11, 4.0e9), (1.0e12, 9.0e11, 1.0e9),
         (2.0e12, 1.0e10, 7.5e11), (0.0, 0.0, 0.0)]


@pytest.mark.parametrize("flops,hbm,coll", COSTS)
def test_finalize_matches_reference_bit_for_bit(flops, hbm, coll):
    kw = dict(arch="smollm-360m", shape="train_4k", mesh="pod16x16",
              n_devices=256, strategy="2d", hlo_flops=flops, hlo_bytes=hbm,
              collective_bytes=coll, collective_breakdown={"all-gather": coll},
              xla_flops=0.0, xla_bytes=0.0, arg_bytes=1, out_bytes=2,
              temp_bytes=3, peak_bytes=6, fits_hbm=True,
              model_flops=r_roofline.model_flops_for(
                  R_ARCHS["smollm-360m"], R_SHAPES["train_4k"]))
    want = r_roofline.RooflineReport(**kw).finalize()
    got = roofline.RooflineReport(**kw).finalize(
        peak_flops=ROOFLINE_PEAK_FLOPS, hbm_bw=ROOFLINE_HBM_BW,
        link_bw=ROOFLINE_ICI_BW)
    for name in ("t_compute", "t_memory", "t_collective", "dominant",
                 "useful_ratio", "roofline_frac"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.row() == want.row()


def test_constants_are_the_cards_data_sheet():
    assert roofline.ROOFLINE_PEAK_FLOPS == 989.4e12
    assert roofline.ROOFLINE_HBM_BW == 3.35e12
    assert roofline.ROOFLINE_LINK_BW == 450e9
    assert 80e9 < roofline.HBM_PER_CHIP < 2 ** 37


def test_analyze_cell_splits_the_peak(tmp_path):
    costs = HloCosts(flops=2e12, hbm_bytes=3e11, collective_bytes=9e9,
                     collective_bytes_by_op={"all-gather": 9e9})
    rep = roofline.analyze_cell(
        costs, peak_bytes=10 * 2**30, arg_bytes=4 * 2**30,
        out_bytes=4 * 2**30, xla_flops=3e12, arch="smollm-360m",
        shape=SHAPES["train_4k"], mesh_name="pod16x16", n_devices=256,
        strategy="2d", cfg=ARCHS["smollm-360m"])
    assert rep.temp_bytes == 2 * 2**30
    assert rep.peak_bytes_tpu == rep.peak_bytes and rep.cpu_upcast_bytes == 0
    assert rep.fits_hbm and rep.fits_hbm_tpu
    assert rep.dominant == "memory"
    assert rep.t_bound == rep.t_memory == 3e11 / roofline.ROOFLINE_HBM_BW
    assert rep.xla_flops == 3e12
    assert rep.useful_ratio == rep.model_flops / (2e12 * 256)
    roofline.save_report(rep, tmp_path / "r.json")
    assert json.loads((tmp_path / "r.json").read_text()) == \
        dataclasses.asdict(rep)
