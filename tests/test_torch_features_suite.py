"""The port's feature walker over the port's whole workload suite, against
the features the reference wrote into ``tests/fixtures/suite_dataset_v1.json``
(no JAX needed): the launch features and ``sync_ops`` equal, ``aux.io_bytes``
exact on all 328 workloads, ``aux.flops`` exact on the dense linear-algebra
and convolution kernels, and each other feature's rank correlation with the
reference's over the suite above a bar."""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.features import FEATURE_NAMES, LaunchConfig, extract
from repro_torch.workloads.suite import suite

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "suite_dataset_v1.json"
SIZES = ("s", "m", "l", "xl")
EQUAL = ("work_per_shard", "num_shards", "sync_ops", "shared_mem_vol")
FLOPS_EXACT = ("gemm", "2mm", "3mm", "syrk", "syr2k", "2dconv", "3dconv")
# Spearman over the 328 workloads. The four counts the port reproduces op
# for op carry the bars the port is built to; the others are pinned at
# their measured correlation (torch 2.13, CPU) less 0.05, because the
# reference counts ops that a torch graph does not have:
# * special_ops (measured 1.000): none missing;
# * logic_ops (0.979): jnp.take's bounds masks (dwt2d), the pivot-search
#   loop inside jnp.linalg.solve (gaussian), jnp.std's select (correlation);
# * control_ops (0.881): every func.call, and jnp outlines its helpers as
#   private functions (_take, _where, clip, _mean, _var, log_softmax,
#   take_along_axis: dwt2d 16 calls, backprop 4, devicememory 3); torch
#   has no calls;
# * param_mem_vol (0.700): the constants of the LAPACK calls' lowering
#   (lud, ludcmp, gaussian: 72-140 bytes) and of tril's masks (trmm, symm).
RHO_MIN = {"total_instr": 0.9, "arith_ops": 0.9, "global_mem_vol": 0.9,
           "arith_intensity": 0.8, "special_ops": 1.000 - 0.05,
           "logic_ops": 0.979 - 0.05, "control_ops": 0.881 - 0.05,
           "param_mem_vol": 0.700 - 0.05}


def _spearman(a, b) -> float:
    from scipy.stats import rankdata
    return float(np.corrcoef(rankdata(a), rankdata(b))[0, 1])


@pytest.fixture(scope="module")
def extracted():
    """(workload, port features, fixture record) for the whole suite."""
    fixture = {(r["app"], r["kernel"], r["variant"]): r
               for r in json.loads(FIXTURE.read_text())}
    out = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        for w in suite(sizes=SIZES, device="cpu"):
            fv = extract(w.fn, *w.args,
                         launch=LaunchConfig(work_items=w.work_items))
            out.append((w, fv, fixture[(w.app, w.kernel, w.variant)]))
    assert len(out) == 328
    return out


@pytest.mark.parametrize("size", SIZES)
def test_io_bytes_exact(extracted, size):
    rows = [(w, fv, ref) for w, fv, ref in extracted if w.variant == size]
    assert len(rows) == 82
    off = {w.kernel: (fv.aux["io_bytes"], ref["aux"]["io_bytes"])
           for w, fv, ref in rows
           if fv.aux["io_bytes"] != ref["aux"]["io_bytes"]}
    assert not off


@pytest.mark.parametrize("kernel", FLOPS_EXACT)
def test_flops_exact(extracted, kernel):
    rows = [(w, fv, ref) for w, fv, ref in extracted if w.kernel == kernel]
    assert len(rows) == 4
    for w, fv, ref in rows:
        assert fv.aux["flops"] == ref["aux"]["flops"], w.variant


@pytest.mark.parametrize("name", EQUAL)
def test_launch_and_sync_features_equal(extracted, name):
    j = FEATURE_NAMES.index(name)
    for w, fv, ref in extracted:
        assert fv.values[j] == ref["features"][j], (w.kernel, w.variant)


@pytest.mark.parametrize("name", sorted(RHO_MIN))
def test_rank_correlation_with_reference(extracted, name):
    j = FEATURE_NAMES.index(name)
    port = np.array([fv.values[j] for _, fv, _ in extracted])
    ref = np.array([r["features"][j] for _, _, r in extracted])
    assert _spearman(port, ref) >= RHO_MIN[name]


def test_aux_matches_the_feature_vector(extracted):
    """The aux counts are the vector's own: the same keys as the fixture's,
    special and control ops equal to their features, hbm_bytes equal to
    the global memory volume."""
    for w, fv, ref in extracted:
        assert set(fv.aux) == set(ref["aux"]), w.kernel
        assert fv.aux["special_ops"] == fv["special_ops"]
        assert fv.aux["control_ops"] == fv["control_ops"]
        assert fv.aux["hbm_bytes"] == fv["global_mem_vol"]
        assert np.isfinite(fv.values).all()
