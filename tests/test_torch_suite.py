"""The port's workload suite (``repro_torch.workloads.suite``) against the
reference's (``repro.workloads.suite``): the same registry, names, size maps
and seeds; every input equal bit for bit, with the reference's types (its
uint32 hash carried as int32 with the same bits); every kernel's output at
size "s" held to the reference's jitted function; suite generation the same
across interpreters; the same coverage metric."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.workloads import suite as r_suite
from repro_torch.workloads import suite as p_suite

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "suite_dataset_v1.json"
SIZES = ("s", "m", "l", "xl")
# f32 outputs: within this share of the reference output's largest value
# (both sides compute in float32; sums, products and library routines --
# LAPACK, FFT -- may take other orders; the largest gap seen is 2.1e-6)
F32_REL = 1e-5


def _bits(a) -> np.ndarray:
    """A reference array as the port carries it: uint32 as int32 bits."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.fixture(scope="module")
def suites():
    return (r_suite.suite(sizes=SIZES),
            p_suite.suite(sizes=SIZES, device="cpu"))


def test_registry_names_and_size_maps_match():
    assert p_suite.kernel_names() == r_suite.kernel_names()
    assert p_suite.seed_kernel_names() == r_suite.seed_kernel_names()
    assert p_suite.FAMILIES == r_suite.FAMILIES
    for name in ("_SIZES", "_CUBIC", "_PAIRWISE"):
        assert getattr(p_suite, name) == getattr(r_suite, name)
    for reg in ("_SEED_REGISTRY", "_GROWTH_REGISTRY"):
        p, r = getattr(p_suite, reg), getattr(r_suite, reg)
        assert [(a, k, m.__name__, s) for a, k, m, s in p] == \
            [(a, k, m.__name__, s) for a, k, m, s in r]
    assert len(p_suite.kernel_names()) == 82


def test_workload_seeds_match(suites):
    ref, port = suites
    assert len(ref) == len(port) == 328
    for r, p in zip(ref, port):
        assert (p.app, p.kernel, p.variant, p.work_items) == \
            (r.app, r.kernel, r.variant, r.work_items)
        assert p_suite._workload_seed(p.app, p.kernel, p.variant) == \
            r_suite._workload_seed(r.app, r.kernel, r.variant)


@pytest.mark.parametrize("size", SIZES)
def test_inputs_bitwise_equal(suites, size):
    ref, port = suites
    n = 0
    for r, p in zip(ref, port):
        if r.variant != size:
            continue
        assert len(p.args) == len(r.args), r.kernel
        for a, b in zip(r.args, p.args):
            a = _bits(a)
            assert b.device.type == "cpu"
            assert str(b.dtype).split(".")[-1] == a.dtype.name, r.kernel
            assert tuple(b.shape) == a.shape, r.kernel
            assert b.numpy().tobytes() == a.tobytes(), r.kernel
        n += 1
    assert n == 82


def _outputs(x) -> list:
    if isinstance(x, (tuple, list)):
        return [o for v in x for o in _outputs(v)]
    return [x]


@pytest.mark.parametrize("kernel", [k for _, k in r_suite.kernel_names()])
def test_kernel_output_matches_reference(suites, kernel):
    ref, port = suites
    (r,) = [w for w in ref if w.kernel == kernel and w.variant == "s"]
    (p,) = [w for w in port if w.kernel == kernel and w.variant == "s"]
    want = [_bits(o) for o in jax.tree_util.tree_leaves(jax.jit(r.fn)(*r.args))]
    got = [o.numpy() for o in _outputs(p.fn(*p.args))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, kernel
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=kernel)
        else:
            tol = F32_REL * float(np.abs(w).max())
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=kernel)


_DIGEST_SCRIPT = """
import hashlib, sys
sys.path.insert(0, {src!r})
from repro_torch.workloads.suite import suite

h = hashlib.sha256()
for w in suite(sizes=("s",), device="cpu"):
    h.update(f"{{w.app}}/{{w.kernel}}/{{w.variant}}/{{w.work_items}}".encode())
    for a in w.args:
        h.update(str(tuple(a.shape)).encode())
        h.update(str(a.dtype).encode())
        h.update(a.contiguous().numpy().tobytes())
print(h.hexdigest())
""".format(src=str(REPO / "src"))


def _digest(hashseed: str) -> str:
    env = dict(os.environ, PYTHONHASHSEED=hashseed)
    out = subprocess.run([sys.executable, "-c", _DIGEST_SCRIPT],
                         capture_output=True, text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_suite_identical_across_hash_seeds():
    d0, d1 = _digest("0"), _digest("12345")
    assert len(d0) == 64 and d0 == d1


def test_suite_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks a card-less host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_suite.suite(sizes=("s",))


def test_feature_coverage_matches_reference():
    rows = json.loads(FIXTURE.read_text())
    X = np.array([r["features"] for r in rows])
    seed = r_suite.seed_kernel_names()
    mask = np.array([(r["app"], r["kernel"]) in seed for r in rows])
    rng = np.random.default_rng(0)
    spread = rng.lognormal(1.0, 2.0, size=(200, 5))
    for kwargs in (dict(X=X), dict(X=X[mask], ref=X), dict(X=X, bins=5),
                   dict(X=spread), dict(X=np.ones((200, 5)) * 3, ref=spread)):
        assert p_suite.feature_coverage(**kwargs) == \
            r_suite.feature_coverage(**kwargs)
    with pytest.raises(ValueError):
        p_suite.feature_coverage(np.zeros((0, 3)))

