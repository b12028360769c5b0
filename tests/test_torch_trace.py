"""The port's trace replay (``repro_torch.workloads.trace``) against the
reference's (``repro.workloads.trace``): the generators write the same
bytes from the same seeds, each codec reads the other's traces and fails
on the same damage, and the golden trace replayed through the port's demo
frontend on the CPU gives the reference's digest byte for byte."""
from pathlib import Path

import jax  # noqa: F401  (the reference's engine imports it)
import numpy as np
import pytest

from repro.cluster.remote import demo_frontend as r_demo_frontend
from repro.workloads import trace as r_tr
from repro_torch.cluster.remote import demo_frontend
from repro_torch.workloads import trace as p_tr

FIXTURE = Path(__file__).parent / "fixtures" / "trace_golden_v1.jsonl"

GENERATORS = {
    "diurnal": ("gen_diurnal", dict(duration_s=4.0, mean_rate=20.0,
                                    peak_to_trough=4.0, seed=1,
                                    deadline_band=(0.1, 0.5))),
    "bursts": ("gen_bursts", dict(duration_s=3.0, rate_quiet=5.0,
                                  rate_burst=60.0, mean_quiet_s=0.5,
                                  mean_burst_s=0.2, seed=2)),
    "adversarial": ("gen_adversarial", dict(duration_s=2.0, rate=25.0,
                                            seed=3, deadline_band=(1, 2))),
    "tenant_mix": ("gen_tenant_mix", dict(duration_s=2.0, seed=11, tenants={
        "interactive": {"rate": 30.0, "deadline_band": (0.5, 2.0)},
        "batch": {"rate": 20.0, "deadline_band": None},
        "best-effort": {"rate": 10.0, "deadline_band": (2.0, 5.0),
                        "priority": 9}})),
}


@pytest.mark.parametrize("kind", sorted(GENERATORS))
def test_generators_write_the_same_bytes(kind):
    name, kw = GENERATORS[kind]
    ids, X = p_tr.synthetic_catalog(12, 6, seed=7)
    r_ids, r_X = r_tr.synthetic_catalog(12, 6, seed=7)
    assert ids == r_ids
    np.testing.assert_array_equal(X, r_X)
    data = p_tr.dumps_trace(getattr(p_tr, name)(ids, X, **kw))
    assert data == r_tr.dumps_trace(getattr(r_tr, name)(r_ids, r_X, **kw))
    assert p_tr.dumps_trace(r_tr.loads_trace(data)) == data
    assert r_tr.dumps_trace(p_tr.loads_trace(data)) == data


@pytest.mark.parametrize("mangle", [
    lambda d: d[:len(d) - 7],                    # torn final line
    lambda d: d[:40] + b"X" + d[41:],            # a flipped byte
    lambda d: d.split(b"\n", 1)[1],              # no header
    lambda d: b"not a trace\n",
], ids=["torn", "flipped", "headless", "garbage"])
def test_codec_fails_alike(mangle):
    data = mangle(FIXTURE.read_bytes())
    kinds = []
    for mod in (p_tr, r_tr):
        with pytest.raises(mod.TraceError) as info:
            mod.loads_trace(data)
        kinds.append(type(info.value).__name__)
    assert kinds[0] == kinds[1]


def test_golden_digest_is_the_reference_s():
    """The committed golden trace, replayed sequentially through the
    port's demo frontend on the CPU (``flat-numpy``, the reference's
    backend), digests byte-identically to the reference's replay."""
    digests = []
    for load, replayer, frontend in (
            (p_tr.load_trace, p_tr.TraceReplayer,
             lambda: demo_frontend(seed=3, n_features=12, device="cpu")),
            (r_tr.load_trace, r_tr.TraceReplayer,
             lambda: r_demo_frontend(seed=3, n_features=12))):
        trace = load(FIXTURE)
        fe = frontend().start()
        try:
            rep = replayer(fe, pacing="sequential").replay(trace)
        finally:
            fe.close()
        assert rep.count("served") == len(trace)
        digests.append(rep.digest())
    assert len(digests[0]) == 64
    assert digests[0] == digests[1]
