"""The port's cluster tier (``repro_torch.cluster``) against the
reference's (``repro.cluster``): the same frames encode to the same bytes,
a client of either package talks to a server of the other in v3 and v2
(tenant auth included) with answers within 1e-6, the same writes persist
to the same bytes on disk, and the port's serving entry point,
``python -m repro_torch.cluster --device cpu``, passes its own transport
and observability smokes (one server subprocess each)."""
import math
import socket
import threading

import jax  # noqa: F401  (the reference's engine imports it)
import numpy as np
import pytest

from repro.cluster import persist as r_persist
from repro.cluster import remote as r_remote
from repro.cluster import transport as r_tp
from repro.core.dataset import Sample as RefSample
from repro_torch.cluster import persist as p_persist
from repro_torch.cluster import remote as p_remote
from repro_torch.cluster import transport as p_tp
from repro_torch.core.dataset import Sample

ARRAYS = [np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
          np.array([np.nan, np.inf, -np.inf, 5e-324, -0.0]),
          np.zeros((0, 6), dtype=np.float32)]
FRAMES = [{"op": "predict", "id": "c-1", "x": [[1.5, 2.0], [3.25, 1e-30]],
           "deadline_ms": 12.5, "priority": None},
          {"op": "hello", "max_v": 3, "tenant": "täst", "token": "s3cr3t"},
          {"ok": True, "y": [0.1, 2.0 / 3.0], "meta": {"trace": {
              "tid": "0123456789abcdef", "sid": "01234567"}}}]


def _wire(send, *args) -> bytes:
    a, b = socket.socketpair()
    with a, b:
        send(a, *args)
        a.shutdown(socket.SHUT_WR)
        chunks = []
        while chunk := b.recv(1 << 16):
            chunks.append(chunk)
    return b"".join(chunks)


@pytest.mark.parametrize("frame", FRAMES)
def test_v2_frames_encode_identically(frame):
    data = _wire(p_tp.send_frame, frame)
    assert data == _wire(r_tp.send_frame, frame)
    a, b = socket.socketpair()
    with a, b:
        a.sendall(data)
        assert r_tp.recv_frame(b) == p_tp.recv_frame(_replay(data)) == frame


@pytest.mark.parametrize("arr", ARRAYS, ids=["f32", "specials", "empty"])
def test_v3_frames_encode_identically(arr):
    meta, payload = p_tp.pack_array(arr)
    assert (meta, payload) == r_tp.pack_array(arr)
    meta = {"op": "predict", "id": "c-2", "array": meta}
    data = _wire(p_tp.send_frame_v3, meta, payload)
    assert data == _wire(r_tp.send_frame_v3, meta, payload)
    got_meta, got_payload = p_tp.recv_frame_v3(_replay(data))
    assert got_meta == meta and got_payload == payload
    back = r_tp.unpack_array(got_meta["array"], got_payload)
    np.testing.assert_array_equal(
        back, p_tp.unpack_array(got_meta["array"], got_payload))


def _replay(data: bytes) -> socket.socket:
    """A socket whose peer already sent ``data`` and closed."""
    a, b = socket.socketpair()
    a.sendall(data)
    a.close()
    return b


def test_errors_encode_identically():
    from repro.cluster.frontend import DeadlineExceeded as RefDeadline
    from repro_torch.cluster.frontend import DeadlineExceeded
    for p_exc, r_exc in ((p_tp.AuthError("no"), r_tp.AuthError("no")),
                         (DeadlineExceeded("late"), RefDeadline("late")),
                         (ValueError("bad x"), ValueError("bad x"))):
        enc = p_tp.encode_error(p_exc)
        assert enc == r_tp.encode_error(r_exc)
        assert type(r_tp.decode_error(enc)).__name__ == type(
            p_tp.decode_error(enc)).__name__


def _frontend(mod, **kw):
    if mod is p_remote:
        kw["device"] = "cpu"
    return mod.demo_frontend(seed=4, n_features=6, **kw)


@pytest.fixture(scope="module")
def servers():
    """One tenant-auth demo server per package. A server's close waits out
    its accept thread (5 s), so both close at once, after every case."""
    out = {mod: mod.PredictionServer(_frontend(mod), tenants={"alice": "k3y"},
                                     drain_s=0.2).start()
           for mod in (r_remote, p_remote)}
    yield out
    closers = [threading.Thread(target=srv.close) for srv in out.values()]
    for t in closers:
        t.start()
    for t in closers:
        t.join(timeout=30)
        assert not t.is_alive()


@pytest.mark.parametrize("protocol", [p_tp.PROTOCOL_V3, p_tp.PROTOCOL_VERSION],
                         ids=["v3", "v2"])
@pytest.mark.parametrize("server_mod,client_mod",
                         [(r_remote, p_remote), (p_remote, r_remote)],
                         ids=["port-client", "port-server"])
def test_cross_package_serving(servers, server_mod, client_mod, protocol):
    rng = np.random.default_rng(123)
    X = rng.lognormal(1.0, 1.5, size=(5, 6)).astype(np.float32)
    want = client_mod.demo_estimator(seed=4, n_features=6).predict(X)
    server = servers[server_mod]
    with client_mod.RemoteReplica(server.host, server.port, timeout_s=20,
                                  protocol=protocol, tenant="alice",
                                  token="k3y") as rep:
        got = rep.predict(X, deadline_s=10.0)
        single = rep.predict(X[2])
        assert rep.negotiated_version == protocol
    assert np.max(np.abs(got - want)) <= 1e-6
    assert abs(single[0] - want[2]) <= 1e-6
    with client_mod.RemoteReplica(server.host, server.port, timeout_s=20,
                                  protocol=protocol, tenant="alice",
                                  token="wrong") as bad:
        err = p_tp.AuthError if client_mod is p_remote else r_tp.AuthError
        with pytest.raises(err):
            bad.predict(X)


@pytest.fixture
def samples():
    rng = np.random.default_rng(9)

    def make(cls, start):
        return [cls(app="a", kernel=f"k{(start + i) % 5}", variant="s",
                    features=rng.lognormal(size=12).astype(np.float32),
                    targets={"tpu-v5e": {"time_us": float(10 + i)}})
                for i in range(3)]
    batches = [make(Sample, 3 * k) for k in range(7)]
    rng = np.random.default_rng(9)
    ref_batches = [make(RefSample, 3 * k) for k in range(7)]
    return batches, ref_batches


def test_persist_writes_the_same_bytes(tmp_path, samples):
    batches, ref_batches = samples
    for mod, path, todo in ((p_persist, tmp_path / "port", batches),
                            (r_persist, tmp_path / "ref", ref_batches)):
        with mod.PersistentDatasetStore(path, snapshot_every=3,
                                        keep_snapshots=2) as store:
            for b in todo:
                store.extend(b)
    files = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "ref").iterdir())
    for name in files:
        assert (tmp_path / "port" / name).read_bytes() == (
            tmp_path / "ref" / name).read_bytes(), name
    # each package recovers the other's directory to the same state
    with p_persist.PersistentDatasetStore(tmp_path / "ref") as back, \
            r_persist.PersistentDatasetStore(tmp_path / "port") as rback:
        assert back.version == rback.version == 7
        assert [s.to_json() for s in back.raw()[0]] == [
            s.to_json() for s in rback.raw()[0]]


def test_selftest_entry_point():
    """``python -m repro_torch.cluster --device cpu --selftest``: a server
    subprocess answered by a v3 and a v2 peer, held to the in-process twin
    within 1e-6."""
    assert p_remote.main(["--device", "cpu", "--selftest"]) == 0


def test_obs_smoke_entry_point(capsys):
    """``--obs-smoke``: the per-layer metric names on both exposition
    surfaces of a server subprocess, and the cross-process span tree."""
    assert p_remote.main(["--device", "cpu", "--obs-smoke"]) == 0
    out = capsys.readouterr().out
    assert "OBS_SMOKE_OK" in out
    assert set(p_remote.REQUIRED_METRICS) == set(r_remote.REQUIRED_METRICS)
    assert "engine.predictions" in p_remote.REQUIRED_METRICS
    assert not math.isnan(float(out.split("served=")[1].split()[0]))
