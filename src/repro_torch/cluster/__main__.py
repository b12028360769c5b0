"""``python -m repro_torch.cluster`` — serve a demo ``ClusterFrontend`` over TCP
(or ``--selftest``: spawn a server subprocess and answer one remote
request). See ``remote.main`` / docs/transport.md."""
from .remote import main

if __name__ == "__main__":
    raise SystemExit(main())
