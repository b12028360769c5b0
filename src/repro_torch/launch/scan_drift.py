"""How far the served prefill moves when its SSD scan is swapped.

    PYTHONPATH=src python -m repro_torch.launch.scan_drift        # zamba2-2.7b, card
    PYTHONPATH=src python -m repro_torch.launch.scan_drift --reduced --device cpu

One prefill of ``--batch`` prompts of ``--prompt-len`` tokens (random
weights and tokens from seed 0) runs with each scan below in place of
``kernels.mamba.ops.ssd_scan`` (its output replaced through
``kernels.watch``), in bf16 and in f32. For each, the script
prints how far its logits and caches end from the plain chunked path's
(``use_pallas=False``, chunks of 128), as shares of each tensor's largest
value:

  kernel          ``ops.ssd_scan`` as served (the CUDA kernel on the card)
  plain_chunk64   the plain version with chunks of 64: the same sums in
                  another order
  fault_no_carry  a broken scan: the state is not carried across chunks
  fault_shift     a broken scan: each token's log-decay applied one token
                  late

The first two are correct, so they show how far two orders of the same
math drift apart through the model; the faults show how far a broken scan
lands. ``chip_smoke.py`` holds the whole f32 prefill to a limit between
the two.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import replace

import torch
import torch.nn.functional as F

from ..kernels.mamba.ref import ssd_chunked
from ..kernels.watch import watching


def _no_carry(x, alog, B, C, *, chunk, h0=None):
    ys, h = [], h0
    for s in range(0, x.shape[1], chunk):
        part = slice(s, s + chunk)
        y, h = ssd_chunked(x[:, part], alog[:, part], B[:, part], C[:, part],
                           h0=h0, chunk=chunk)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _shift(x, alog, B, C, *, chunk, h0=None):
    late = F.pad(alog, (0, 0, 1, 0))[:, :-1]
    return ssd_chunked(x, late, B, C, h0=h0, chunk=chunk)


def _plain64(x, alog, B, C, *, chunk, h0=None):
    return ssd_chunked(x, alog, B, C, h0=h0, chunk=64)


SCANS = {"kernel": None, "plain_chunk64": _plain64,
         "fault_no_carry": _no_carry, "fault_shift": _shift}


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def apart(a, b) -> dict:
    """How far prefill result ``a`` (logits, caches) is from ``b``."""
    return {"logits": rel_err(a[0], b[0]),
            "ssm": rel_err(a[1]["ssm"], b[1]["ssm"]),
            "conv": rel_err(a[1]["conv"], b[1]["conv"]),
            "k": rel_err(a[1]["kv"][0], b[1]["kv"][0]),
            "v": rel_err(a[1]["kv"][1], b[1]["kv"][1])}


def prefill_with(model, params, batch, scan=None):
    """``model.prefill`` with every ``ops.ssd_scan`` call's output replaced
    by ``scan``'s on the same inputs (None: as served). ``model`` must be
    built with ``use_pallas=True``."""
    if scan is None:
        return model.prefill(params, batch)

    def swap(name, inputs, output):
        if name == "ssd_scan":
            return scan(**inputs)
        return None
    with watching(swap):
        return model.prefill(params, batch)


def drift(cfg, params, batch, dtypes=("bfloat16", "float32")) -> dict:
    """{dtype: {scan: apart(prefill with that scan, plain prefill)}}."""
    from ..models.registry import build_model
    out = {}
    for dtype in dtypes:
        c = replace(cfg, dtype=dtype)
        plain = build_model(replace(c, use_pallas=False)).prefill(params, batch)
        model = build_model(replace(c, use_pallas=True))
        out[dtype] = {name: apart(prefill_with(model, params, batch, scan),
                                  plain)
                      for name, scan in SCANS.items()}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..configs import get_config, reduced as make_reduced
    from ..configs.base import ShapeConfig
    from ..models.registry import build_model

    if args.device == "cuda":
        # float32 products in full float32 (no TF32), as chip_smoke.py runs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(cfg)
    params = model.init(0, args.device)
    batch = model.make_batch(ShapeConfig("serve", args.prompt_len, args.batch,
                                         "prefill"), seed=0,
                             device=args.device)
    print(json.dumps({"arch": args.arch, "reduced": args.reduced,
                      "batch": args.batch, "prompt": args.prompt_len,
                      "drift": drift(cfg, params, batch)}), flush=True)


if __name__ == "__main__":
    main()
