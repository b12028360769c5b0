"""Serving launcher: batched prefill + greedy decode with KV/state caches
(the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b \\
      --batch 4 --prompt-len 512 --gen 32

serves with ``use_pallas=True``, so on the card every prefill goes through
the hand-written SSD kernel. ``--device cpu --reduced`` runs a tiny variant
on the host (the kernel's plain version).
"""
from __future__ import annotations

import argparse
import time

import torch


def place_prefill_caches(model, caches: dict, max_len: int) -> dict:
    """Full-length caches holding a prefill's caches: fresh zero caches of
    ``max_len`` positions (``model.init_cache``) with the prompt's K/V
    copied into their first S positions, in place. The caches are picked
    by name: "kv" is the pair whose axis 2 is the sequence; "conv" and
    "ssm" carry no sequence axis and are copied whole."""
    k, v = caches["kv"]
    full = model.init_cache(k.shape[1], max_len, device=k.device)
    S = k.shape[2]
    for dst, src in zip(full["kv"], caches["kv"]):
        dst[:, :, :S].copy_(src)
    for name in ("conv", "ssm"):
        full[name].copy_(caches[name])
    return full


def generate(model, params, batch, gen_steps: int):
    """Greedy generation. Returns (tokens (B, gen_steps), per-token seconds).

    Prefill runs once over the prompt; its caches go into caches allocated
    at ``max_len = S + gen_steps``, with prefill's K/V written into them in
    place (``place_prefill_caches``), and every decode step then writes its
    K/V and states into them in place. A step's time is host clock around
    the decode call, synchronised with the card. A step whose logits are not
    all finite raises ``FloatingPointError``: no NaN becomes a token."""
    prompt = batch["tokens"]
    B, S = prompt.shape
    dev = prompt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    logits, caches = model.prefill(params, batch)
    caches = place_prefill_caches(model, caches, S + gen_steps)

    def pick(logits, step):
        if not bool(torch.isfinite(logits).all()):
            raise FloatingPointError(f"non-finite logits at step {step}")
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    toks, times = [], []
    cur = pick(logits, "prefill")
    for i in range(gen_steps):
        toks.append(cur)
        sync()
        t0 = time.perf_counter()
        logits, caches = model.decode(params, {"tokens": cur, "pos": S + i},
                                      caches)
        sync()
        times.append(time.perf_counter() - t0)
        cur = pick(logits, i)
    return torch.cat(toks, dim=1), times


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from dataclasses import replace

    import numpy as np

    from ..configs import get_config, reduced as make_reduced
    from ..configs.base import ShapeConfig
    from ..models.registry import build_model

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = make_reduced(cfg)
    model = build_model(replace(cfg, use_pallas=True))
    params = model.init(0, args.device)
    shape = ShapeConfig("serve", args.prompt_len, args.batch, "prefill")
    batch = model.make_batch(shape, device=args.device)
    toks, times = generate(model, params, batch, args.gen)
    med = float(np.median(times)) * 1e3
    print(f"generated {tuple(toks.shape)} tokens; median decode latency "
          f"{med:.2f} ms ({args.batch / np.median(times):.0f} tok/s)")


if __name__ == "__main__":
    main()
