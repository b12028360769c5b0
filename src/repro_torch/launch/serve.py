"""Serving launcher: batched prefill + greedy decode with KV/state caches
(the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --batch 4 --prompt-len 512 --gen 32

serves with ``use_pallas=True``: on the card every prefill of a family with
Mamba2 layers (zamba2) goes through the hand-written SSD kernel; the other
families' serving attention is plain torch, as the reference's is jnp.
``--device cpu --reduced`` runs a tiny variant on the host.
"""
from __future__ import annotations

import argparse
import time

import torch


def _padded(pair, max_len: int) -> tuple:
    """A (k, v) pair of prefill caches (axis 2 the sequence) in fresh zero
    caches of ``max_len`` positions."""
    out = []
    for a in pair:
        full = a.new_zeros(a.shape[:2] + (max_len,) + a.shape[3:])
        full[:, :, :a.shape[2]].copy_(a)
        out.append(full)
    return tuple(out)


def place_prefill_caches(model, caches, max_len: int):
    """The caches decode runs on, from a prefill's caches: each family's
    caches picked by name (the reference's ``generate`` pads every array
    whose axis 2 equals the prompt length instead). The K/V of the prompt
    go into fresh zero caches of ``max_len`` positions: the (k, v) pair of
    dense, moe and vlm, zamba2's "kv", encdec's "self". The rest carry no
    sequence axis to grow and are kept whole: zamba2's "conv" and "ssm",
    xlstm's states, and encdec's "cross" (the encoder's K/V, as long as its
    frames: decode attends to exactly those keys)."""
    fam = model.cfg.family
    if fam in ("dense", "moe", "vlm"):
        return _padded(caches, max_len)
    if fam == "mamba_hybrid":
        return {"conv": caches["conv"], "ssm": caches["ssm"],
                "kv": _padded(caches["kv"], max_len)}
    if fam == "encdec":
        return {"cross": caches["cross"],
                "self": _padded(caches["self"], max_len)}
    if fam == "xlstm":
        return caches
    raise ValueError(f"unknown family {fam!r}")


def generate(model, params, batch, gen_steps: int):
    """Greedy generation. Returns (tokens (B, gen_steps), per-token seconds).

    Prefill runs once over the prompt (for the VLM its s_img patches, then
    its S text tokens); ``place_prefill_caches`` puts its caches into
    caches of ``max_len = s_img + S + gen_steps`` positions, and decode step
    i writes at cache position s_img + S + i, in place. The VLM's decode
    batch carries the prompt batch's ``mrope_delta`` (0 when it has none),
    as the reference's ``generate`` passes it. A step's time is host clock
    around the decode call, synchronised with the card. A step whose logits
    are not all finite raises ``FloatingPointError``: no NaN becomes a
    token."""
    prompt = batch["tokens"]
    B, S = prompt.shape
    dev = prompt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    vlm = model.cfg.family == "vlm"
    start = S + (batch["patch_embeds"].shape[1]
                 if vlm and "patch_embeds" in batch else 0)
    logits, caches = model.prefill(params, batch)
    caches = place_prefill_caches(model, caches, start + gen_steps)

    def pick(logits, step):
        if not bool(torch.isfinite(logits).all()):
            raise FloatingPointError(f"non-finite logits at step {step}")
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    toks, times = [], []
    cur = pick(logits, "prefill")
    for i in range(gen_steps):
        toks.append(cur)
        step = {"tokens": cur, "pos": start + i}
        if vlm:
            step["mrope_delta"] = batch.get("mrope_delta", 0)
        sync()
        t0 = time.perf_counter()
        logits, caches = model.decode(params, step, caches)
        sync()
        times.append(time.perf_counter() - t0)
        cur = pick(logits, i)
    return torch.cat(toks, dim=1), times


def main(argv=None):
    """Serve as the flags say; returns ``generate``'s (tokens, times)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
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
    return toks, times


if __name__ == "__main__":
    main()
