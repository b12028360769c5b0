#!/usr/bin/env python3
"""Kernel B2 (``csrc/flash_attn.cu``) on one CUDA card for one checkout of
the PyTorch/CUDA port: that checkout's ``chip_smoke.flash_timing`` at
zamba2-2.7b's and smollm-360m's training shapes (bf16, causal, the model's
(B, S, H, D) layout, no log-sum-exp asked), and ptxas's lines for each
kernel entry of its build.

    python3 tools/flash_ab.py [--root DIR]

Imports ``chip_smoke`` and ``repro_torch`` from the checkout at DIR
(default: this one), builds its flash-attention source and prints one JSON
line: events ms, device ms, the bound and SDPA's ms at each shape. Two
commits compare on one card, in turns:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python3 tools/flash_ab.py --root $r; done

Without a CUDA device it exits 2 before printing any result.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(
        description="Kernel B2 on one CUDA card, one checkout.")
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_ab: torch sees no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import chip_smoke as cs
    from repro_torch.kernels.attention import kernel as ak

    info = ak.build()
    dev = torch.device("cuda")
    out = {"root": str(root), "card": cs.nvidia_smi()}
    for name, shape in (("zamba2-2.7b", cs.FLASH_TRAIN[:6]),
                        ("smollm-360m",
                         cs.FLASH_MODEL_CASES["smollm-360m"])):
        t = cs.flash_timing(dev, shape)
        out[name] = {k: t[k] for k in ("ms", "device_ms", "bound_ms",
                                       "library_ms")}
    out["ptxas"] = [ln.strip() for ln in info.log.splitlines()
                    if any(k in ln for k in ("Compiling entry", "registers",
                                             "spill"))]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
