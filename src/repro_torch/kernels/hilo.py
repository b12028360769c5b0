"""A float32 value as a pair of bfloat16 values, hi + lo.

The tensor cores multiply bf16 operands and add in f32. The port's bf16
kernels (``csrc/flash_attn.cu``, ``csrc/ssd.cu``) feed each f32 intermediate
operand (attention's P, the SSD's w x, h_in and decayed C B^T) as two
operands, hi = rn_bf16(v) and lo = rn_bf16(v - hi), and take two products,
so the operand keeps about 16 significant bits instead of 8:
|v - (hi + lo)| <= 2^-9 |v - hi| <= 2^-18 |v| (round to nearest, v normal).
``csrc/tensor_core.cuh::split_bf16`` is the kernels' form of ``split_bf16``;
the plain versions' emulations of the kernels' arithmetic use this one.
"""
from __future__ import annotations

import torch


def split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 tensors with hi + lo equal to the f32 ``v`` to within
    2^-16 of |v| (2^-18 for normal values)."""
    v = v.float()
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def through_pair(v: torch.Tensor) -> torch.Tensor:
    """``v`` as the kernels' tensor cores see it: hi + lo, in f32."""
    hi, lo = split_bf16(v)
    return hi.float() + lo.float()
