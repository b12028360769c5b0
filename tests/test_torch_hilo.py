"""The f32 -> bf16 hi + lo split (``repro_torch.kernels.hilo``) that the
port's bf16 kernels use for each f32 operand of their tensor-core products:
hi + lo holds the f32 value to 2^-16 of its size (2^-18 for normal values,
as both roundings are to nearest), where one bf16 value holds it to 2^-9."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hilo import split_bf16, through_pair


def _values(seed):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-30, 30, 20000)
    return torch.as_tensor((rng.choice([-1.0, 1.0], mag.size) * mag)
                           .astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pair_within_2_to_minus_16(seed):
    v = _values(seed)
    hi, lo = split_bf16(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (v.double() - hi.double() - lo.double()).abs()
    assert bool((err <= 2.0 ** -16 * v.double().abs()).all())
    # one bf16 value alone is 2^-9 off at worst, and that far here
    one = (v.double() - hi.double()).abs() / v.double().abs()
    assert float(one.max()) > 2.0 ** -10


def test_bf16_values_split_exactly():
    v = torch.randn(1000).to(torch.bfloat16).float()
    hi, lo = split_bf16(v)
    assert torch.equal(hi.float(), v) and not bool(lo.float().any())
    assert torch.equal(through_pair(v), v)
    assert torch.equal(through_pair(torch.zeros(3)), torch.zeros(3))
