"""The port's flash-attention package (``repro_torch.kernels.attention``).

On the CPU ``flash_attention`` takes its plain version ``attention_ref``;
both are held to the reference's Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and to the reference's jnp ``attention_ref``
over the reference's five shapes, at the reference's f32 tolerance (rtol
2e-4, atol 2e-5) and its bf16 tolerance (0.08). Rows that see no key are 0
in the Pallas kernel and in the port; the reference's jnp ref gives NaN
there, so it is held only where it is finite. The CUDA kernel itself runs
only on a card: the ``gpu`` test holds it to its plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention_ref as r_attention_ref
from repro.kernels.attention import flash_attention as r_flash_attention
from repro.kernels.attention.kernel import flash_attention_kernel as r_kernel
from repro_torch.kernels import watch
from repro_torch.kernels.attention import attention_ref, flash_attention, ops
from repro_torch.kernels.attention.kernel import flash_attention_kernel
from repro_torch.kernels.attention.ref import attention_online

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=0.08, atol=0.08)
SHAPES = [(2, 4, 2, 64, 64, 32, True),
          (1, 2, 2, 33, 33, 16, True),
          (2, 8, 2, 17, 40, 8, False),
          (1, 4, 1, 128, 128, 64, True),
          (1, 2, 1, 16, 48, 8, True)]        # chunked prefill against a cache


def _inputs(B, Hq, Hkv, Sq, Skv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def _t(*arrays, dtype=torch.float32):
    return [torch.as_tensor(a).to(dtype) for a in arrays]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", SHAPES)
def test_flash_vs_reference(B, Hq, Hkv, Sq, Skv, D, causal):
    arrays = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=B * 100 + Hq * 10 + Sq)
    pallas = r_flash_attention(*map(jnp.asarray, arrays), causal=causal,
                               block_q=32, block_k=32)
    plain = r_attention_ref(*map(jnp.asarray, arrays), causal=causal)
    for got in (flash_attention(*_t(*arrays), causal=causal),
                attention_ref(*_t(*arrays), causal=causal)):
        assert got.dtype == torch.float32 and got.shape == (B, Hq, Sq, D)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)
        np.testing.assert_allclose(got.numpy(), np.asarray(plain), **F32)


def test_flash_bf16():
    arrays = _inputs(1, 2, 2, 32, 32, 16, seed=0)
    pallas = r_flash_attention(*(jnp.asarray(a, jnp.bfloat16) for a in arrays),
                               causal=True, block_q=16, block_k=16)
    got = flash_attention(*_t(*arrays, dtype=torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, dtype=np.float32), **BF16)


def test_rows_that_see_no_key_are_zero():
    """Sq > Skv with the end-aligned causal mask: the first Sq - Skv rows
    see no key. The Pallas kernel and the port give 0 there; the reference's
    jnp ref gives NaN, and is held only on the other rows."""
    arrays = _inputs(1, 2, 1, 48, 16, 8, seed=7)
    pallas = np.asarray(r_flash_attention(*map(jnp.asarray, arrays),
                                          causal=True, block_q=32,
                                          block_k=32))
    plain = np.asarray(r_attention_ref(*map(jnp.asarray, arrays), causal=True))
    got = flash_attention(*_t(*arrays), causal=True).numpy()
    assert np.isnan(plain[:, :, :32]).all() and (pallas[:, :, :32] == 0).all()
    assert (got[:, :, :32] == 0).all()
    np.testing.assert_allclose(got, pallas, **F32)
    np.testing.assert_allclose(got[:, :, 32:], plain[:, :, 32:], **F32)


@pytest.mark.parametrize("kv_len,kv_offset", [(50, 18), (64, -8), (20, 40)])
def test_kv_len_and_offset_vs_pallas(kv_len, kv_offset):
    """The masks the kernel takes: keys past kv_len, the causal offset."""
    arrays = _inputs(2, 4, 2, 32, 64, 16, seed=kv_len)
    want = r_kernel(*map(jnp.asarray, arrays), causal=True, sm_scale=0.25,
                    block_q=16, block_k=16, kv_len=kv_len,
                    kv_offset=kv_offset)
    got = attention_ref(*_t(*arrays), causal=True, sm_scale=0.25,
                        kv_len=kv_len, kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_are_the_plain_versions(causal):
    """The autograd.Function's backward recomputes the plain version: its
    gradients equal autograd through ``attention_ref``, masked rows
    included, with no NaN."""
    q, k, v = (t.requires_grad_() for t in _t(*_inputs(2, 4, 2, 40, 24, 16,
                                                       seed=3)))
    g = torch.as_tensor(np.random.default_rng(4).normal(
        size=q.shape).astype(np.float32))
    got = torch.autograd.grad(flash_attention(q, k, v, causal=causal),
                              (q, k, v), g)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=causal),
                               (q, k, v), g)
    for a, b in zip(got, want):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    # only the inputs that ask for a gradient get one
    (dk,) = torch.autograd.grad(flash_attention(q.detach(), k, v.detach(),
                                                causal=causal), (k,), g)
    torch.testing.assert_close(dk, want[1], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", SHAPES)
def test_online_emulation_vs_reference(B, Hq, Hkv, Sq, Skv, D, causal):
    """The bf16 kernel's arithmetic (64-key tiles, log2-domain online
    softmax, P as a bf16 hi + lo pair: 2^-16 relative) on f32 inputs, held
    to the reference's Pallas kernel at the reference's f32 tolerance."""
    arrays = _inputs(B, Hq, Hkv, Sq, Skv, D, seed=B * 100 + Hq * 10 + Sq)
    pallas = r_flash_attention(*map(jnp.asarray, arrays), causal=causal,
                               block_q=32, block_k=32)
    got = attention_online(*_t(*arrays), causal=causal, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **F32)


@pytest.mark.parametrize("kv_len,kv_offset", [(50, 18), (64, -8), (0, 0)])
def test_online_emulation_masks(kv_len, kv_offset):
    arrays = _t(*_inputs(2, 4, 2, 32, 64, 16, seed=kv_len))
    got = attention_online(*arrays, causal=True, sm_scale=0.25,
                           kv_len=kv_len, kv_offset=kv_offset, block_k=16)
    want = attention_ref(*arrays, causal=True, sm_scale=0.25, kv_len=kv_len,
                         kv_offset=kv_offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
    assert torch.isfinite(got).all()


def test_p_rounding_points_at_the_training_limit():
    """Where the bf16 kernel rounds P, at zamba2's head dim (80) in its
    layout and bf16: with P as a hi + lo pair the output before its bf16
    rounding stays within 2^-14 of the largest value of the plain f32
    version's, and the bf16 output within the in-place limit of the
    training step (2^-7 of the largest value, one bf16 ulp). One bf16 P
    alone adds an error of 2^-9 per weight before the output's rounding:
    that is what the pair removes, and it shows here above 2^-12."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 300, 4, 80)).astype(
        np.float32)).to(torch.bfloat16).transpose(1, 2) for _ in range(3))
    plain = attention_ref(q.float(), k.float(), v.float())
    top = float(plain.abs().max())

    def apart(got, want):
        return float((got.float() - want.float()).abs().max()) / top
    pair = attention_online(q.float(), k.float(), v.float())
    single = attention_online(q.float(), k.float(), v.float(), p_pairs=False)
    assert apart(pair, plain) <= 2.0 ** -14
    assert apart(single, plain) > 2.0 ** -12
    assert apart(attention_online(q, k, v), attention_ref(q, k, v)) \
        <= 2.0 ** -7


def test_watchers_see_and_may_replace_each_call():
    arrays = _t(*_inputs(1, 2, 1, 8, 8, 4, seed=5))
    seen = []

    def spy(name, inputs, output):
        seen.append((name, inputs["causal"], tuple(output.shape)))

    with watch.watching(spy):
        flash_attention(*arrays, causal=False)
        with watch.watching(lambda *_: torch.zeros(1)):
            assert torch.equal(flash_attention(*arrays), torch.zeros(1))
    flash_attention(*arrays)
    assert seen == [("flash_attention", False, (1, 2, 8, 4)),
                    ("flash_attention", True, (1, 2, 8, 4))]


def test_cpu_path_launches_nothing():
    before = ops.launches
    flash_attention(*_t(*_inputs(1, 2, 1, 8, 8, 4, seed=1)))
    assert ops.launches == before


def test_bad_inputs_raise():
    arrays = _t(*_inputs(1, 2, 1, 8, 8, 4, seed=2))
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        flash_attention(*(a.to("meta") for a in arrays))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel(*arrays, causal=True)
    with pytest.raises(ValueError, match="S >= 1"):
        flash_attention(arrays[0][:, :, :0], *arrays[1:])


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
        for B, Hq, Hkv, Sq, Skv, D, causal in SHAPES + [
                (1, 4, 4, 200, 200, 80, True), (1, 2, 1, 48, 16, 8, True)]:
            q, k, v = (torch.as_tensor(a, device="cuda").to(dtype) for a in
                       _inputs(B, Hq, Hkv, Sq, Skv, D, seed=Sq))
            before = ops.launches
            o = flash_attention(q, k, v, causal=causal)
            o2 = flash_attention(q, k, v, causal=causal)
            want = attention_ref(q, k, v, causal=causal)
            torch.cuda.synchronize()
            assert ops.launches == before + 2
            torch.testing.assert_close(o.float(), want.float(), **tol)
            assert torch.equal(o, o2)
