"""The port's SSD scan package (``repro_torch.kernels.mamba``).

On the CPU ``ssd_scan`` takes its plain version ``ssd_chunked``; it and the
port's sequential ``ssd_ref`` are held to the reference's Pallas kernel
(interpret mode, as tests/test_kernels.py runs it) and to the reference's
``ssd_ref`` over the reference's shapes, at the reference's rtol/atol 2e-4.
The CUDA kernel itself runs only on a card: the one ``gpu`` test holds it to
its plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba import ssd_ref as r_ssd_ref
from repro.kernels.mamba import ssd_scan as r_ssd_scan
from repro_torch.kernels.mamba import ops, ssd_chunked, ssd_ref, ssd_scan
from repro_torch.kernels.mamba.kernel import ssd_scan_kernel
from repro_torch.kernels.mamba.ref import (ssd_chunk_states,
                                           ssd_state_passing, ssd_three_pass)

TOL = dict(rtol=2e-4, atol=2e-4)
SHAPES = [(2, 64, 3, 16, 8, 16),
          (1, 100, 2, 8, 4, 32),            # S not a multiple of chunk
          (2, 33, 1, 4, 8, 16),
          (1, 16, 2, 8, 4, 16)]             # single chunk


def _inputs(B, S, H, P, N, seed, decay=0.3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    alog = (-np.abs(rng.normal(size=(B, S, H))) * decay).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    return x, alog, Bm, Cm


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_ssd_vs_reference(B, S, H, P, N, chunk):
    arrays = _inputs(B, S, H, P, N, seed=B * 1000 + S * 10 + H)
    ry, rh = r_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk)
    oy, oh = r_ssd_ref(*map(jnp.asarray, arrays))
    for got_y, got_h in (ssd_scan(*_t(*arrays), chunk=chunk),
                         ssd_chunked(*_t(*arrays), chunk=chunk),
                         ssd_ref(*_t(*arrays))):
        assert got_y.dtype == torch.float32 and got_y.shape == (B, S, H, P)
        assert got_h.dtype == torch.float32 and got_h.shape == (B, H, N, P)
        _close(got_y, ry)
        _close(got_h, rh)
        _close(got_y, oy)
        _close(got_h, oh)


def test_ssd_state_streaming():
    """Final state from one call == ref's final state (cache handoff)."""
    x, alog, Bm, Cm = _inputs(1, 48, 2, 8, 4, seed=9, decay=0.2)
    _, rh = r_ssd_scan(*map(jnp.asarray, (x, alog, Bm, Cm)), chunk=16)
    _, oh = r_ssd_ref(*map(jnp.asarray, (x, alog, Bm, Cm)))
    _, h = ssd_scan(*_t(x, alog, Bm, Cm), chunk=16)
    _close(h, rh)
    _close(h, oh)
    # two halves, the second starting from the first's state, equal one call
    half = [a[:, :24] for a in (x, alog, Bm, Cm)]
    rest = [a[:, 24:] for a in (x, alog, Bm, Cm)]
    _, h1 = ssd_scan(*_t(*half), chunk=16)
    _, h2 = ssd_scan(*_t(*rest), chunk=16, h0=h1)
    _close(h2, oh)


@pytest.mark.parametrize("S,chunk", [(40, 16), (7, 8)])
def test_ssd_initial_state(S, chunk):
    x, alog, Bm, Cm = _inputs(2, S, 3, 8, 4, seed=S)
    h0 = np.random.default_rng(S + 1).normal(size=(2, 3, 4, 8)).astype(
        np.float32)
    ry, rh = r_ssd_ref(*map(jnp.asarray, (x, alog, Bm, Cm)),
                       h0=jnp.asarray(h0))
    for y, h in (ssd_scan(*_t(x, alog, Bm, Cm), chunk=chunk,
                          h0=torch.as_tensor(h0)),
                 ssd_chunked(*_t(x, alog, Bm, Cm), h0=torch.as_tensor(h0),
                             chunk=chunk),
                 ssd_ref(*_t(x, alog, Bm, Cm), h0=torch.as_tensor(h0))):
        _close(y, ry)
        _close(h, rh)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES)
def test_three_pass_vs_reference(B, S, H, P, N, chunk, pairs):
    """The bf16 kernel's three passes in plain torch, with and without its
    hi + lo operand pairs (2^-16 relative each, well inside 2^-4 of the
    reference's 2e-4 tolerance), against the reference's Pallas kernel
    (interpret mode) and its sequential ssd_ref: ragged S, one chunk."""
    arrays = _inputs(B, S, H, P, N, seed=B * 1000 + S * 10 + H)
    ry, rh = r_ssd_scan(*map(jnp.asarray, arrays), chunk=chunk)
    oy, oh = r_ssd_ref(*map(jnp.asarray, arrays))
    y, h = ssd_three_pass(*_t(*arrays), chunk=chunk, pairs=pairs)
    assert y.dtype == torch.float32 and y.shape == (B, S, H, P)
    assert h.dtype == torch.float32 and h.shape == (B, H, N, P)
    for got, want in ((y, ry), (h, rh), (y, oy), (h, oh)):
        _close(got, want)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("S,chunk", [(40, 16), (7, 8), (16, 16)])
def test_three_pass_initial_state(S, chunk, pairs):
    x, alog, Bm, Cm = _inputs(2, S, 3, 8, 4, seed=S)
    h0 = np.random.default_rng(S + 1).normal(size=(2, 3, 4, 8)).astype(
        np.float32)
    ry, rh = r_ssd_ref(*map(jnp.asarray, (x, alog, Bm, Cm)),
                       h0=jnp.asarray(h0))
    y, h = ssd_three_pass(*_t(x, alog, Bm, Cm), h0=torch.as_tensor(h0),
                          chunk=chunk, pairs=pairs)
    _close(y, ry)
    _close(h, rh)


def test_three_pass_pieces():
    """Pass 1's states and cs, pass 2's h_in: h_in[0] is h0, each next
    h_in is the last decayed and plus the chunk's state, the last of the
    walk is the final state; padded steps add 0 to cs."""
    x, alog, Bm, _ = _t(*_inputs(2, 40, 3, 8, 4, seed=5))
    h0 = torch.randn(2, 3, 4, 8, generator=torch.Generator().manual_seed(0))
    states, cs = ssd_chunk_states(x, alog, Bm, chunk=16)
    assert states.shape == (2, 3, 3, 4, 8) and cs.shape == (2, 3, 16, 3)
    assert torch.equal(cs[:, 2, 8:], cs[:, 2, 7:8].expand(-1, 8, -1))
    h_in, h = ssd_state_passing(states, cs, h0)
    assert torch.equal(h_in[:, 0], h0)
    for c in (1, 2):
        want = torch.exp(cs[:, c - 1, -1])[..., None, None] * h_in[:, c - 1] \
            + states[:, c - 1]
        torch.testing.assert_close(h_in[:, c], want, rtol=0, atol=0)
    _, rh = r_ssd_ref(*map(jnp.asarray, _inputs(2, 40, 3, 8, 4, seed=5)),
                      h0=jnp.asarray(h0.numpy()))
    _close(h, rh)


def test_ssd_bf16_inputs_keep_dtype():
    x, alog, Bm, Cm = _inputs(1, 20, 2, 8, 4, seed=4)
    xb, Bb, Cb = (torch.as_tensor(a).to(torch.bfloat16) for a in (x, Bm, Cm))
    y, h = ssd_scan(xb, torch.as_tensor(alog), Bb, Cb)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    yr, hr = ssd_ref(xb, torch.as_tensor(alog), Bb, Cb)
    torch.testing.assert_close(h, hr, **TOL)
    # y is rounded to bf16 once in each: one bf16 ulp (2^-7 relative) apart
    torch.testing.assert_close(y.float(), yr.float(), rtol=2 ** -7, atol=1e-3)


def test_cpu_path_launches_nothing():
    before = ops.launches
    ssd_scan(*_t(*_inputs(1, 10, 2, 4, 4, seed=1)))
    assert ops.launches == before


def test_other_devices_raise():
    meta = [t.to("meta") for t in _t(*_inputs(1, 10, 2, 4, 4, seed=2))]
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        ssd_scan(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_kernel(*_t(*_inputs(1, 10, 2, 4, 4, seed=3)), chunk=16)
    with pytest.raises(ValueError, match="at least one step"):
        ssd_scan(*_t(*_inputs(1, 0, 2, 4, 4, seed=3)))


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    H, P, N = 80, 64, 64
    for dtype, tol in ((torch.float32, TOL),
                       (torch.bfloat16, dict(rtol=2 ** -7, atol=1e-3))):
        for B, S in ((1, 1), (1, 100), (2, 300)):
            x, alog, Bm, Cm = (torch.as_tensor(a, device="cuda")
                               for a in _inputs(B, S, H, P, N, seed=S))
            # B, C scaled so that C.B stays O(1) at N = 64
            x, Bm, Cm = (x.to(dtype), (Bm * N ** -0.25).to(dtype),
                         (Cm * N ** -0.25).to(dtype))
            before = ops.launches
            y, h = ssd_scan(x, alog, Bm, Cm)
            y2, h2 = ssd_scan(x, alog, Bm, Cm)
            yp, hp = ssd_chunked(x, alog, Bm, Cm, chunk=min(128, -(-S // 8) * 8))
            torch.cuda.synchronize()
            assert ops.launches == before + 2
            torch.testing.assert_close(y.float(), yp.float(), **tol)
            torch.testing.assert_close(h, hp, **TOL)
            assert torch.equal(y, y2) and torch.equal(h, h2)
