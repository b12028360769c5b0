"""The xLSTM's two recurrences as scans with their own backward
(``repro_torch.models.xlstm``: ``_SLSTMScan`` over time, ``_MLSTMScan``
over chunks in segments), and the cost counter's count of a ``scan``
(``core/hlo_analysis.py``).

Each Function passes float64 ``gradcheck`` from a carried state and from
zeros; in float32 its outputs, final state and every gradient (of the
inputs, the recurrent weights and the initial state) equal the reference's
``lax.scan`` and ``jax.grad`` on the same numpy inputs, at
``tests/test_torch_xlstm.py``'s tolerance (rtol 1e-4 plus an atol of 1e-4
of each tensor's largest magnitude, ``_lm_parity.close``). A counted scan
equals the same loop unrolled in FLOPs, transcendentals and bytes, on meta
and on real tensors, and its peak is the one stated."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.models.xlstm as r_xlstm
from _lm_parity import close, close_trees
from repro_torch.core.hlo_analysis import count_program
from repro_torch.models import xlstm

# (B, S, H, Dh); the mLSTM's chunk of 4 splits 37 positions into 10 chunks,
# two segments of 5 (_segment), the last chunk ragged
B, S, H, DH, CHUNK = 2, 37, 3, 4, 4


def _slstm_inputs(rng, carried: bool, dtype=np.float32):
    gates = rng.normal(size=(B, S, 4, H, DH))
    r = rng.normal(size=(H, DH, 4, DH)) * 0.3
    b = rng.normal(size=(4, H, DH)) * 0.3
    if carried:
        st = [rng.normal(size=(B, H, DH)) * 0.3 for _ in range(4)]
        st[1] = np.abs(st[1]) + 0.5
    else:
        st = [np.zeros((B, H, DH)) for _ in range(4)]
    return [a.astype(dtype) for a in (gates, r, b, *st)]


def _mlstm_inputs(rng, carried: bool, dtype=np.float32):
    q, k, v = (rng.normal(size=(B, S, H, DH)) for _ in range(3))
    logi = rng.normal(size=(B, S, H))
    logf = np.log(1 / (1 + np.exp(-(rng.normal(size=(B, S, H)) + 2))))
    if carried:
        st = (rng.normal(size=(B, H, DH, DH)) * 0.1,
              np.abs(rng.normal(size=(B, H, DH))), rng.normal(size=(B, H)))
    else:
        st = (np.zeros((B, H, DH, DH)), np.zeros((B, H, DH)),
              np.zeros((B, H)))
    return [a.astype(dtype) for a in (q, k, v, logi, logf, *st)]


def _port_slstm(gates, r, b, *state):
    y, state = xlstm._slstm_steps(False, gates, r, b, state)
    return (y, *state)


def _port_mlstm(q, k, v, logi, logf, *state):
    y, state = xlstm.mlstm_chunk_scan(q, k, v, logi, logf, state, CHUNK)
    return (y, *state)


def _ref_slstm(gates, r, b, *state):
    def step(carry, g_t):
        carry = r_xlstm._slstm_cell({"r": r, "b": b}, g_t, carry)
        return carry, carry[2]
    state, hs = jax.lax.scan(step, tuple(state), jnp.moveaxis(gates, 1, 0))
    return (jnp.moveaxis(hs, 0, 1).reshape(B, S, H * DH), *state)


def _ref_mlstm(q, k, v, logi, logf, *state):
    y, state = r_xlstm._mlstm_chunk_scan(q, k, v, logi, logf, tuple(state),
                                         CHUNK)
    return (y, *state)


CASES = {"slstm": (_slstm_inputs, _port_slstm, _ref_slstm),
         "mlstm": (_mlstm_inputs, _port_mlstm, _ref_mlstm)}


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "zeros"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_gradcheck_in_float64(name, carried, monkeypatch):
    """At a smaller size (B 1, S 11, H 2, Dh 2, chunks of 2: six chunks in
    three segments of two, the last chunk ragged)."""
    for k, v in dict(B=1, S=11, H=2, DH=2, CHUNK=2).items():
        monkeypatch.setitem(globals(), k, v)
    inputs, port, _ = CASES[name]
    args = [torch.tensor(a, requires_grad=True)
            for a in inputs(np.random.default_rng(0), carried, np.float64)]
    assert torch.autograd.gradcheck(port, args)


@pytest.mark.parametrize("carried", [True, False], ids=["carried", "zeros"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_outputs_and_gradients_match_the_reference(name, carried):
    """A loss that weighs every output (y and the final state) with fixed
    random weights; its value, the outputs and the gradients of every
    input against the reference's ``jax.grad``."""
    inputs, port, ref = CASES[name]
    rng = np.random.default_rng(1)
    args = inputs(rng, carried)
    want_out = ref(*map(jnp.asarray, args))
    weights = [rng.normal(size=np.shape(o)).astype(np.float32)
               for o in want_out]

    def r_loss(*a):
        return sum(jnp.sum(o * w) for o, w in zip(ref(*a), weights))

    want_grads = jax.grad(r_loss, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    t_args = [torch.tensor(a, requires_grad=True) for a in args]
    out = port(*t_args)
    loss = sum((o * torch.as_tensor(w)).sum() for o, w in zip(out, weights))
    grads = torch.autograd.grad(loss, t_args)
    close_trees(out, want_out, "outputs")
    close(loss, r_loss(*map(jnp.asarray, args)), what="loss")
    if not carried:
        # From zeros the initial stabilizer m moves no output (the sLSTM's
        # c and n scale alike, as do the mLSTM's num and norm): its exact
        # gradient is 0, and both sides return the float32 rounding of
        # terms that cancel, as large as those of the input gate's
        # gradient (the gates', logi's; test_torch_xlstm.py's b_i)
        gate = np.asarray(want_grads[0 if name == "slstm" else 3])
        np.testing.assert_allclose(
            grads[-1].numpy(), np.asarray(want_grads[-1]), rtol=1e-4,
            atol=1e-4 * float(np.abs(gate).max()))
        grads, want_grads = grads[:-1], want_grads[:-1]
    close_trees(grads, want_grads, "gradients")


def test_decode_step_calls_the_cell_once():
    """A one-token decode step is the cell itself, outside any scan."""
    rng = np.random.default_rng(2)
    gates, r, b, *st = map(torch.as_tensor, _slstm_inputs(rng, True))
    y, state = xlstm._slstm_steps(True, gates[:, :1], r, b, st)
    want = xlstm._slstm_cell(r, b, gates[:, 0], tuple(st))
    torch.testing.assert_close(y, want[2].flatten(1)[:, None], rtol=0,
                               atol=0)
    for a, w in zip(state, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)


# ------------------------------------------------------- the counted scan

T, N, W = 16, 8, 32        # trips, rows, width (float32)


def _body(c, x, w):
    c2 = torch.tanh(x + c @ w)
    return (c2, c2 * 2.0)


def _scanned(x, c0, w):
    (c,), (ys,) = xlstm._scan(_body, (c0,), (x,), (w,))
    return c, ys


def _unrolled(x, c0, w):
    c, ys = c0, []
    for t in range(x.shape[0]):
        c, y = _body(c, x[t], w)
        ys.append(y)
    return c, torch.stack(ys)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_counted_scan_equals_the_loop_unrolled(device):
    """FLOPs (the matmul and the pointwise ops), transcendentals and bytes
    equal the unrolled loop's; the library's FLOPs too. The peak, stated:
    the inputs, the stacked outputs' buffer (written a slice a trip), the
    carry of the trip before and the body's two live temporaries; the
    unrolled loop holds its list of outputs and their stack at once
    instead."""
    x = torch.randn(T, N, W, device=device)
    c0 = torch.zeros(N, W, device=device)
    w = torch.randn(W, W, device=device)
    scan = count_program(_scanned, x, c0, w)
    loop = count_program(_unrolled, x, c0, w)
    row = N * W * 4
    assert scan.costs.flops == loop.costs.flops == T * (2 * N * W * W
                                                        + 3 * N * W)
    assert scan.library_flops == loop.library_flops == T * 2 * N * W * W
    assert scan.costs.transcendentals == loop.costs.transcendentals \
        == T * N * W
    assert scan.costs.hbm_bytes == loop.costs.hbm_bytes
    assert scan.costs.while_trips == [float(T)]
    inputs = T * row + row + W * W * 4
    assert scan.peak_bytes == inputs + T * row + row + 2 * row
    assert loop.peak_bytes == inputs + 2 * T * row + row
    if device == "cpu":
        for a, b in zip(scan.output, loop.output):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_counted_xlstm_scans_equal_on_meta_and_real_tensors():
    """Both Functions' forward and backward counted on real tensors (every
    trip runs) and on meta ones (two trips run, the rest counted as the
    second): the same counts and peak; the library's FLOPs those of
    ``FlopCounterMode`` alone over the same step. The mLSTM takes chunks
    of 2 over 35 positions: 18 chunks in three segments of 6, so that the
    real run's uncounted trips reach a scan nested in the body."""
    def step(gates, r, b, q, k, v, logi, logf):
        y, _ = xlstm._slstm_steps(False, gates, r, b,
                                  [gates.new_zeros(B, H, DH)] * 4)
        z, _ = xlstm.mlstm_chunk_scan(
            q, k, v, logi, logf, (q.new_zeros(B, H, DH, DH),
                                  q.new_zeros(B, H, DH), q.new_zeros(B, H)),
            2)
        return torch.autograd.grad(y.sum() + z.sum(), (gates, r, q, logf))

    rng = np.random.default_rng(3)
    sl = _slstm_inputs(rng, False)[:3]
    ml = [a[:, :35] for a in _mlstm_inputs(rng, False)[:5]]
    runs = []
    for device in ("cpu", "meta"):
        args = [torch.tensor(a, device=device, requires_grad=True)
                for a in sl + ml]
        runs.append(count_program(step, *args))
    real, meta = runs
    assert real.costs.as_dict() == meta.costs.as_dict()
    assert real.peak_bytes == meta.peak_bytes
    assert real.library_flops == meta.library_flops
    assert len(real.costs.while_trips) > 4
    with FlopCounterMode(display=False) as library:
        step(*[torch.tensor(a, requires_grad=True) for a in sl + ml])
    assert library.get_total_flops() == real.library_flops
