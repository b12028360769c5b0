"""Plain-torch versions of the chunked SSD scan (Mamba2).

    h_t = exp(alog_t) * h_{t-1} + B_t x_t^T        (per head; h in R^{N x P})
    y_t = C_t^T h_t

x: (B, S, H, P) inputs, alog: (B, S, H) log-decays (= dt * A, A < 0),
B/C: (B, S, N) shared across heads (single state group).

``ssd_ref`` is the sequential recurrence, the semantic ground truth (the
reference's ``kernels/mamba/ref.py``). ``ssd_chunked`` is the chunked form
the kernel computes (the reference's ``models/mamba2.py::_ssd_chunked_jnp``):
chunk-local products plus a carry of h across chunks. It is the path a CPU
tensor takes in ``ops.ssd_scan`` and the plain version the kernel is held
to on the card. Both return y in x's dtype and h (B, H, N, P) in float32.

``ssd_three_pass`` is the same function in the three passes the bf16 kernel
runs (the SSD algorithm, Dao & Gu 2024, arXiv:2405.21060, §6):
``ssd_chunk_states`` (per chunk: the cumulative log-decay and the chunk's
state contribution), ``ssd_state_passing`` (the walk over the chunks from
h0) and ``ssd_chunk_output`` (the chunk-local product plus the carried
state's). With ``pairs=True`` each f32 operand the kernel feeds its tensor
cores as a bf16 hi + lo pair (w x, h_in, the decayed C B^T) goes through
that pair here too. The tests hold it to the reference; no path of the
port runs it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..hilo import through_pair


def ssd_ref(x, alog, B, C, h0=None):
    """Returns (y, h_final): y (B, S, H, P); h (B, H, N, P)."""
    Bsz, S, H, P = x.shape
    N = B.shape[-1]
    xf, af, Bf, Cf = x.float(), alog.float(), B.float(), C.float()
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(S):
        h = torch.exp(af[:, t])[:, :, None, None] * h + torch.einsum(
            "bn,bhp->bhnp", Bf[:, t], xf[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((Bsz, 0, H, P))
    return y.to(x.dtype), h


def ssd_chunked(x, alog, B, C, h0=None, chunk: int = 128):
    """Chunked SSD, same math as the kernel. S is padded up to a multiple
    of ``chunk`` with zero inputs and zero log-decay, which is exact.
    Returns (y (B, S, H, P), h_final (B, H, N, P))."""
    b, S, H, P = x.shape
    N = B.shape[-1]
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        alog = F.pad(alog, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nck = x.shape[1] // chunk
    xc = x.reshape(b, nck, chunk, H, P).float()
    ac = alog.reshape(b, nck, chunk, H).float()
    Bc = B.reshape(b, nck, chunk, N).float()
    Cc = C.reshape(b, nck, chunk, N).float()

    cs = torch.cumsum(ac, dim=2)                                # (b,n,L,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (b,n,L,L,H)
    # mask before exp: above the diagonal the exponent is positive
    Lmat = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    G = torch.einsum("bnsj,bntj->bnst", Cc, Bc)                 # (b,n,L,L)
    y_intra = torch.einsum("bnsth,bnthp->bnshp", G[..., None] * Lmat, xc)

    decay_end = torch.exp(cs[:, :, -1:, :] - cs)                # (b,n,L,H)
    chunk_in = torch.einsum("bntj,bnthp->bnhjp", Bc,
                            decay_end[..., None] * xc)          # (b,n,H,N,P)
    chunk_decay = torch.exp(cs[:, :, -1, :])                    # (b,n,H)

    h = (torch.zeros((b, H, N, P), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    h_in = []                                  # state ENTERING each chunk
    for i in range(nck):
        h_in.append(h)
        h = chunk_decay[:, i, :, None, None] * h + chunk_in[:, i]
    h_in = torch.stack(h_in, dim=1)                             # (b,n,H,N,P)
    y_inter = torch.einsum("bnsj,bnhjp->bnshp", Cc, h_in) * \
        torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, nck * chunk, H, P)[:, :S]
    return y.to(x.dtype), h


def _chunks(t, chunk: int):
    """(b, S, ...) -> (b, n_chunks, chunk, ...) f32, S padded with zeros."""
    pad = (-t.shape[1]) % chunk
    if pad:
        t = F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
    return t.reshape(t.shape[0], -1, chunk, *t.shape[2:]).float()


def ssd_chunk_states(x, alog, B, chunk: int = 128, pairs: bool = False):
    """Pass 1. Per chunk: cs = cumsum of alog over the chunk (padded steps
    add 0), and the chunk's state contribution B^T (w x) with
    w = exp(cs[L-1] - cs). Returns (states (b, n_chunks, H, N, P) f32,
    cs (b, n_chunks, L, H) f32)."""
    xc, Bc = _chunks(x, chunk), _chunks(B, chunk)
    cs = torch.cumsum(_chunks(alog, chunk), dim=2)              # (b,n,L,H)
    wx = torch.exp(cs[:, :, -1:] - cs)[..., None] * xc         # (b,n,L,H,P)
    if pairs:
        wx = through_pair(wx)
    return torch.einsum("bntj,bnthp->bnhjp", Bc, wx), cs


def ssd_state_passing(states, cs, h0=None, pairs: bool = False):
    """Pass 2. h_in[c] = exp(cs[c-1][L-1]) h_in[c-1] + states[c-1], from h0
    (or 0). Returns (h_in (b, n_chunks, H, N, P), h_final (b, H, N, P)),
    f32; with ``pairs`` h_in as its hi + lo pair."""
    b, nck, H, N, P = states.shape
    h = (states.new_zeros((b, H, N, P)) if h0 is None else h0.float())
    h_in = []
    for c in range(nck):
        h_in.append(h)
        h = torch.exp(cs[:, c, -1, :])[:, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)
    return (through_pair(h_in) if pairs else h_in), h


def ssd_chunk_output(x, B, C, cs, h_in, pairs: bool = False):
    """Pass 3. y = ((C B^T) o decay mask) x + exp(cs) o (C h_in), the mask
    applied before exp. Returns y (b, S, H, P) in x's dtype."""
    chunk, S = cs.shape[2], x.shape[1]
    xc, Bc, Cc = (_chunks(t, chunk) for t in (x, B, C))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    diff = cs[:, :, :, None, :] - cs[:, :, None, :, :]          # (b,n,L,L,H)
    decay = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                       float("-inf")))
    G = torch.einsum("bnsj,bntj->bnst", Cc, Bc)[..., None] * decay
    if pairs:
        G = through_pair(G)
    y = torch.einsum("bnsth,bnthp->bnshp", G, xc) + torch.exp(cs)[..., None] \
        * torch.einsum("bnsj,bnhjp->bnshp", Cc, h_in)
    return y.reshape(x.shape[0], -1, *x.shape[2:])[:, :S].to(x.dtype)


def ssd_three_pass(x, alog, B, C, h0=None, chunk: int = 128,
                   pairs: bool = False):
    """The chunked SSD in the bf16 kernel's three passes. Returns
    (y (b, S, H, P) in x's dtype, h_final (b, H, N, P) f32)."""
    states, cs = ssd_chunk_states(x, alog, B, chunk, pairs)
    h_in, h = ssd_state_passing(states, cs, h0, pairs)
    return ssd_chunk_output(x, B, C, cs, h_in, pairs), h
