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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
