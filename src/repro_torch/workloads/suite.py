"""Compute-kernel workload suite in torch: the port of ``repro.workloads.suite``
(the paper's four benchmark suites, Rodinia 3.1, Parboil 2.5, Polybench-GPU
1.0 and SHOC, §4.1, plus serving-shaped ML kernels under ``misc``).

Each ``Workload`` is a plain function on tensors, its concrete arguments and
its launch configuration (parallel work items). The registry, the names, the
size maps and the per-workload seeds are the reference's, and every input is
drawn from the same numpy generator in the same order, so a workload's
inputs equal the reference's bit for bit. The inputs are made on the host
and then moved to ``device``.

Types follow the reference, which runs with 64-bit types off:

* integer inputs and integer results are int32 (``searchsorted(...,
  out_int32=True)``, ``argmin``/``argmax``/``topk`` indices cast, histograms
  accumulated in int32), so the byte counts of inputs and outputs are the
  reference's;
* ``md5hash`` carries the reference's uint32 hash as int32 with the same
  bits: the left shift and the wrapping multiply give the same bits, and the
  logical right shift is an arithmetic one masked to its low bits.

The reference's ``jax.lax.scan`` loops are ``torch._higher_order_ops.scan``
loops, never unrolled: a loop with only a trip count scans over a
``(length, 0)`` tensor, so an exported graph keeps one ``scan`` node whose
inputs carry the trip count on dim 0 (``core.features`` reads it there).
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch._higher_order_ops import scan

from ..core.forest_torch import resolve_device


@dataclass
class Workload:
    app: str
    kernel: str
    variant: str
    fn: object                  # plain function on tensors
    args: tuple                 # concrete tensors on the suite's device
    work_items: float


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return np.asarray(rng.normal(size=shape) * scale, np.float32)


def _eye(n):
    return np.float32(n) * np.eye(n, dtype=np.float32)


def _loop(step, init, length: int):
    """``lax.scan(step, init, None, length=length)``: the loop's only input
    is a (length, 0) tensor, which carries the trip count."""
    leaf = init[0] if isinstance(init, tuple) else init
    carry, _ = scan(lambda c, _: step(c), init, leaf.new_zeros(length, 0))
    return carry


def _one_hot(idx, n: int, like):
    """``jax.nn.one_hot``: a compare against an iota."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(like.dtype)


def _gelu(x):
    """``jax.nn.gelu`` (its default tanh approximation), as it computes."""
    cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * (x ** 3))))
    return x * cdf


def _i32(x):
    return x.to(torch.int32)


# ------------------------------------------------------------- linear algebra

def w_gemm(n, rng):
    a, b = _f32(rng, n, n), _f32(rng, n, n)
    return (lambda a, b: a @ b), (a, b), float(n * n)


def w_2mm(n, rng):
    a, b, c = _f32(rng, n, n), _f32(rng, n, n), _f32(rng, n, n)
    return (lambda a, b, c: (a @ b) @ c), (a, b, c), float(n * n)


def w_3mm(n, rng):
    a, b, c, d = (_f32(rng, n, n) for _ in range(4))
    return (lambda a, b, c, d: ((a @ b) @ (c @ d))), (a, b, c, d), float(n * n)


def w_atax(n, rng):
    A, x = _f32(rng, n, n), _f32(rng, n)
    return (lambda A, x: A.T @ (A @ x)), (A, x), float(n)


def w_bicg(n, rng):
    A, p, r = _f32(rng, n, n), _f32(rng, n), _f32(rng, n)
    return (lambda A, p, r: (A @ p, A.T @ r)), (A, p, r), float(n)


def w_mvt(n, rng):
    A, x1, x2 = _f32(rng, n, n), _f32(rng, n), _f32(rng, n)
    return (lambda A, x1, x2: (x1 + A @ x2, x2 + A.T @ x1)), (A, x1, x2), float(n)


def w_gesummv(n, rng):
    A, B, x = _f32(rng, n, n), _f32(rng, n, n), _f32(rng, n)
    return (lambda A, B, x: 1.5 * (A @ x) + 2.5 * (B @ x)), (A, B, x), float(n)


def w_syrk(n, rng):
    A, C = _f32(rng, n, n), _f32(rng, n, n)
    return (lambda A, C: 0.5 * C + 1.5 * (A @ A.T)), (A, C), float(n * n)


def w_syr2k(n, rng):
    A, B, C = (_f32(rng, n, n) for _ in range(3))
    return (lambda A, B, C: C + A @ B.T + B @ A.T), (A, B, C), float(n * n)


def w_gramschmidt(n, rng):
    A = _f32(rng, n, n)
    def f(A):
        q, r = torch.linalg.qr(A)
        return q
    return f, (A,), float(n * n)


def w_lud(n, rng):
    A = _f32(rng, n, n) + _eye(n)
    def f(A):
        return torch.linalg.lu_factor(A)[0]
    return f, (A,), float(n)


def w_correlation(n, rng):
    D = _f32(rng, n, 64)
    def f(D):
        Z = (D - D.mean(0)) / (D.std(0, correction=0) + 1e-6)
        return Z.T @ Z / D.shape[0]
    return f, (D,), float(n)


def w_covariance(n, rng):
    D = _f32(rng, n, 64)
    def f(D):
        Z = D - D.mean(0)
        return Z.T @ Z / (D.shape[0] - 1)
    return f, (D,), float(n)


# ------------------------------------------------------------------- stencils

def w_conv2d(n, rng):
    x = _f32(rng, 1, 1, n, n)
    k = _f32(rng, 8, 1, 3, 3)
    def f(x, k):
        return F.conv2d(x, k, padding="same")
    return f, (x, k), float(n * n)


def w_conv3d(n, rng):
    x = _f32(rng, 1, 1, n, n, n)
    k = _f32(rng, 4, 1, 3, 3, 3)
    def f(x, k):
        return F.conv3d(x, k, padding="same")
    return f, (x, k), float(n ** 3)


def w_stencil2d(n, rng):
    x = _f32(rng, n, n)
    def f(x):
        def step(x):
            y = (x + torch.roll(x, 1, 0) + torch.roll(x, -1, 0)
                 + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)) * 0.2
            return y, ()
        return _loop(step, x, 8)
    return f, (x,), float(n * n)


def w_hotspot(n, rng):
    t = _f32(rng, n, n, scale=0.1)
    p = _f32(rng, n, n, scale=0.1)
    def f(t, p):
        def step(t):
            lap = (torch.roll(t, 1, 0) + torch.roll(t, -1, 0)
                   + torch.roll(t, 1, 1) + torch.roll(t, -1, 1) - 4 * t)
            return t + 0.1 * (lap + p), ()
        return _loop(step, t, 8)
    return f, (t, p), float(n * n)


def w_fdtd2d(n, rng):
    ex, ey, hz = (_f32(rng, n, n, scale=0.1) for _ in range(3))
    def f(ex, ey, hz):
        def step(c):
            ex, ey, hz = c
            ex = ex - 0.5 * (hz - torch.roll(hz, 1, 0))
            ey = ey - 0.5 * (hz - torch.roll(hz, 1, 1))
            hz = hz - 0.7 * ((torch.roll(ex, -1, 0) - ex)
                             + (torch.roll(ey, -1, 1) - ey))
            return (ex, ey, hz), ()
        ex, ey, hz = _loop(step, (ex, ey, hz), 6)
        return hz
    return f, (ex, ey, hz), float(n * n)


def w_srad(n, rng):
    img = np.abs(_f32(rng, n, n)) + 0.1
    def f(x):
        def step(x):
            dx = torch.roll(x, -1, 0) - x
            dy = torch.roll(x, -1, 1) - x
            g2 = (dx * dx + dy * dy) / (x * x + 1e-6)
            c = 1.0 / (1.0 + g2)
            return x + 0.05 * c * (dx + dy), ()
        return _loop(step, x, 6)
    return f, (img,), float(n * n)


def w_lbm(n, rng):
    f9 = np.abs(_f32(rng, 9, n, n, scale=0.01)) + 0.1
    def f(f9):
        def step(f9):
            rho = f9.sum(0)
            feq = rho[None] / 9.0
            f9 = f9 + 0.6 * (feq - f9)
            f9 = torch.stack([torch.roll(torch.roll(f9[i], i % 3 - 1, 0),
                                         i // 3 - 1, 1) for i in range(9)])
            return f9, ()
        return _loop(step, f9, 4)
    return f, (f9,), float(n * n)


# --------------------------------------------------------- reductions / scans

def w_reduction(n, rng):
    x = _f32(rng, n * n)
    return (lambda x: x.sum()), (x,), float(n * n)


def w_scan(n, rng):
    x = _f32(rng, n * n)
    return (lambda x: torch.cumsum(x, 0)), (x,), float(n * n)


def w_sort(n, rng):
    x = _f32(rng, n * n)
    return (lambda x: torch.sort(x)[0]), (x,), float(n * n)


def w_triad(n, rng):
    a, b = _f32(rng, n * n), _f32(rng, n * n)
    return (lambda a, b: a + 1.75 * b), (a, b), float(n * n)


def w_histogram(n, rng):
    x = rng.integers(0, 256, size=n * n).astype(np.int32)
    def f(x):
        return torch.zeros(256, dtype=torch.int32, device=x.device).index_put(
            (x,), torch.ones_like(x), accumulate=True)
    return f, (x,), float(n * n)


def w_maxflops(n, rng):
    x = _f32(rng, n, n)
    def f(x):
        def step(y):
            return torch.tanh(y @ x) * 0.5 + y * 0.5, ()
        return _loop(step, x.clone(), 4)           # scan carries no aliases
    return f, (x,), float(n * n)


# -------------------------------------------------------------- physics / ML

def w_md(n, rng):
    pos = _f32(rng, n, 3)
    def f(pos):
        d = pos[:, None, :] - pos[None, :, :]
        r2 = (d * d).sum(-1) + torch.eye(pos.shape[0], device=pos.device)
        inv6 = 1.0 / (r2 * r2 * r2)
        force = (24 * inv6 * (2 * inv6 - 1) / r2)[..., None] * d
        return force.sum(1)
    return f, (pos,), float(n)


def w_cutcp(n, rng):
    pos = _f32(rng, n, 3)
    q = _f32(rng, n)
    def f(pos, q):
        d = pos[:, None, :] - pos[None, :, :]
        r = torch.sqrt((d * d).sum(-1) + 1e-3)
        pot = torch.where(r < 1.5, q[None, :] / r, 0.0)
        return pot.sum(1)
    return f, (pos, q), float(n)


def w_tpacf(n, rng):
    a = _f32(rng, n, 3)
    def f(a):
        an = a / torch.sqrt((a * a).sum(1, keepdim=True))
        cos = an @ an.T
        bins = torch.clip(_i32((cos + 1) * 16), 0, 31)
        return torch.zeros(32, dtype=torch.int32, device=a.device).index_put(
            (bins.reshape(-1),), torch.ones_like(bins.reshape(-1)),
            accumulate=True)
    return f, (a,), float(n)


def w_nbody(n, rng):
    pos, vel = _f32(rng, n, 3), _f32(rng, n, 3, scale=0.1)
    def f(pos, vel):
        d = pos[None] - pos[:, None]
        r3 = ((d * d).sum(-1) + 0.01) ** 1.5
        acc = (d / r3[..., None]).sum(1)
        return pos + 0.01 * vel, vel + 0.01 * acc
    return f, (pos, vel), float(n)


def w_backprop(n, rng):
    x = _f32(rng, n, 64)
    w1, w2 = _f32(rng, 64, 128, scale=0.1), _f32(rng, 128, 10, scale=0.1)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    def f(x, w1, w2, y):
        # the gradient of the reference's loss (the mean negative
        # log-likelihood of a tanh layer and a linear one) in (w1, w2),
        # written out as jax.grad computes it
        h = torch.tanh(x @ w1)
        logits = h @ w2
        g = (torch.softmax(logits, -1) - _one_hot(y, 10, logits)) / x.shape[0]
        gh = (g @ w2.T) * (1 - h * h)
        return x.T @ gh, h.T @ g
    return f, (x, w1, w2, y), float(n)


def w_kmeans(n, rng):
    x = _f32(rng, n, 16)
    c = _f32(rng, 8, 16)
    def f(x, c):
        d = ((x[:, None] - c[None]) ** 2).sum(-1)
        onehot = _one_hot(d.argmin(1), 8, x)
        return (onehot.T @ x) / (onehot.sum(0)[:, None] + 1e-6)
    return f, (x, c), float(n)


def w_myocyte(n, rng):
    y = np.abs(_f32(rng, n, 4, scale=0.3)) + 0.2
    def f(y):
        def step(y):
            a, b, c, d = y[:, 0], y[:, 1], y[:, 2], y[:, 3]
            da = torch.exp(-b) * c - 0.3 * a
            db = torch.sin(a) - 0.1 * b * d
            dc = torch.log1p(torch.abs(a * b)) - 0.2 * c
            dd = torch.tanh(c) - 0.05 * d
            return y + 0.01 * torch.stack([da, db, dc, dd], 1), ()
        return _loop(step, y, 16)
    return f, (y,), float(n)


def w_blackscholes(n, rng):
    s = np.abs(_f32(rng, n * n)) * 40 + 20
    k = np.abs(_f32(rng, n * n)) * 40 + 20
    def f(s, k):
        t, r, v = 1.0, 0.03, 0.3
        d1 = (torch.log(s / k) + (r + v * v / 2) * t) / (v * math.sqrt(t))
        d2 = d1 - v * math.sqrt(t)
        cdf = lambda x: 0.5 * (1 + torch.erf(x / math.sqrt(2.0)))
        return s * cdf(d1) - k * math.exp(-r * t) * cdf(d2)
    return f, (s, k), float(n * n)


# -------------------------------------------------------- integer / irregular

def w_md5ish(n, rng):
    # the reference's uint32 values (all below 2^31), as int32 with the same
    # bits: << and * wrap alike, >> is masked to a logical shift, and the
    # reference's & 0xFFFFFFFF is & -1
    x = rng.integers(0, 2**31, size=n * n, dtype=np.int64).astype(np.int32)
    def f(x):
        def step(h):
            h = (h ^ (h << 13)) & -1
            h = h ^ ((h >> 17) & 0x7FFF)
            h = (h * 0x5BD1E995) & -1
            return h, ()
        return _loop(step, x, 16)
    return f, (x,), float(n * n)


def w_spmv(n, rng):
    A = _f32(rng, n, n)
    mask = (rng.random((n, n)) < 0.05).astype(np.float32)
    x = _f32(rng, n)
    return (lambda A, m, x: (A * m) @ x), (A, mask, x), float(n)


def w_bfs(n, rng):
    adj = (rng.random((n, n)) < (4.0 / n)).astype(np.float32)
    def f(adj):
        frontier = (torch.arange(adj.shape[0], device=adj.device)
                    == 0).to(adj.dtype)
        visited = frontier.clone()              # scan carries no aliases
        def step(c):
            frontier, visited = c
            nxt = torch.clip(adj.T @ frontier, 0, 1) * (1 - visited)
            return (nxt, torch.clip(visited + nxt, 0, 1)), ()
        _, v = _loop(step, (frontier, visited), 8)
        return v
    return f, (adj,), float(n)


def w_nw(n, rng):
    """Needleman-Wunsch-style anti-diagonal DP (control-flow heavy)."""
    s = rng.integers(-2, 3, size=(n, n)).astype(np.float32)
    def f(s):
        def row(prev, srow):
            def cell(left, args):
                diag_up, sc = args
                best = torch.maximum(diag_up + sc, left - 1.0)
                return best, best.clone()
            shifted = torch.cat([prev[:1], prev[:-1]])
            _, r = scan(cell, prev.new_zeros(()), (shifted, srow))
            return r, r.clone()
        _, out = scan(row, s.new_zeros(s.shape[1]), s)
        return out[-1, -1]
    return f, (s,), float(n)


def w_fft(n, rng):
    x = _f32(rng, n * n)
    return (lambda x: torch.abs(torch.fft.fft(x))), (x,), float(n * n)


def w_particlefilter(n, rng):
    w = np.abs(_f32(rng, n * n)) + 1e-3
    def f(w):
        p = w / w.sum()
        c = torch.cumsum(p, 0)
        u = (torch.arange(p.shape[0], dtype=torch.int32, device=w.device)
             + 0.5) / p.shape[0]
        return torch.searchsorted(c, u, out_int32=True)
    return f, (w,), float(n * n)


def w_attention_small(n, rng):
    q = _f32(rng, 4, n, 64, scale=0.3)
    k = _f32(rng, 4, n, 64, scale=0.3)
    v = _f32(rng, 4, n, 64, scale=0.3)
    def f(q, k, v):
        s = torch.einsum("hqd,hkd->hqk", q, k) / 8.0
        return torch.einsum("hqk,hkd->hqd", torch.softmax(s, -1), v)
    return f, (q, k, v), float(4 * n)


def w_softmax_xent(n, rng):
    logits = _f32(rng, n, 512)
    y = rng.integers(0, 512, size=n).astype(np.int32)
    def f(logits, y):
        return -torch.gather(torch.log_softmax(logits, -1), 1,
                             y[:, None].long()).mean()
    return f, (logits, y), float(n)


# ------------------------------------------------- growth registry kernels

def w_cholesky(n, rng):
    A = torch.from_numpy(_f32(rng, n, n))
    # the product on the host in float32: torch's CPU matmul sums in the
    # order XLA's does, so the input equals the reference's bit for bit
    spd = (A @ A.T + torch.from_numpy(_eye(n))).numpy()
    return (lambda A: torch.linalg.cholesky(A)), (spd,), float(n * n)


def w_trisolv(n, rng):
    A = _f32(rng, n, n)
    L = np.tril(A) + _eye(n)
    b = _f32(rng, n)
    def f(L, b):
        return torch.linalg.solve_triangular(L, b[:, None], upper=False)[:, 0]
    return f, (L, b), float(n)


def w_ludcmp(n, rng):
    A = _f32(rng, n, n) + _eye(n)
    b = _f32(rng, n)
    def f(A, b):
        lu, piv = torch.linalg.lu_factor(A)
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
    return f, (A, b), float(n)


def w_gemver(n, rng):
    A, u1, v1, u2, v2, y, z = (_f32(rng, n, n), _f32(rng, n), _f32(rng, n),
                               _f32(rng, n), _f32(rng, n), _f32(rng, n),
                               _f32(rng, n))
    def f(A, u1, v1, u2, v2, y, z):
        B = A + torch.outer(u1, v1) + torch.outer(u2, v2)
        x = z + 1.2 * (B.T @ y)
        return 1.5 * (B @ x)
    return f, (A, u1, v1, u2, v2, y, z), float(n)


def w_symm(n, rng):
    A, B, C = (_f32(rng, n, n) for _ in range(3))
    def f(A, B, C):
        S = torch.tril(A) + torch.tril(A, -1).T
        return 1.5 * (S @ B) + 0.5 * C
    return f, (A, B, C), float(n * n)


def w_trmm(n, rng):
    A, B = _f32(rng, n, n), _f32(rng, n, n)
    return (lambda A, B: torch.tril(A) @ B), (A, B), float(n * n)


def w_doitgen(n, rng):
    A = _f32(rng, n, n, n)
    C4 = _f32(rng, n, n)
    def f(A, C4):
        return torch.einsum("rqp,ps->rqs", A, C4)
    return f, (A, C4), float(n * n)


def w_jacobi1d(n, rng):
    x = _f32(rng, n * n)
    def f(x):
        def step(x):
            return (torch.roll(x, 1) + x + torch.roll(x, -1)) / 3.0, ()
        return _loop(step, x, 10)
    return f, (x,), float(n * n)


def w_heat3d(n, rng):
    t = _f32(rng, n, n, n, scale=0.1)
    def f(t):
        def step(t):
            lap = sum(torch.roll(t, d, a) for d in (1, -1) for a in (0, 1, 2))
            return 0.75 * t + 0.125 / 6.0 * lap, ()
        return _loop(step, t, 4)
    return f, (t,), float(n ** 3)


def w_adi(n, rng):
    u = _f32(rng, n, n, scale=0.1)
    def f(u):
        def half(u, axis):
            fwd = torch.cumsum(u, axis) * 0.01
            bwd = torch.flip(torch.cumsum(torch.flip(u, (axis,)), axis),
                             (axis,)) * 0.01
            return u + 0.5 * (fwd - bwd) / n
        def step(u):
            return half(half(u, 0), 1), ()
        return _loop(step, u, 4)
    return f, (u,), float(n * n)


def w_floyd_warshall(n, rng):
    D = np.abs(_f32(rng, n, n)) * 10 + 0.1
    def f(D):
        def step(D, k):
            k = k[None]
            return torch.minimum(D, torch.index_select(D, 1, k)
                                 + torch.index_select(D, 0, k)), ()
        D, _ = scan(step, D, torch.arange(D.shape[0], dtype=torch.int32,
                                          device=D.device))
        return D
    return f, (D,), float(n)


def w_deriche(n, rng):
    img = _f32(rng, n, n)
    def f(img):
        a = 0.25
        def fwd(carry, col):
            y = (1 - a) * col + a * carry
            return y, y.clone()
        _, y1 = scan(fwd, img.new_zeros(img.shape[0]), img.T)
        _, y2 = scan(fwd, img.new_zeros(img.shape[0]), torch.flip(y1, (0,)))
        return torch.flip(y2, (0,)).T
    return f, (img,), float(n * n)


def w_pathfinder(n, rng):
    grid = np.abs(_f32(rng, n, n)) * 10
    def f(grid):
        def row(cost, r):
            left = torch.cat([cost[:1], cost[:-1]])
            right = torch.cat([cost[1:], cost[-1:]])
            return r + torch.minimum(cost, torch.minimum(left, right)), ()
        cost, _ = scan(row, grid[0], grid[1:])
        return cost.amin()
    return f, (grid,), float(n)


def w_hotspot3d(n, rng):
    t = _f32(rng, n, n, n, scale=0.1)
    p = _f32(rng, n, n, n, scale=0.1)
    def f(t, p):
        def step(t):
            lap = sum(torch.roll(t, d, a)
                      for d in (1, -1) for a in (0, 1, 2)) - 6 * t
            return t + 0.05 * (lap + p), ()
        return _loop(step, t, 4)
    return f, (t, p), float(n ** 3)


def w_gaussian(n, rng):
    A = _f32(rng, n, n) + _eye(n)
    b = _f32(rng, n)
    return (lambda A, b: torch.linalg.solve(A, b)), (A, b), float(n)


def w_streamcluster(n, rng):
    pts = _f32(rng, n, 8)
    w = np.abs(_f32(rng, n)) + 0.1
    ctr = _f32(rng, 16, 8)
    def f(pts, w, ctr):
        d = ((pts[:, None] - ctr[None]) ** 2).sum(-1)
        return (w * d.amin(1)).sum()
    return f, (pts, w, ctr), float(n)


def w_cfd(n, rng):
    rho = np.abs(_f32(rng, n * n)) + 1.0
    mom = _f32(rng, n * n, scale=0.1)
    ene = np.abs(_f32(rng, n * n)) + 2.0
    def f(rho, mom, ene):
        def step(s):
            rho, mom, ene = s
            v = mom / rho
            pre = 0.4 * (ene - 0.5 * mom * v)
            fr, fm, fe = mom, mom * v + pre, v * (ene + pre)
            d = lambda q: (torch.roll(q, 1) - torch.roll(q, -1)) * 0.5
            return (rho + 0.01 * d(fr), mom + 0.01 * d(fm),
                    ene + 0.01 * d(fe)), ()
        rho, mom, ene = _loop(step, (rho, mom, ene), 4)
        return rho + mom + ene
    return f, (rho, mom, ene), float(n * n)


def w_lavamd(n, rng):
    pos = _f32(rng, n, 3)
    q = _f32(rng, n)
    def f(pos, q):
        d = pos[:, None, :] - pos[None, :, :]
        r2 = (d * d).sum(-1) + torch.eye(pos.shape[0], device=pos.device)
        inside = (r2 < 2.0).to(torch.float32)
        u2 = torch.exp(-0.5 * r2) * inside
        force = (q[None, :] * u2 / r2)[..., None] * d
        return force.sum(1)
    return f, (pos, q), float(n)


def w_nn(n, rng):
    pts = _f32(rng, n, 4)
    ref = _f32(rng, n, 4)
    def f(pts, ref):
        d = ((pts[:, None] - ref[None]) ** 2).sum(-1)
        return torch.topk(-d, 8)[0]
    return f, (pts, ref), float(n)


def w_dwt2d(n, rng):
    img = _f32(rng, n, n)
    def f(x):
        for axis in (0, 1):
            even = torch.arange(0, x.shape[axis], 2, device=x.device)
            odd = torch.arange(1, x.shape[axis], 2, device=x.device)
            lo = (torch.index_select(x, axis, even)
                  + torch.index_select(x, axis, odd)) / 2
            hi = (torch.index_select(x, axis, even)
                  - torch.index_select(x, axis, odd)) / 2
            x = torch.cat([lo, hi], axis)
        return x
    return f, (img,), float(n * n)


def w_btree(n, rng):
    keys = np.sort(_f32(rng, n * n))
    payload = _f32(rng, n * n)
    queries = _f32(rng, n * n)
    def f(keys, payload, queries):
        idx = torch.clip(torch.searchsorted(keys, queries, out_int32=True), 0,
                         keys.shape[0] - 1)
        return payload[idx]
    return f, (keys, payload, queries), float(n * n)


def w_leukocyte(n, rng):
    img = np.abs(_f32(rng, n, n)) + 0.1
    def f(img):
        gx = torch.roll(img, -1, 0) - torch.roll(img, 1, 0)
        gy = torch.roll(img, -1, 1) - torch.roll(img, 1, 1)
        g2 = gx * gx + gy * gy
        score = sum(torch.roll(torch.roll(g2, i, 0), j, 1)
                    for i in (-1, 0, 1) for j in (-1, 0, 1))
        return score.amax()
    return f, (img,), float(n * n)


def w_s3d(n, rng):
    y = np.abs(_f32(rng, n, 8, scale=0.3)) + 0.1
    T = np.abs(_f32(rng, n)) * 500 + 800
    def f(y, T):
        ea = torch.arange(1, 9, dtype=torch.float32, device=y.device) * 900.0
        k = torch.exp(8.0 - ea[None, :] / T[:, None])
        rates = k * y * torch.roll(y, 1, 1)
        return rates.sum(1) + torch.log(T)
    return f, (y, T), float(n)


def w_qtc(n, rng):
    pts = _f32(rng, n, 4)
    def f(pts):
        d = ((pts[:, None] - pts[None]) ** 2).sum(-1)
        deg = (d < 1.5).sum(1, dtype=torch.int32)
        return _i32(deg.argmax()), deg.amax()
    return f, (pts,), float(n)


def w_neuralnet(n, rng):
    x = _f32(rng, n, 32)
    w1, w2, w3 = (_f32(rng, 32, 64, scale=0.2), _f32(rng, 64, 64, scale=0.2),
                  _f32(rng, 64, 10, scale=0.2))
    def f(x, w1, w2, w3):
        h = torch.relu(x @ w1)
        h = torch.tanh(h @ w2)
        return torch.softmax(h @ w3, -1)
    return f, (x, w1, w2, w3), float(n)


def w_devmem(n, rng):
    x = _f32(rng, n * n)
    def f(x):
        unit = x + 1.0
        strided = x[::7].sum()
        rev = torch.cumsum(torch.flip(x, (0,)), 0)
        return unit.sum() + strided + rev[-1]
    return f, (x,), float(n * n)


def w_fft2d(n, rng):
    x = _f32(rng, n, n)
    return (lambda x: torch.abs(torch.fft.fft2(x))), (x,), float(n * n)


def w_mriq(n, rng):
    kpts = _f32(rng, n, 3, scale=0.5)
    xpts = _f32(rng, 64, 3)
    phi = _f32(rng, n)
    def f(kpts, xpts, phi):
        ang = 2 * math.pi * (kpts @ xpts.T)
        return ((phi[:, None] * torch.cos(ang)).sum(0),
                (phi[:, None] * torch.sin(ang)).sum(0))
    return f, (kpts, xpts, phi), float(n)


def w_sad(n, rng):
    cur = _f32(rng, n, n)
    ref = _f32(rng, n, n)
    def f(cur, ref):
        sads = torch.stack([
            torch.abs(cur - torch.roll(torch.roll(ref, dy, 0), dx, 1)).sum()
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
        return sads.amin()
    return f, (cur, ref), float(n * n)


def w_stencil3d(n, rng):
    x = _f32(rng, n, n, n)
    def f(x):
        def step(x):
            faces = sum(torch.roll(x, d, a)
                        for d in (1, -1) for a in (0, 1, 2))
            return 0.4 * x + 0.1 * faces, ()
        return _loop(step, x, 2)
    return f, (x,), float(n ** 3)


def w_gridding(n, rng):
    val = _f32(rng, n * n)
    cell = rng.integers(0, 256 * 256, size=n * n).astype(np.int32)
    def f(val, cell):
        grid = torch.zeros(256 * 256, dtype=torch.float32, device=val.device)
        return grid.index_put((cell,), val, accumulate=True)
    return f, (val, cell), float(n * n)


def w_spmv_jds(n, rng):
    A = _f32(rng, n, n)
    mask = (rng.random((n, n)) < 0.01).astype(np.float32)
    diag = np.eye(n, dtype=np.float32)
    x = _f32(rng, n)
    return (lambda A, m, d, x: (A * (m + d)) @ x), (A, mask, diag, x), float(n)


def w_bilateral(n, rng):
    img = np.abs(_f32(rng, n, n)) + 0.1
    def f(img):
        acc = torch.zeros_like(img)
        norm = torch.zeros_like(img)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                nb = torch.roll(torch.roll(img, di, 0), dj, 1)
                w = torch.exp(-0.5 * (di * di + dj * dj)
                              - ((nb - img) ** 2) / 0.02)
                acc = acc + w * nb
                norm = norm + w
        return acc / norm
    return f, (img,), float(n * n)


def w_layernorm(n, rng):
    x = _f32(rng, n, 256)
    g, b = _f32(rng, 256), _f32(rng, 256)
    def f(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * g + b
    return f, (x, g, b), float(n)


def w_gelu_mlp(n, rng):
    x = _f32(rng, n, 128)
    w1, w2 = _f32(rng, 128, 512, scale=0.1), _f32(rng, 512, 128, scale=0.1)
    def f(x, w1, w2):
        return _gelu(x @ w1) @ w2
    return f, (x, w1, w2), float(n)


def w_embedding_bag(n, rng):
    table = _f32(rng, 4096, 64)
    idx = rng.integers(0, 4096, size=(n, 16)).astype(np.int32)
    def f(table, idx):
        return table[idx].sum(1)
    return f, (table, idx), float(n)


def w_topk_sampling(n, rng):
    logits = _f32(rng, n, 1024)
    def f(logits):
        vals, idx = torch.topk(logits, 32)
        return torch.softmax(vals, -1), _i32(idx)
    return f, (logits,), float(n)


def w_moe_router(n, rng):
    x = _f32(rng, n, 128)
    wg = _f32(rng, 128, 16, scale=0.1)
    def f(x, wg):
        gates = torch.softmax(x @ wg, -1)
        top, idx = torch.topk(gates, 2)
        return top / top.sum(-1, keepdim=True), _i32(idx)
    return f, (x, wg), float(n)


def w_paged_kv_gather(n, rng):
    kv = _f32(rng, 512, 16, 64)
    pages = rng.integers(0, 512, size=(n, 8)).astype(np.int32)
    q = _f32(rng, n, 64, scale=0.3)
    def f(kv, pages, q):
        blocks = kv[pages]                       # (n, 8, 16, 64)
        keys = blocks.reshape(blocks.shape[0], -1, 64)
        s = torch.einsum("nd,nkd->nk", q, keys) / 8.0
        return torch.softmax(s, -1)
    return f, (kv, pages, q), float(n)


# small / medium / large / xl per app (paper: 4 problem sizes, §4.1)
_SIZES = {"s": 64, "m": 128, "l": 256, "xl": 384}
_CUBIC = {"s": 16, "m": 24, "l": 32, "xl": 48}       # 3-d kernels
_PAIRWISE = {"s": 128, "m": 256, "l": 512, "xl": 1024}

# the reference's seed registry, listed first so that kernel identities
# match its cached ground-truth datasets
_SEED_REGISTRY = [
    ("polybench", "gemm", w_gemm, _SIZES),
    ("polybench", "2mm", w_2mm, _SIZES),
    ("polybench", "3mm", w_3mm, _SIZES),
    ("polybench", "atax", w_atax, _SIZES),
    ("polybench", "bicg", w_bicg, _SIZES),
    ("polybench", "mvt", w_mvt, _SIZES),
    ("polybench", "gesummv", w_gesummv, _SIZES),
    ("polybench", "syrk", w_syrk, _SIZES),
    ("polybench", "syr2k", w_syr2k, _SIZES),
    ("polybench", "gramschmidt", w_gramschmidt, _SIZES),
    ("polybench", "correlation", w_correlation, _PAIRWISE),
    ("polybench", "covariance", w_covariance, _PAIRWISE),
    ("polybench", "2dconv", w_conv2d, _SIZES),
    ("polybench", "3dconv", w_conv3d, _CUBIC),
    ("polybench", "fdtd2d", w_fdtd2d, _SIZES),
    ("rodinia", "hotspot", w_hotspot, _SIZES),
    ("rodinia", "srad", w_srad, _SIZES),
    ("rodinia", "lud", w_lud, _SIZES),
    ("rodinia", "backprop", w_backprop, _PAIRWISE),
    ("rodinia", "kmeans", w_kmeans, _PAIRWISE),
    ("rodinia", "myocyte", w_myocyte, _PAIRWISE),
    ("rodinia", "bfs", w_bfs, _PAIRWISE),
    ("rodinia", "nw", w_nw, _SIZES),
    ("rodinia", "particlefilter", w_particlefilter, _SIZES),
    ("shoc", "reduction", w_reduction, _SIZES),
    ("shoc", "scan", w_scan, _SIZES),
    ("shoc", "sort", w_sort, _SIZES),
    ("shoc", "triad", w_triad, _SIZES),
    ("shoc", "fft", w_fft, _SIZES),
    ("shoc", "md", w_md, _PAIRWISE),
    ("shoc", "maxflops", w_maxflops, _SIZES),
    ("shoc", "stencil2d", w_stencil2d, _SIZES),
    ("shoc", "spmv", w_spmv, _PAIRWISE),
    ("shoc", "md5hash", w_md5ish, _SIZES),
    ("parboil", "histo", w_histogram, _SIZES),
    ("parboil", "sgemm", w_gemm, {"s": 96, "m": 192, "l": 320, "xl": 448}),
    ("parboil", "lbm", w_lbm, _SIZES),
    ("parboil", "cutcp", w_cutcp, _PAIRWISE),
    ("parboil", "tpacf", w_tpacf, _PAIRWISE),
    ("parboil", "nbody", w_nbody, _PAIRWISE),
    ("misc", "blackscholes", w_blackscholes, _SIZES),
    ("misc", "attention", w_attention_small, _SIZES),
    ("misc", "softmax_xent", w_softmax_xent, _PAIRWISE),
]

# the reference's growth toward the paper's 189-kernel diversity
_GROWTH_REGISTRY = [
    ("polybench", "cholesky", w_cholesky, _SIZES),
    ("polybench", "trisolv", w_trisolv, _SIZES),
    ("polybench", "ludcmp", w_ludcmp, _SIZES),
    ("polybench", "gemver", w_gemver, _SIZES),
    ("polybench", "symm", w_symm, _SIZES),
    ("polybench", "trmm", w_trmm, _SIZES),
    ("polybench", "doitgen", w_doitgen, _CUBIC),
    ("polybench", "jacobi1d", w_jacobi1d, _SIZES),
    ("polybench", "heat3d", w_heat3d, _CUBIC),
    ("polybench", "adi", w_adi, _SIZES),
    ("polybench", "floyd_warshall", w_floyd_warshall, _SIZES),
    ("polybench", "deriche", w_deriche, _SIZES),
    ("rodinia", "pathfinder", w_pathfinder, _SIZES),
    ("rodinia", "hotspot3d", w_hotspot3d, _CUBIC),
    ("rodinia", "gaussian", w_gaussian, _SIZES),
    ("rodinia", "streamcluster", w_streamcluster, _PAIRWISE),
    ("rodinia", "cfd", w_cfd, _SIZES),
    ("rodinia", "lavamd", w_lavamd, _PAIRWISE),
    ("rodinia", "nn", w_nn, _PAIRWISE),
    ("rodinia", "dwt2d", w_dwt2d, _SIZES),
    ("rodinia", "btree", w_btree, _SIZES),
    ("rodinia", "leukocyte", w_leukocyte, _SIZES),
    ("rodinia", "bilateral", w_bilateral, _SIZES),
    ("shoc", "s3d", w_s3d, _PAIRWISE),
    ("shoc", "qtc", w_qtc, _PAIRWISE),
    ("shoc", "neuralnet", w_neuralnet, _PAIRWISE),
    ("shoc", "devicememory", w_devmem, _SIZES),
    ("shoc", "fft2d", w_fft2d, _SIZES),
    ("parboil", "mriq", w_mriq, _PAIRWISE),
    ("parboil", "sad", w_sad, _SIZES),
    ("parboil", "stencil3d", w_stencil3d, _CUBIC),
    ("parboil", "mri_gridding", w_gridding, _SIZES),
    ("parboil", "spmv_jds", w_spmv_jds, _PAIRWISE),
    ("misc", "layernorm", w_layernorm, _PAIRWISE),
    ("misc", "gelu_mlp", w_gelu_mlp, _PAIRWISE),
    ("misc", "embedding_bag", w_embedding_bag, _PAIRWISE),
    ("misc", "topk_sampling", w_topk_sampling, _PAIRWISE),
    ("misc", "moe_router", w_moe_router, _PAIRWISE),
    ("misc", "paged_kv_gather", w_paged_kv_gather, _PAIRWISE),
]

_REGISTRY = _SEED_REGISTRY + _GROWTH_REGISTRY

#: the paper's four benchmark families (misc holds beyond-paper ML kernels)
FAMILIES = ("parboil", "rodinia", "polybench", "shoc")


def kernel_names(registry=None) -> list[tuple[str, str]]:
    """Distinct (app, kernel) pairs, registry order."""
    return [(app, kernel) for app, kernel, _, _ in
            (registry if registry is not None else _REGISTRY)]


def seed_kernel_names() -> set[tuple[str, str]]:
    """The seed suite's kernel identities, which the coverage metric scores
    the grown suite against."""
    return set(kernel_names(_SEED_REGISTRY))


def _workload_seed(app: str, kernel: str, sz: str) -> int:
    """Stable per-workload seed component: crc32 is process- and
    platform-independent (the builtin ``hash`` is salted per interpreter),
    so suite generation is byte-identical everywhere."""
    return zlib.crc32(f"{app}/{kernel}/{sz}".encode()) & 0xFFFF


def suite(sizes=("s", "m", "l", "xl"), seed: int = 0, registry=None,
          device="cuda") -> list[Workload]:
    """The workloads at ``sizes``, their inputs on ``device`` (the card
    unless the caller asks for ``"cpu"``)."""
    dev = resolve_device(device)
    out = []
    for app, kernel, maker, size_map in (registry if registry is not None
                                         else _REGISTRY):
        for sz in sizes:
            n = size_map[sz]
            fn, args, work = maker(n, _rng((seed, _workload_seed(app, kernel,
                                                                 sz))))
            out.append(Workload(app=app, kernel=kernel, variant=sz, fn=fn,
                                args=tuple(torch.from_numpy(a).to(dev)
                                           for a in args),
                                work_items=work))
    return out


# ------------------------------------------------- feature-space coverage

def feature_coverage(X, *, bins: int = 8, ref=None) -> dict:
    """Feature-space coverage of a sample set (a numpy copy of the
    reference's): each feature axis log1p-compressed and split into
    ``bins`` equal intervals over the reference set's range (``ref``,
    default ``X``). ``feature_occupancy`` is the mean share of 1-D bins
    occupied, ``pairwise`` the mean share of ``bins x bins`` cells occupied
    over feature pairs, ``score`` the mean of the two, in [0, 1]."""
    X = np.asarray(X, dtype=np.float64)
    if X.ndim != 2 or X.shape[0] == 0:
        raise ValueError("X must be a non-empty (n_samples, n_features)")
    R = X if ref is None else np.asarray(ref, dtype=np.float64)
    LX, LR = np.log1p(np.abs(X)), np.log1p(np.abs(R))
    lo, hi = LR.min(axis=0), LR.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    Z = np.clip((LX - lo) / span, 0.0, 1.0 - 1e-12)
    cells = np.floor(Z * bins).astype(np.int64)          # (n, F)
    n, F_ = cells.shape
    per_feature = [len(np.unique(cells[:, j])) / bins for j in range(F_)]
    pair_scores = []
    for i in range(F_):
        for j in range(i + 1, F_):
            occupied = len(np.unique(cells[:, i] * bins + cells[:, j]))
            pair_scores.append(occupied / (bins * bins))
    occupancy = float(np.mean(per_feature))
    pairwise = float(np.mean(pair_scores)) if pair_scores else occupancy
    return {"bins": bins, "n_samples": int(n), "n_features": int(F_),
            "per_feature": [float(v) for v in per_feature],
            "feature_occupancy": occupancy, "pairwise": pairwise,
            "score": float(0.5 * (occupancy + pairwise))}
