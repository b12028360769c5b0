// Chunked SSD scan (Mamba2) on Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mamba/kernel.py::_ssd_kernel
// (launched by ssd_scan_kernel). That kernel walks a sequential grid axis of
// chunks and carries the state h in VMEM scratch from one grid step to the
// next; GPU blocks run in parallel and in no order.
//
// What it computes, per (b, h), for the recurrence
//     h_t = exp(alog_t) h_{t-1} + B_t x_t^T,   y_t = C_t^T h_t
// (h: N x P, B_t/C_t: N, x_t: P), chunk by chunk of L steps with the
// in-chunk cumulative log-decay cs:
//     y[s]  = sum_{t<=s} exp(cs[s]-cs[t]) (C[s].B[t]) x[t] + exp(cs[s]) C[s] h
//     h    <- exp(cs[L-1]) h + B^T (x * exp(cs[L-1]-cs))
// from h0 (or 0). B and C are shared across heads (one state group): they
// are indexed by b alone. x, B and C are f32 or bf16, alog is f32; sums run
// in f32; y goes out in x's dtype, h in f32. x, alog, B and C are read
// through the strides the caller passes (x as (Bsz, S, H, P) with P
// contiguous), y is written contiguous (Bsz, S, H, P), so no transposed copy
// is made around the call. A ragged last chunk is masked on load (zero x,
// B, C and alog), which is exact: the padded steps multiply h by exp(0) = 1
// and add nothing. The causal mask is applied before exp: for t > s the
// exponent is positive and could overflow, and inf * 0 would give NaN.
//
// What bounds it: at the serving shape (Bsz 4, S 512, H 80, P 64, N 64,
// bf16) and the training shape (2 x 1024) the bytes, x, y, B, C, alog and
// h: about 48 MB, 14 us at 3.35 TB/s, against about 8 GFLOP of chunk-local
// products (8 us at the bf16 tensor-core rate).
//
// Two kernels, one per entry point:
//
// ssd_scan_bf16 -> three passes, the one the model's serving and training
// paths run (the SSD algorithm, Dao & Gu 2024, arXiv:2405.21060, §6):
//   1. ssd_chunk_state_kernel, per (b, chunk, head group): cs, and the
//      chunk's state contribution B^T (w x), w = exp(cs[L-1] - cs);
//   2. ssd_state_pass_kernel, per element of (b, h, N, P): the short walk
//      over the chunks, h_in[c] = exp(cs_{c-1}[L-1]) h_in[c-1] + state[c-1]
//      from h0, and the final h;
//   3. ssd_chunk_out_kernel, per (b, chunk, head group):
//      y = ((C B^T) o decay mask) x + exp(cs) o (C h_in).
// Its design:
//   * Chunk-level parallelism: passes 1 and 3 have Bsz x chunks x head
//     groups blocks, the head group sized so that the grid fills the card's
//     resident slots (2 blocks of 256 threads an SM) in one wave: 256
//     blocks of 5 heads at both main-path shapes. The per-chunk states and
//     h_in, (Bsz, H, chunks, N, P), live in a workspace the wrapper
//     allocates; pass 1 writes cs, passes 2 and 3 read those bits.
//   * C B^T does not depend on the head: each warp holds the C fragments of
//     its 16 rows in registers for all the block's heads, and makes each
//     16 x 16 tile of C B^T (t <= s only) on the tensor cores where a head's
//     product needs it, then applies that head's decay mask. Keeping all of
//     C B^T in registers across the heads instead took 64 more registers a
//     thread, which under the 2-blocks-an-SM cap spilled 512 bytes a thread
//     to L2 (2 x 111 KB of shared memory leave L1 little room) and made
//     pass 3 1.6x slower (PERF.md, PR 14).
//   * Every product on the tensor cores (mma.sync.m16n8k16, bf16 operands,
//     f32 accumulators, ldmatrix fragments from shared memory rows padded to
//     72 elements). C B^T takes the bf16 inputs as they are. Each operand
//     that is an f32 intermediate (w x, h_in, the decayed G) goes in as a
//     bf16 hi + lo pair, two products, so y and h keep f32-level accuracy
//     (2^-16 relative per operand): the decayed G is built from the G0
//     accumulators in registers, straight into A fragments.
//   * The next head's x, h_in and cs tiles arrive by cp.async 16-byte copies
//     (zero fill past S, N, P) while this head's products run.
//
// ssd_scan_f32 -> ssd_chunk_kernel, the f32 checks' kernel (no main path
// runs f32): one block per (batch, head) walking its chunks in a loop with
// h in registers and shared memory, every product on the fp32 CUDA cores
// from shared memory (256 threads in a 16 x 16 layout, each owning a
// register tile of G = C B^T, y and h; B and C stored transposed). The
// tensor cores would take f32 only as tf32, which keeps 10 mantissa bits
// and would break the reference's f32 tolerance (rtol 2e-4).
//
// Determinism: no atomics; every sum runs in a fixed order (the head group
// does not change any head's arithmetic), so repeat calls give the same
// bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 128;                 // chunk length
constexpr int kMaxN = 64;                  // state size
constexpr int kMaxP = 64;                  // head dim
constexpr int kLS = kMaxL + 1;             // row stride of B^T, C^T
constexpr int kGS = kMaxL + 16;            // row stride of G
constexpr int kSmemFloats = 2 * kMaxN * kLS + kMaxL * kMaxP + kMaxL * kGS +
                            kMaxN * kMaxP + 3 * kMaxL + 1;
constexpr int kSmemBytes = kSmemFloats * 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ alog,
                 const T* __restrict__ Bm, const T* __restrict__ Cm,
                 const float* __restrict__ h0, T* __restrict__ y,
                 float* __restrict__ h_out, int S, int H, int P, int N, int L,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long a_sb, long long a_ss, long long a_sh,
                 long long b_sb, long long b_ss,
                 long long c_sb, long long c_ss) {
  extern __shared__ float smem[];
  float* Ct = smem;                         // (N, kLS): C^T of the chunk
  float* Bt = Ct + kMaxN * kLS;             // (N, kLS): B^T of the chunk
  float* xs = Bt + kMaxN * kLS;             // (L, kMaxP)
  float* G = xs + kMaxL * kMaxP;            // (L, kGS): masked, decayed C B^T
  float* hs = G + kMaxL * kGS;              // (N, kMaxP): h entering the chunk
  float* cs = hs + kMaxN * kMaxP;           // (L) cumsum of alog
  float* ecs = cs + kMaxL;                  // (L) exp(cs)
  float* w = ecs + kMaxL;                   // (L) exp(cs[L-1] - cs)
  float* last = w + kMaxL;                  // cs[L-1]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* xb = x + b * x_sb + h * x_sh;
  const float* ab = alog + b * a_sb + h * a_sh;
  const T* Bb = Bm + b * b_sb;
  const T* Cb = Cm + b * c_sb;

  // this thread's tile of h: n = ty + 16 i, p = tx + 16 j
  float hreg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = ty + 16 * i, p = tx + 16 * j;
      float v = 0.f;
      if (h0 != nullptr && n < N && p < P)
        v = h0[((static_cast<long long>(b) * H + h) * N + n) * P + p];
      hreg[i][j] = v;
      hs[n * kMaxP + p] = v;
    }
  }

  const int nchunks = (S + L - 1) / L;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * L;
    __syncthreads();  // the last chunk's readers are done; hs is written

    // ---- load the chunk (zero past S: exact padding)
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int s = idx / P, p = idx % P, t = t0 + s;
      xs[s * kMaxP + p] = t < S ? to_f32(xb[t * x_ss + p]) : 0.f;
    }
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int s = idx / N, n = idx % N, t = t0 + s;
      Bt[n * kLS + s] = t < S ? to_f32(Bb[t * b_ss + n]) : 0.f;
      Ct[n * kLS + s] = t < S ? to_f32(Cb[t * c_ss + n]) : 0.f;
    }
    if (tid < 32) {  // cumsum of alog over the chunk: one warp, 4 steps a lane
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = 4 * tid + k, t = t0 + s;
        run += (s < L && t < S) ? ab[t * a_ss] : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - run;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = 4 * tid + k;
        if (s < L) {
          const float cv = excl + v[k];
          cs[s] = cv;
          ecs[s] = expf(cv);
          w[s] = expf(total - cv);
        }
      }
      if (tid == 0) *last = total;
    }
    __syncthreads();

    // ---- G[s][t] = (t <= s) ? exp(cs[s] - cs[t]) * C[s].B[t] : 0
    {
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = Ct[n * kLS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = Bt[n * kLS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 16 * i;
        if (s >= L) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int t = tx + 16 * j;
          if (t >= L) continue;
          // mask BEFORE exp: cs[s] - cs[t] > 0 for t > s and may overflow
          G[s * kGS + t] = t <= s ? acc[i][j] * expf(cs[s] - cs[t]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = exp(cs) * (C h) + G x, this thread's rows s = ty + 16 i and
    //      columns p = tx + 16 j
    {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], hv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) cv[i] = Ct[n * kLS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv[j] = hs[n * kMaxP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv[i], hv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 16 * i;
        const float e = s < L ? ecs[s] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      for (int t = 0; t < L; ++t) {
        float gv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) gv[i] = G[(ty + 16 * i) * kGS + t];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[t * kMaxP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = ty + 16 * i, t = t0 + s;
        if (s >= L || t >= S) continue;
        T* yrow = y + ((static_cast<long long>(b) * S + t) * H + h) * P;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) store(yrow + p, acc[i][j]);
        }
      }
    }

    // ---- h <- exp(cs[L-1]) h + B^T (x * exp(cs[L-1] - cs))
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int t = 0; t < L; ++t) {
        const float wt = w[t];
        float bv[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) bv[i] = Bt[(ty + 16 * i) * kLS + t] * wt;
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = xs[t * kMaxP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(bv[i], xv[j], acc[i][j]);
      }
      const float decay = expf(*last);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hreg[i][j] = fmaf(decay, hreg[i][j], acc[i][j]);
    }
    __syncthreads();  // every read of hs for this chunk is done
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        hs[(ty + 16 * i) * kMaxP + tx + 16 * j] = hreg[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = ty + 16 * i;
    if (n >= N) continue;
    float* hrow = h_out + ((static_cast<long long>(b) * H + h) * N + n) * P;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) hrow[p] = hreg[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const float* alog, const void* Bm, const void* Cm,
           const float* h0, void* y, float* h_out, int batch, int S, int H,
           int P, int N, int chunk, long long x_sb, long long x_ss,
           long long x_sh, long long a_sb, long long a_ss, long long a_sh,
           long long b_sb, long long b_ss, long long c_sb, long long c_ss,
           void* stream) {
  if (batch < 1 || S < 1 || H < 1 || batch > 65535 || P < 1 || P > kMaxP ||
      N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, batch);
  ssd_chunk_kernel<T><<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), alog, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), h0, static_cast<T*>(y), h_out, S, H, P, N,
      chunk, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, c_sb, c_ss);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- bf16 ---
//
// Three passes (the SSD algorithm of Dao & Gu 2024, arXiv:2405.21060, §6),
// each block owning one (batch, chunk, group of hg heads); tiles are the
// chunk padded to kT = 128 rows and N, P padded to kW = 64 columns with
// zeros (exact: padded steps have zero inputs and zero log-decay).

using bf16 = __nv_bfloat16;

constexpr int kT = 128;                    // tile rows: the largest chunk
constexpr int kW = 64;                     // tile columns: N and P at most
constexpr int kRS = kW + 8;                // row stride: conflict-free ldmatrix
constexpr int kTile = kT * kRS;            // a (kT, kW) bf16 tile
constexpr int kStateTile = kW * kRS;       // a (kW, kW) bf16 tile
constexpr int kPassThreads = 256;          // 8 warps
constexpr int kStateSmem = 5 * kTile * 2 + 2 * kT * 4;
constexpr int kOutSmem = 4 * kTile * 2 + 4 * kStateTile * 2 + 2 * kT * 4;
static_assert(kT == kMaxL && kW == kMaxN && kW == kMaxP,
              "the bf16 tiles hold the largest chunk, state and head dim");

// Rows [0, ROWS) of a (.., kW) tile from a row-major source with row stride
// ``rs``: element (r, c) is src[r rs + c] where r < row_limit and
// c < col_limit, else 0. ``vec``: col_limit % 8 == 0 and every row start
// 16-byte aligned, so 16-byte cp.async copies (zero fill outside); else
// element by element.
template <int ROWS>
__device__ __forceinline__ void load64(bf16* dst, const bf16* src,
                                       long long rs, int row_limit,
                                       int col_limit, bool vec, int tid) {
  if (vec) {
    for (int idx = tid; idx < ROWS * (kW / 8); idx += kPassThreads) {
      const int r = idx / (kW / 8), c = 8 * (idx % (kW / 8));
      const bool in = r < row_limit && c < col_limit;
      tc::cp_async16(dst + r * kRS + c, in ? src + r * rs + c : src,
                     in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < ROWS * kW; idx += kPassThreads) {
      const int r = idx / kW, c = idx % kW;
      dst[r * kRS + c] = r < row_limit && c < col_limit
                             ? src[r * rs + c] : __float2bfloat16(0.f);
    }
  }
}

// One warp: the cumsum cs of the chunk's log-decay (rows >= ``rows`` add
// 0), exp(cs[kT-1] - cs) into ``wv``, cs into ``csm`` and ``cs_out``; the
// same fixed order as the f32 kernel's scan.
__device__ __forceinline__ void chunk_cumsum(const float* a, long long a_ss,
                                             int rows, int lane, float* csm,
                                             float* wv, float* cs_out) {
  float v[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = 4 * lane + k;
    run += s < rows ? a[s * a_ss] : 0.f;
    v[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  const float excl = incl - run;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = 4 * lane + k;
    const float cv = excl + v[k];
    csm[s] = cv;
    wv[s] = expf(total - cv);
    cs_out[s] = cv;
  }
}

// Pass 1, per (b, chunk c, head h of the block's group):
//     cs = cumsum(alog over the chunk),  w = exp(cs[L-1] - cs)
//     state[b, h, c] = B^T (w * x)            (N x P, f32)
// B^T from the chunk's B tile (exact bf16), w * x as a bf16 hi + lo pair:
// two tensor-core products. cs goes to ``cs_out`` for passes 2 and 3.
__global__ void __launch_bounds__(kPassThreads, 2)
ssd_chunk_state_kernel(const bf16* __restrict__ x,
                       const float* __restrict__ alog,
                       const bf16* __restrict__ Bm, float* __restrict__ states,
                       float* __restrict__ cs_out, int S, int H, int P, int N,
                       int L, int nck, int hg, int vec,
                       long long x_sb, long long x_ss, long long x_sh,
                       long long a_sb, long long a_ss, long long a_sh,
                       long long b_sb, long long b_ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);   // (kT, kRS)
  bf16* xs = Bs + kTile;                           // 2 stages
  bf16* wh = xs + 2 * kTile;                       // w * x, hi
  bf16* wl = wh + kTile;                           // w * x, lo
  float* csm = reinterpret_cast<float*>(wl + kTile);
  float* wv = csm + kT;

  const int c = blockIdx.x, b = blockIdx.z;
  const int h_first = blockIdx.y * hg, h_end = min(H, h_first + hg);
  const int t0 = c * L, rows = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mt = warp % 4, ng = warp / 4;  // rows n 16 mt.., columns p 32 ng..

  const bf16* xc = x + b * x_sb + t0 * x_ss;
  load64<kT>(Bs, Bm + b * b_sb + t0 * b_ss, b_ss, rows, N, vec, tid);
  load64<kT>(xs, xc + h_first * x_sh, x_ss, rows, P, vec, tid);
  tc::cp_async_commit();

  for (int h = h_first, i = 0; h < h_end; ++h, ++i) {
    const bf16* xt = xs + (i & 1) * kTile;
    if (h + 1 < h_end)
      load64<kT>(xs + ((i + 1) & 1) * kTile, xc + (h + 1) * x_sh, x_ss, rows,
                 P, vec, tid);
    tc::cp_async_commit();
    const long long bhc = (static_cast<long long>(b) * H + h) * nck + c;
    if (warp == 0)
      chunk_cumsum(alog + b * a_sb + t0 * a_ss + h * a_sh, a_ss, rows, lane,
                   csm, wv, cs_out + bhc * kT);
    tc::cp_async_wait<1>();                // this head's x has landed
    __syncthreads();

    for (int idx = tid; idx < kT * kW; idx += kPassThreads) {
      const int s = idx / kW, p = idx % kW;
      tc::split_bf16(wv[s] * __bfloat162float(xt[s * kRS + p]),
                     wh[s * kRS + p], wl[s * kRS + p]);
    }
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {  // 16 steps of the chunk a step
      if (kk * 16 >= rows) break;           // the rest is zero padding
      uint32_t a[4];
      tc::ldsm_x4_trans(a, Bs + (kk * 16 + lane % 8 + (lane / 16) * 8) * kRS +
                               mt * 16 + ((lane / 8) % 2) * 8);
      const int row = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int col = ng * 32 + np * 16 + (lane / 16) * 8;
        uint32_t bh[4], bl[4];
        tc::ldsm_x4_trans(bh, wh + row * kRS + col);
        tc::ldsm_x4_trans(bl, wl + row * kRS + col);
        tc::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
        tc::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
        tc::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
        tc::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
      }
    }
    float* st = states + bhc * N * P;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = mt * 16 + g + 8 * r, p = ng * 32 + 8 * j + 2 * t4;
        if (n >= N) continue;
        if (p < P) st[n * P + p] = acc[j][2 * r];
        if (p + 1 < P) st[n * P + p + 1] = acc[j][2 * r + 1];
      }
    __syncthreads();                       // xs, wh, wl, csm, wv are free
  }
}

// Pass 2, one thread per element (b, h, n, p) of the state, walking the
// chunks in order from h0 (or 0):
//     h_in[c] = h;   h = exp(cs[c][kT-1]) h + state[c]
// h_in goes out as a bf16 hi + lo pair for pass 3's products; the last h
// is the final state.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const float* __restrict__ states,
                      const float* __restrict__ cs,
                      const float* __restrict__ h0, bf16* __restrict__ hin_hi,
                      bf16* __restrict__ hin_lo, float* __restrict__ h_out,
                      long long total, int NP, int nck) {
  const long long e = static_cast<long long>(blockIdx.x) * kPassThreads +
                      threadIdx.x;
  if (e >= total) return;
  const long long bh = e / NP;
  const int idx = static_cast<int>(e % NP);
  float hv = h0 != nullptr ? h0[e] : 0.f;
  for (int c = 0; c < nck; ++c) {
    const long long off = (bh * nck + c) * NP + idx;
    const float st = states[off];
    tc::split_bf16(hv, hin_hi[off], hin_lo[off]);
    hv = fmaf(expf(cs[(bh * nck + c) * kT + kT - 1]), hv, st);
  }
  h_out[e] = hv;
}

// Pass 3, per (b, chunk c, head h of the block's group), each warp its 16
// rows s:
//     y[s] = exp(cs[s]) (C h_in)[s] + sum_{t<=s} G0[s,t] exp(cs[s]-cs[t]) x[t]
// with G0 = C B^T (exact bf16 inputs, f32 sums) made tile by tile from the
// warp's C fragments (registers, loaded once per block) and B. C h_in with
// h_in as its hi + lo pair; the decayed G (f32) as a hi + lo pair of A
// fragments made in registers, masked before exp; x exact bf16. The next
// head's x, h_in and cs arrive through cp.async while this head's products
// run.
__global__ void __launch_bounds__(kPassThreads, 2)
ssd_chunk_out_kernel(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ Cm,
                     const bf16* __restrict__ hin_hi,
                     const bf16* __restrict__ hin_lo,
                     const float* __restrict__ cs, bf16* __restrict__ y,
                     int S, int H, int P, int N, int L, int nck, int hg,
                     int vec, long long x_sb, long long x_ss, long long x_sh,
                     long long b_sb, long long b_ss, long long c_sb,
                     long long c_ss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);   // (kT, kRS)
  bf16* Bs = Cs + kTile;                           // (kT, kRS)
  bf16* xs = Bs + kTile;                           // 2 stages
  bf16* hh = xs + 2 * kTile;                       // 2 stages of h_in hi
  bf16* hl = hh + 2 * kStateTile;                  // 2 stages of h_in lo
  float* csm = reinterpret_cast<float*>(hl + 2 * kStateTile);  // 2 x kT

  const int c = blockIdx.x, b = blockIdx.z;
  const int h_first = blockIdx.y * hg, h_end = min(H, h_first + hg);
  const int t0 = c * L, rows = min(L, S - t0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const bool live = warp * 16 < rows;      // else all 16 rows are padding
  const int s0 = warp * 16 + g;            // this lane's rows: s0, s0 + 8

  const bf16* xc = x + b * x_sb + t0 * x_ss;
  auto load_head = [&](int h, int stage) {
    const long long bhc = (static_cast<long long>(b) * H + h) * nck + c;
    load64<kT>(xs + stage * kTile, xc + h * x_sh, x_ss, rows, P, vec, tid);
    load64<kW>(hh + stage * kStateTile, hin_hi + bhc * N * P, P, N, P, vec,
               tid);
    load64<kW>(hl + stage * kStateTile, hin_lo + bhc * N * P, P, N, P, vec,
               tid);
    if (tid < kT / 4)                      // cs: 32 pieces of 16 bytes
      tc::cp_async16(csm + stage * kT + 4 * tid, cs + bhc * kT + 4 * tid, 16);
  };
  load64<kT>(Cs, Cm + b * c_sb + t0 * c_ss, c_ss, rows, N, vec, tid);
  load64<kT>(Bs, Bm + b * b_sb + t0 * b_ss, b_ss, rows, N, vec, tid);
  load_head(h_first, 0);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();

  // C fragments of this warp's 16 rows, for every product with C
  uint32_t cf[kW / 16][4];
#pragma unroll
  for (int kk = 0; kk < kW / 16; ++kk)
    tc::ldsm_x4(cf[kk], Cs + (warp * 16 + lane % 16) * kRS + kk * 16 +
                            (lane / 16) * 8);

  for (int h = h_first, i = 0; h < h_end; ++h, ++i) {
    const int cur = i & 1;
    if (h + 1 < h_end) load_head(h + 1, cur ^ 1);
    tc::cp_async_commit();
    if (live) {
      const float* csr = csm + cur * kT;
      const bf16* xt = xs + cur * kTile;
      const bf16* ht = hh + cur * kStateTile;
      const bf16* lt = hl + cur * kStateTile;
      float acc[kW / 8][4];
#pragma unroll
      for (int j = 0; j < kW / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

      // ---- C h_in, then each row times exp(cs[s])
#pragma unroll
      for (int kk = 0; kk < kW / 16; ++kk) {
        const uint32_t* a = cf[kk];
        const int row = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int np = 0; np < kW / 16; ++np) {
          const int col = np * 16 + (lane / 16) * 8;
          uint32_t bh[4], bl[4];
          tc::ldsm_x4_trans(bh, ht + row * kRS + col);
          tc::ldsm_x4_trans(bl, lt + row * kRS + col);
          tc::mma_bf16(acc[2 * np], a, bh[0], bh[1]);
          tc::mma_bf16(acc[2 * np], a, bl[0], bl[1]);
          tc::mma_bf16(acc[2 * np + 1], a, bh[2], bh[3]);
          tc::mma_bf16(acc[2 * np + 1], a, bl[2], bl[3]);
        }
      }
      const float cs0 = csr[s0], cs1 = csr[s0 + 8];
      const float e0 = expf(cs0), e1 = expf(cs1);
#pragma unroll
      for (int j = 0; j < kW / 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }

      // ---- + (G0 * decay, masked before exp) x, 16 steps t at a time
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        if (kk > warp) break;              // t > s: masked to 0
        float g0[2][4] = {};               // C B^T, columns t = 16 kk..
#pragma unroll
        for (int kn = 0; kn < kW / 16; ++kn) {
          uint32_t bb[4];
          tc::ldsm_x4(bb, Bs + (kk * 16 + lane % 8 + (lane / 16) * 8) * kRS +
                              kn * 16 + ((lane / 8) % 2) * 8);
          tc::mma_bf16(g0[0], cf[kn], bb[0], bb[1]);
          tc::mma_bf16(g0[1], cf[kn], bb[2], bb[3]);
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = jj, tb = kk * 16 + jj * 8 + 2 * t4;
          const float ct0 = csr[tb], ct1 = csr[tb + 1];
          const float v00 = tb <= s0 ? g0[j][0] * expf(cs0 - ct0) : 0.f;
          const float v01 = tb + 1 <= s0 ? g0[j][1] * expf(cs0 - ct1) : 0.f;
          const float v10 = tb <= s0 + 8 ? g0[j][2] * expf(cs1 - ct0) : 0.f;
          const float v11 =
              tb + 1 <= s0 + 8 ? g0[j][3] * expf(cs1 - ct1) : 0.f;
          tc::split_pack(v00, v01, ah[2 * jj], al[2 * jj]);
          tc::split_pack(v10, v11, ah[2 * jj + 1], al[2 * jj + 1]);
        }
        const int row = kk * 16 + lane % 8 + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int np = 0; np < kW / 16; ++np) {
          uint32_t bx[4];
          tc::ldsm_x4_trans(bx, xt + row * kRS + np * 16 + (lane / 16) * 8);
          tc::mma_bf16(acc[2 * np], ah, bx[0], bx[1]);
          tc::mma_bf16(acc[2 * np], al, bx[0], bx[1]);
          tc::mma_bf16(acc[2 * np + 1], ah, bx[2], bx[3]);
          tc::mma_bf16(acc[2 * np + 1], al, bx[2], bx[3]);
        }
      }

      // ---- y, contiguous (Bsz, S, H, P)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int s = s0 + 8 * r;
        if (s >= rows) continue;
        bf16* yrow = y + ((static_cast<long long>(b) * S + t0 + s) * H + h) * P;
#pragma unroll
        for (int j = 0; j < kW / 8; ++j) {
          const int p = 8 * j + 2 * t4;
          const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
          if (vec) {                       // P % 8 == 0: p and p + 1 < P
            if (p < P)
              *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
                  __floats2bfloat162_rn(v0, v1);
          } else {
            if (p < P) yrow[p] = __float2bfloat16(v0);
            if (p + 1 < P) yrow[p + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
    tc::cp_async_wait<0>();                // the next head has landed ...
    __syncthreads();                       // ... and this stage is free
  }
}

// Workspace of one bf16 call, each part 256-byte aligned: the per-chunk
// states (f32), h_in hi and lo (bf16), all (Bsz, H, nck, N, P), and the
// per-chunk cumsums (Bsz, H, nck, kT) f32. Offsets in bytes; the last is
// the size.
struct Layout {
  long long hin_hi, hin_lo, cs, bytes;
};

Layout layout(int batch, int S, int H, int P, int N, int chunk) {
  auto up = [](long long n) { return (n + 255) / 256 * 256; };
  const long long nck = (S + chunk - 1) / chunk;
  const long long elems = static_cast<long long>(batch) * H * nck * N * P;
  Layout l;
  l.hin_hi = up(elems * 4);
  l.hin_lo = l.hin_hi + up(elems * 2);
  l.cs = l.hin_lo + up(elems * 2);
  l.bytes = l.cs + up(static_cast<long long>(batch) * H * nck * kT * 4);
  return l;
}

// Once per process: the two passes' shared-memory limits, then how many
// blocks of pass 3 the card holds at once (its resident slots). Returns 0
// or a CUDA error.
int configure(int* slots) {
  static int cached = 0;
  if (cached > 0) {
    *slots = cached;
    return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStateSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_out_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kOutSmem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ssd_chunk_out_kernel, kPassThreads, kOutSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cached = sms * per_sm;
  *slots = cached;
  return 0;
}

int launch_bf16(const void* x, const float* alog, const void* Bm,
                const void* Cm, const float* h0, void* y, float* h_out,
                int batch, int S, int H, int P, int N, int chunk,
                long long x_sb, long long x_ss, long long x_sh,
                long long a_sb, long long a_ss, long long a_sh,
                long long b_sb, long long b_ss, long long c_sb, long long c_ss,
                void* workspace, cudaStream_t stream) {
  int slots = 0;
  const int err0 = configure(&slots);
  if (err0 != 0) return err0;
  // heads per block: enough blocks to fill the resident slots (2 blocks of
  // 256 threads an SM on an H100) in one wave, not more
  const int nck = (S + chunk - 1) / chunk;
  const long long want =
      (static_cast<long long>(H) * batch * nck + slots - 1) / slots;
  const int hg = static_cast<int>(std::min<long long>(want, H));
  const int groups = (H + hg - 1) / hg;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay = layout(batch, S, H, P, N, chunk);
  char* w = static_cast<char*>(workspace);
  float* states = reinterpret_cast<float*>(w);
  bf16* hin_hi = reinterpret_cast<bf16*>(w + lay.hin_hi);
  bf16* hin_lo = reinterpret_cast<bf16*>(w + lay.hin_lo);
  float* cs = reinterpret_cast<float*>(w + lay.cs);
  // 16-byte copies need N, P % 8 == 0 and every row start 16-byte aligned
  bool vec = N % 8 == 0 && P % 8 == 0;
  for (long long s : {x_sb, x_ss, x_sh, b_sb, b_ss, c_sb, c_ss})
    vec = vec && s % 8 == 0;
  for (const void* p : {x, Bm, Cm, static_cast<const void*>(y)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  dim3 grid(nck, groups, batch);
  ssd_chunk_state_kernel<<<grid, kPassThreads, kStateSmem, stream>>>(
      xb, alog, Bb, states, cs, S, H, P, N, chunk, nck, hg, vec ? 1 : 0,
      x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * H * N * P;
  ssd_state_pass_kernel<<<static_cast<unsigned>(
                              (total + kPassThreads - 1) / kPassThreads),
                          kPassThreads, 0, stream>>>(
      states, cs, h0, hin_hi, hin_lo, h_out, total, N * P, nck);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_out_kernel<<<grid, kPassThreads, kOutSmem, stream>>>(
      xb, Bb, Cb, hin_hi, hin_lo, cs, static_cast<bf16*>(y), S, H, P,
      N, chunk, nck, hg, vec ? 1 : 0, x_sb, x_ss, x_sh, b_sb, b_ss, c_sb,
      c_ss);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ssd_max_chunk() { return kMaxL; }
int ssd_max_state() { return kMaxN; }
int ssd_max_head_dim() { return kMaxP; }

// Bytes of the workspace ``ssd_scan_bf16`` needs for this shape (the f32
// entry needs none).
long long ssd_workspace_bytes(int batch, int S, int H, int P, int N,
                              int chunk) {
  if (batch < 1 || S < 1 || H < 1 || P < 1 || N < 1 || chunk < 1) return 0;
  return layout(batch, S, H, P, N, chunk).bytes;
}

// Pointers are device pointers (h0 may be null: zero initial state); the
// strides are in elements. ``workspace``: ssd_workspace_bytes() bytes of
// device memory for the bf16 entry, unused by the f32 one. Returns 0 or the
// CUDA error of the launch.
int ssd_scan_f32(const void* x, const float* alog, const void* Bm,
                 const void* Cm, const float* h0, void* y, float* h_out,
                 int batch, int S, int H, int P, int N, int chunk,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long a_sb, long long a_ss, long long a_sh,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, void* workspace, void* stream) {
  (void)workspace;
  return launch<float>(x, alog, Bm, Cm, h0, y, h_out, batch, S, H, P, N,
                       chunk, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss,
                       c_sb, c_ss, stream);
}

int ssd_scan_bf16(const void* x, const float* alog, const void* Bm,
                  const void* Cm, const float* h0, void* y, float* h_out,
                  int batch, int S, int H, int P, int N, int chunk,
                  long long x_sb, long long x_ss, long long x_sh,
                  long long a_sb, long long a_ss, long long a_sh,
                  long long b_sb, long long b_ss, long long c_sb,
                  long long c_ss, void* workspace, void* stream) {
  if (batch < 1 || S < 1 || H < 1 || batch > 65535 || P < 1 || P > kMaxP ||
      N < 1 || N > kMaxN || chunk < 1 || chunk > kMaxL || workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(x, alog, Bm, Cm, h0, y, h_out, batch, S, H, P, N, chunk,
                     x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, c_sb,
                     c_ss, workspace, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
