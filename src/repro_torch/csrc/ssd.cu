// Chunked SSD scan (Mamba2) on Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/mamba/kernel.py::_ssd_kernel
// (launched by ssd_scan_kernel). That kernel walks a sequential grid axis of
// chunks and carries the state h in VMEM scratch from one grid step to the
// next. GPU blocks run in no order, so here one block owns one (batch, head)
// pair and walks its chunks in a loop, keeping h in registers and shared
// memory.
//
// What it computes, per (b, h), for the recurrence
//     h_t = exp(alog_t) h_{t-1} + B_t x_t^T,   y_t = C_t^T h_t
// (h: N x P, B_t/C_t: N, x_t: P), chunk by chunk of L steps with the
// in-chunk cumulative log-decay cs:
//     y[s]  = sum_{t<=s} exp(cs[s]-cs[t]) (C[s].B[t]) x[t] + exp(cs[s]) C[s] h
//     h    <- exp(cs[L-1]) h + B^T (x * exp(cs[L-1]-cs))
// B and C are shared across heads (one state group): they are indexed by b
// alone. x, B and C are f32 or bf16, alog is f32; sums run in f32; y goes
// out in x's dtype, h in f32. x, alog, B and C are read through the strides
// the caller passes (x as (Bsz, S, H, P) with P contiguous), y is written
// contiguous (Bsz, S, H, P), so no transposed copy is made around the call.
//
// What bounds it: at the serving shape (Bsz 4, S 512, H 80, P 64, N 64,
// bf16) the bytes (x, y, B, C, alog, h: about 48 MB, 14 us at 3.35 TB/s)
// over the operations (about 8 GFLOP of chunk-local products: 8 us at the
// bf16 tensor-core rate). This first kernel does the products on the fp32
// CUDA cores from shared memory (67 TFLOP/s peak, so 120 us at best) and is
// bounded in practice by shared-memory loads and by one block per SM;
// wgmma/TMA tiles are later work.
//
// What the design does about it:
//   * 256 threads in a 16 x 16 layout; each thread owns a register tile of
//     every product (G = C B^T: 8x8, y: 8x4, h: 4x4), so each shared-memory
//     load feeds 2-4 multiply-adds.
//   * B and C are stored transposed (n-major, padded rows) and G with a
//     padded row, so the loads of a warp hit distinct banks or broadcast.
//   * The causal mask is applied before exp: for t > s the exponent is
//     positive and could overflow, and inf * 0 would give NaN.
//   * A ragged last chunk is masked on load (zero x, B, C and alog), which
//     is exact: the padded steps multiply h by exp(0) = 1 and add nothing.
//   * The in-chunk cumsum is one warp's shuffle scan, in a fixed order.
//
// Determinism: no atomics; every sum runs in a fixed order, so repeat calls
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

}  // namespace

extern "C" {

int ssd_max_chunk() { return kMaxL; }
int ssd_max_state() { return kMaxN; }
int ssd_max_head_dim() { return kMaxP; }

// Pointers are device pointers (h0 may be null: zero initial state); the
// strides are in elements. Returns 0 or the CUDA error of the launch.
int ssd_scan_f32(const void* x, const float* alog, const void* Bm,
                 const void* Cm, const float* h0, void* y, float* h_out,
                 int batch, int S, int H, int P, int N, int chunk,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long a_sb, long long a_ss, long long a_sh,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, void* stream) {
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
                  long long c_ss, void* stream) {
  return launch<__nv_bfloat16>(x, alog, Bm, Cm, h0, y, h_out, batch, S, H, P,
                               N, chunk, x_sb, x_ss, x_sh, a_sb, a_ss, a_sh,
                               b_sb, b_ss, c_sb, c_ss, stream);
}

}  // extern "C"
