// Flash attention forward on Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/attention/kernel.py::_flash_kernel
// (launched by flash_attention_kernel). That kernel walks a sequential 4th
// grid axis of KV tiles and carries the running max, normalizer and
// accumulator in VMEM scratch from one grid step to the next. GPU blocks run
// in no order, so here one block owns one (batch, q-head, query tile) and
// walks the KV tiles in a loop, keeping the running max and normalizer of
// its rows and its slice of the accumulator in registers.
//
// What it computes, per query row r of head h (kv head h / (Hq / Hkv)):
//     s[c] = (q[r] * scale) . k[c]                      over keys c
//     valid(c) = c < kv_len && (!causal || c <= r + kv_offset)
//     o[r] = sum_c softmax_valid(s)[c] v[c],   0 where no key is valid
// with kv_offset = Skv - Sq for the end-aligned causal mask. q, k and v are
// f32 or bf16 and are read through the strides the caller passes ((B, H, S,
// D) views with D contiguous, e.g. transposes of the model's (B, S, H, D));
// the sums and the online softmax run in f32; o goes out in q's dtype,
// written through its own strides, so no transposed copy is made around the
// call. Ragged Sq and Skv are masked on load, nothing is padded.
//
// What bounds it: at zamba2's training shape (B 2, 32 heads, S 1024, D 80,
// causal, bf16) the operations: about 10.7 GFLOP of products (11 us at the
// bf16 tensor-core rate) against 42 MB of q, k, v and o (13 us at 3.35
// TB/s), so the bound is the bytes, but this first kernel does the
// products on the fp32 CUDA cores from shared memory (67 TFLOP/s peak, so
// 160 us at best) and is bounded in practice by shared-memory loads.
// Tensor cores (mma.sync / wgmma), TMA loads and a backward kernel are
// later work; the backward is the plain version's autograd
// (kernels/attention/ops.py).
//
// What the design does about it:
//   * 256 threads in a 16 x 16 layout over a 64-row query tile and a
//     64-key tile; each thread owns a 4 x 4 register tile of the scores
//     (rows ty + 16 i, keys tx + 16 j) and a 4 x ceil(D/16) tile of the
//     accumulator (columns tx + 16 j), so each shared-memory load feeds 2-3
//     multiply-adds.
//   * q (scaled) and k are stored transposed (d-major, rows padded to 65) so
//     the loads of a warp broadcast or hit distinct banks; p goes through
//     shared memory between the two products.
//   * The masks are applied before exp, and a masked score's p is set to 0
//     explicitly, so a row with no valid key keeps l = 0 and writes 0 (the
//     reference kernel's l == 0 guard), never NaN.
//   * Causal: KV tiles wholly above the tile's last row are never loaded.
//   * GQA by index: q-head h reads kv head h / group; K/V are not copied.
//   * Row max and row sum are 16-lane xor-shuffle reductions; every lane of
//     a row gets the same bits.
//
// Determinism: no atomics; every sum runs in a fixed order, so repeat calls
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                    // query rows per block
constexpr int kBK = 64;                    // keys per KV tile
constexpr int kMaxD = 128;                 // head dim
constexpr int kQS = kBQ + 1;               // row stride of q^T
constexpr int kKS = kBK + 1;               // row stride of k^T
constexpr int kPS = kBK + 1;               // row stride of p
constexpr float kNeg = -1e30f;             // the reference kernel's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared-memory floats for head dim D with DJ = ceil(D / 16) accumulator
// columns per thread.
__host__ __device__ constexpr int smem_floats(int D, int DJ) {
  return D * kQS + D * kKS + kBK * 16 * DJ + kBQ * kPS;
}

template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int group,
                 int Sq, int Skv, int D, int kv_len, int kv_offset,
                 int causal, float scale,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss) {
  constexpr int VS = 16 * DJ;              // row stride of v (zero past D)
  extern __shared__ float smem[];
  float* Qt = smem;                        // (D, kQS): scaled q^T
  float* Kt = Qt + D * kQS;                // (D, kKS): k^T of the tile
  float* Vs = Kt + D * kKS;                // (kBK, VS)
  float* Ps = Vs + kBK * VS;               // (kBQ, kPS): p of the tile

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, row = q0 + r;
    Qt[d * kQS + r] = row < Sq ? to_f32(qb[row * q_ss + d]) * scale : 0.f;
  }

  // keys [0, kv_end) can be visible to some row of this tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(Sq, q0 + kBQ) + kv_offset);
  const int ntiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's readers of Kt, Vs, Ps are done
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D, key = k0 + c;
      const bool in = key < kv_len;       // keys past kv_len load as zeros
      Kt[d * kKS + c] = in ? to_f32(kb[key * k_ss + d]) : 0.f;
      Vs[c * VS + d] = in ? to_f32(vb[key * v_ss + d]) : 0.f;
    }
    for (int idx = tid; idx < kBK * (VS - D); idx += kThreads) {
      const int c = idx / (VS - D), d = D + idx % (VS - D);
      Vs[c * VS + d] = 0.f;
    }
    __syncthreads();

    // ---- s = (q scale) k^T on this thread's 4 x 4 tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qt[d * kQS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // ---- masks, then the online softmax of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool valid[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        valid[j] = key < kv_len && (!causal || key <= row + kv_offset);
        if (!valid[j]) s[i][j] = kNeg;   // mask BEFORE exp
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * kPS + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = fmaf(alpha, l[i], sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // ---- acc += p v
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * VS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
    T* orow = o + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int DJ>
int launch_dj(const void* q, const void* k, const void* v, void* o, int batch,
              int Hq, int Hkv, int Sq, int Skv, int D, int kv_len,
              int kv_offset, int causal, float scale, const long long* st,
              cudaStream_t stream) {
  const int bytes = smem_floats(D, DJ) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, batch);
  flash_fwd_kernel<T, DJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq / Hkv, Sq, Skv, D,
      kv_len, kv_offset, causal, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int Hq, int Hkv, int Sq, int Skv, int D, int kv_len, int kv_offset,
           int causal, float scale, const long long* strides, void* stream) {
  if (batch < 1 || batch > 65535 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 ||
      Hq > 65535 || Sq < 1 || Skv < 1 || D < 1 || D > kMaxD || kv_len < 0 ||
      kv_len > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // accumulator columns per thread: the smallest instantiation holding D
  if (D <= 32)
    return launch_dj<T, 2>(q, k, v, o, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                           kv_offset, causal, scale, strides, s);
  if (D <= 64)
    return launch_dj<T, 4>(q, k, v, o, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                           kv_offset, causal, scale, strides, s);
  if (D <= 80)
    return launch_dj<T, 5>(q, k, v, o, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                           kv_offset, causal, scale, strides, s);
  return launch_dj<T, 8>(q, k, v, o, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                         kv_offset, causal, scale, strides, s);
}

}  // namespace

extern "C" {

int flash_max_head_dim() { return kMaxD; }

// Pointers are device pointers; ``strides`` holds 12 element strides:
// (batch, head, seq) of q, k, v and o, in that order (the head dim is
// contiguous). Returns 0 or the CUDA error of the launch.
int flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                   int batch, int Hq, int Hkv, int Sq, int Skv, int D,
                   int kv_len, int kv_offset, int causal, float scale,
                   const long long* strides, void* stream) {
  return launch<float>(q, k, v, o, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                       kv_offset, causal, scale, strides, stream);
}

int flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                    int batch, int Hq, int Hkv, int Sq, int Skv, int D,
                    int kv_len, int kv_offset, int causal, float scale,
                    const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                               kv_offset, causal, scale, strides, stream);
}

}  // extern "C"
