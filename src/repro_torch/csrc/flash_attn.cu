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
//     lse[r] = ln sum_c exp(s[c]) over the valid c,  -inf where none is
// with kv_offset = Skv - Sq for the end-aligned causal mask. q, k and v are
// f32 or bf16 and are read through the strides the caller passes ((B, H, S,
// D) views with D contiguous, e.g. transposes of the model's (B, S, H, D));
// the sums and the online softmax run in f32; o goes out in q's dtype,
// written through its own strides, so no transposed copy is made around the
// call. Ragged Sq and Skv are masked on load, nothing is padded in memory.
// lse, the row log-sum-exp that a merge of attentions over several key
// shards needs (models/attention.py::merge_partials), is written only when
// the caller passes a pointer for it: f32 (B, Hq, Sq), contiguous, one
// store per row from the lane that owns the row after the row sums are
// reduced; the main loop is the same either way.
//
// Two kernels, one per entry point:
//
// flash_attn_bf16 -> flash_fwd_mma_kernel, the one the model's training path
// runs (zamba2: B 2, 32 heads, S 1024, D 80, causal). What bounds it there:
// the bytes, 42 MB of q, k, v and o (13 us at 3.35 TB/s), against 10.7
// GFLOP of products (11 us at the bf16 tensor-core rate). Its design:
//   * One warpgroup (4 warps, 16 query rows each) per 64-row query tile;
//     both products are wgmma on the tensor cores (bf16 operands, f32
//     accumulators): S = Q K^T as m64n64k16 with Q and K read from shared
//     memory through matrix descriptors, O += P V as m64n(16 DT)k16 with P
//     from registers and V from shared memory (MN-major, trans-b). The
//     scale is applied to S in f32. Shared-memory tiles use the
//     descriptors' no-swizzle layout of 8-row x 16-byte core matrices
//     (tensor_core.cuh), so D = 80 is five 16-wide steps with no padding
//     and D not a multiple of 16 is zero-filled up to 16 DT (exact).
//   * The online softmax stays in the accumulators' registers: row max and
//     row sum are 2-step xor shuffles over the 4 lanes that hold a row. P
//     goes from the S accumulators straight into the A fragments of
//     P V (two 16 x 8 accumulator tiles are one 16 x 16 A tile), as a bf16
//     hi + lo pair, two products: P itself is f32, and one bf16 P would
//     add a rounding of 2^-9 before the output's own bf16 rounding, where
//     the in-place limit (one bf16 ulp of the largest value) has no room
//     left for it (PERF.md, PR 14).
//   * K/V tiles of 64 keys arrive through a 2-stage ring of cp.async 16-byte
//     copies: the next tile's copy is in flight while this tile's products
//     run; a proxy fence makes them visible to wgmma. Keys past kv_len
//     arrive as zeros (cp.async zero-fill). Without 16-byte alignment of
//     rows and pointers the tiles load element by element.
//   * Causal: KV tiles wholly above the query tile's last row are never
//     loaded; only tiles that cross the diagonal or kv_len are masked, and
//     the query tiles are launched heaviest (last) first, so the longest
//     walks do not finish last.
//   * The masks are applied before exp and a masked p is set to 0, so a row
//     with no valid key keeps l = 0 and writes 0, never NaN.

// flash_attn_f32 -> flash_fwd_kernel, the f32 checks' kernel (no main path
// runs f32): both products on the fp32 CUDA cores from shared memory, 256
// threads in a 16 x 16 layout, each owning a 4 x 4 tile of the scores and a
// 4 x ceil(D/16) tile of the accumulator, q and k stored transposed. The
// tensor cores would take f32 only as tf32, which keeps 10 mantissa bits
// and would break the reference's f32 tolerance (rtol 2e-4).
//
// The backward is the plain version's autograd (kernels/attention/ops.py).
//
// Determinism: no atomics; every sum runs in a fixed order, so repeat calls
// give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <initializer_list>

#include "tensor_core.cuh"

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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Shared-memory floats for head dim D with DJ = ceil(D / 16) accumulator
// columns per thread.
__host__ __device__ constexpr int smem_floats(int D, int DJ) {
  return D * kQS + D * kKS + kBK * 16 * DJ + kBQ * kPS;
}

template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int group, int Sq, int Skv, int D,
                 int kv_len, int kv_offset, int causal, float scale,
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
    // m and l are the same on the 16 lanes of the row (q is pre-scaled)
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * Sq + row] =
          l[i] == 0.f ? -CUDART_INF_F : m[i] + logf(l[i]);
  }
}

template <typename T, int DJ>
int launch_dj(const void* q, const void* k, const void* v, void* o,
              float* lse, int batch, int Hq, int Hkv, int Sq, int Skv, int D,
              int kv_len, int kv_offset, int causal, float scale,
              const long long* st,
              cudaStream_t stream) {
  const int bytes = smem_floats(D, DJ) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, batch);
  flash_fwd_kernel<T, DJ><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, Hq / Hkv, Sq, Skv,
      D, kv_len, kv_offset, causal, scale, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int Hq, int Hkv, int Sq, int Skv, int D, int kv_len,
           int kv_offset, int causal, float scale, const long long* strides,
           void* stream) {
  if (batch < 1 || batch > 65535 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 ||
      Hq > 65535 || Sq < 1 || Skv < 1 || D < 1 || D > kMaxD || kv_len < 0 ||
      kv_len > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // accumulator columns per thread: the smallest instantiation holding D
  if (D <= 32)
    return launch_dj<T, 2>(q, k, v, o, lse, batch, Hq, Hkv, Sq, Skv, D,
                           kv_len, kv_offset, causal, scale, strides, s);
  if (D <= 64)
    return launch_dj<T, 4>(q, k, v, o, lse, batch, Hq, Hkv, Sq, Skv, D,
                           kv_len, kv_offset, causal, scale, strides, s);
  if (D <= 80)
    return launch_dj<T, 5>(q, k, v, o, lse, batch, Hq, Hkv, Sq, Skv, D,
                           kv_len, kv_offset, causal, scale, strides, s);
  return launch_dj<T, 8>(q, k, v, o, lse, batch, Hq, Hkv, Sq, Skv, D, kv_len,
                         kv_offset, causal, scale, strides, s);
}

// ---------------------------------------------------------------- bf16 ---

using bf16 = __nv_bfloat16;

constexpr int kMmaThreads = 128;           // one warpgroup: 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Offsets, in elements, of the 16-byte piece (row r, columns 8 c..8 c+7) of
// a 64-row tile in the layouts the wgmma descriptors read (tensor_core.cuh):
// q and k K-major, (r / 8) 16 DP + c 128 + (r % 8) 16 bytes; v MN-major
// (its rows r are the product's k), c 1024 + r 16 bytes.
template <int DP>
__device__ __forceinline__ int kmajor_off(int r, int c) {
  return (r / 8) * (8 * DP) + c * 64 + (r % 8) * 8;
}
__device__ __forceinline__ int mnmajor_off(int r, int c) {
  return c * (8 * kBK) + r * 8;
}

// One 64-row tile of a (.., S, D) bf16 tensor into shared memory: rows
// first + r for r < 64, zeros for rows >= limit and columns >= D (up to
// DP). The pieces go 8 rows at a time, so the 8 lanes of each 16-byte
// store phase hit distinct banks and a warp reads 64 contiguous bytes of 8
// rows. ``vec``: D % 8 == 0 and every row start 16-byte aligned, so 16-byte
// cp.async copies (zero fill); else element by element.
template <int DP, bool KMAJOR>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long row_stride, int first,
                                          int limit, int D, bool vec,
                                          int tid) {
  constexpr int kPieces = DP / 8;          // 16-byte pieces per row
  if (vec) {
    for (int idx = tid; idx < kBQ * kPieces; idx += kMmaThreads) {
      const int r = idx % 8 + 8 * (idx / (8 * kPieces));
      const int c = (idx / 8) % kPieces, row = first + r;
      const bool in = row < limit && 8 * c < D;
      const bf16* s = in ? src + row * row_stride + 8 * c : src;
      tc::cp_async16(dst + (KMAJOR ? kmajor_off<DP>(r, c) : mnmajor_off(r, c)),
                     s, in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kBQ * DP; idx += kMmaThreads) {
      const int r = idx / DP, col = idx % DP, row = first + r;
      const int off = KMAJOR ? kmajor_off<DP>(r, col / 8)
                             : mnmajor_off(r, col / 8);
      dst[off + col % 8] = row < limit && col < D
                               ? src[row * row_stride + col]
                               : __float2bfloat16(0.f);
    }
  }
}

// Keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// DT: the head dim padded to 16 DT (zero columns past D in shared memory).
template <int DT>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Hq, int group, int batch,
                     int Sq, int D, int kv_len, int kv_offset, int causal,
                     float scale_log2, int vec,
                     long long q_sb, long long q_sh, long long q_ss,
                     long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss,
                     long long o_sb, long long o_sh, long long o_ss) {
  constexpr int DP = 16 * DT;
  constexpr int kTile = kBQ * DP;          // elements of one tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // K-major
  bf16* Ks = Qs + kTile;                           // 2 stages, K-major
  bf16* Vs = Ks + 2 * kTile;                       // 2 stages, MN-major

  // heaviest query tiles first: the linear block id walks (b, h) fastest
  const int nq = (Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % (Hq * batch);
  const int qt = nq - 1 - static_cast<int>(blockIdx.x / (Hq * batch));
  const int h = bh % Hq, b = bh / Hq, hk = h / group;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;

  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + hk * k_sh;
  const bf16* vb = v + b * v_sb + hk * v_sh;

  // keys [0, kv_end) can be visible to some row of this tile
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, min(Sq, q0 + kBQ) + kv_offset);
  const int ntiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  float oacc[8 * DT];                      // (64, DP) over the warpgroup
#pragma unroll
  for (int i = 0; i < 8 * DT; ++i) oacc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  if (ntiles > 0) {
    load_tile<DP, true>(Qs, qb, q_ss, q0, Sq, D, vec, tid);
    load_tile<DP, true>(Ks, kb, k_ss, 0, kv_len, D, vec, tid);
    load_tile<DP, false>(Vs, vb, v_ss, 0, kv_len, D, vec, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    tc::fence_async_smem();
    __syncthreads();
  }
  const int row0 = q0 + warp * 16 + g;     // this lane's rows: row0, row0 + 8

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * kBK;
    if (t + 1 < ntiles) {                  // the next tile, into the other stage
      const int nxt = (t + 1) & 1;
      load_tile<DP, true>(Ks + nxt * kTile, kb, k_ss, k0 + kBK, kv_len, D,
                          vec, tid);
      load_tile<DP, false>(Vs + nxt * kTile, vb, v_ss, k0 + kBK, kv_len, D,
                           vec, tid);
    }
    tc::cp_async_commit();
    const bf16* Kt = Ks + (t & 1) * kTile;
    const bf16* Vt = Vs + (t & 1) * kTile;

    // ---- s = q k^T (64 x 64), wgmma over the DT 16-wide steps of D
    float s[32];
    fence_regs<32>(s);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DT; ++kk)
      tc::wgmma_m64n64_ss(s, tc::wgmma_desc(Qs + kk * 128, 128, 16 * DP),
                          tc::wgmma_desc(Kt + kk * 128, 128, 16 * DP),
                          kk > 0 ? 1 : 0);
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    fence_regs<32>(s);

    // ---- scale (log2 domain), masks before exp: only tiles that cross the
    //      diagonal or kv_len test each key. s[4 j + e]: 16 x 8 tile j.
    const bool full = k0 + kBK <= kv_len &&
                      (!causal || k0 + kBK - 1 <= q0 + kv_offset);
    uint32_t valid = 0xffffffffu;
    if (!full) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t4 + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        if (!(key < kv_len && (!causal || key <= row + kv_offset)))
          valid &= ~(1u << i);
      }
    }
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float sv = (valid >> i) & 1u ? s[i] * scale_log2 : kNeg;
      s[i] = sv;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sv);
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = (valid >> i) & 1u ? exp2f(s[i] - m[r]) : 0.f;
      s[i] = p;
      sum[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = fmaf(alpha[r], l[r], sum[r]);
#pragma unroll
    for (int i = 0; i < 8 * DT; ++i) oacc[i] *= alpha[(i >> 1) & 1];

    // ---- o += p v: p from the s registers as a bf16 hi + lo pair (A from
    //      registers), v MN-major from shared memory, 16 keys a step
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* s0 = s + 8 * kk;        // tiles 2 kk and 2 kk + 1
      tc::split_pack(s0[0], s0[1], ph[kk][0], pl[kk][0]);
      tc::split_pack(s0[2], s0[3], ph[kk][1], pl[kk][1]);
      tc::split_pack(s0[4], s0[5], ph[kk][2], pl[kk][2]);
      tc::split_pack(s0[6], s0[7], ph[kk][3], pl[kk][3]);
    }
    fence_regs<8 * DT>(oacc);
    tc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = tc::wgmma_desc(Vt + kk * 128, 128, 16 * kBK);
      tc::wgmma_rs_tb<DP>(oacc, ph[kk], dv);
      tc::wgmma_rs_tb<DP>(oacc, pl[kk], dv);
    }
    tc::wgmma_commit();
    tc::wgmma_wait<0>();
    fence_regs<8 * DT>(oacc);
    tc::cp_async_wait<0>();  // the next tile has landed ...
    tc::fence_async_smem();
    __syncthreads();         // ... and no warp still reads this stage
  }

  // ---- o = acc / l (0 where no key was valid); lse from the lane t4 == 0
  //      of each row's quad (m is in the log2 domain)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    if (lse != nullptr && t4 == 0)
      lse[(static_cast<long long>(b) * Hq + h) * Sq + row] =
          l[r] == 0.f ? -CUDART_INF_F : (m[r] + log2f(l[r])) * kLn2;
    bf16* orow = o + b * o_sb + h * o_sh + row * o_ss;
#pragma unroll
    for (int j = 0; j < 2 * DT; ++j) {
      const int d = 8 * j + 2 * t4;
      const float v0 = oacc[4 * j + 2 * r] * inv;
      const float v1 = oacc[4 * j + 2 * r + 1] * inv;
      if (vec) {                            // D % 8 == 0: d and d + 1 < D
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(v0, v1);
      } else {
        if (d < D) orow[d] = __float2bfloat16(v0);
        if (d + 1 < D) orow[d + 1] = __float2bfloat16(v1);
      }
    }
  }
}

template <int DT>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int batch, int Hq, int Hkv, int Sq, int D,
               int kv_len, int kv_offset, int causal, float scale,
               const long long* st,
               cudaStream_t stream) {
  const int bytes = 5 * kBQ * 16 * DT * static_cast<int>(sizeof(bf16));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>((Sq + kBQ - 1) / kBQ) * Hq * batch;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need D % 8 == 0 and every row start 16-byte aligned
  bool vec = D % 8 == 0;
  for (int i = 0; i < 12; ++i) vec = vec && st[i] % 8 == 0;
  for (const void* p : {q, k, v, static_cast<const void*>(o)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  flash_fwd_mma_kernel<DT><<<static_cast<unsigned>(blocks), kMmaThreads,
                             bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, Hq, Hq / Hkv,
      batch, Sq, D, kv_len, kv_offset, causal, scale * kLog2e, vec ? 1 : 0,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int batch, int Hq, int Hkv, int Sq, int Skv,
                int D, int kv_len, int kv_offset, int causal, float scale,
                const long long* strides, void* stream) {
  if (batch < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || Sq < 1 ||
      Skv < 1 || D < 1 || D > kMaxD || kv_len < 0 || kv_len > Skv)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-wide steps of D: the smallest instantiation holding D
  if (D <= 32)
    return launch_mma<2>(q, k, v, o, lse, batch, Hq, Hkv, Sq, D, kv_len,
                         kv_offset, causal, scale, strides, s);
  if (D <= 64)
    return launch_mma<4>(q, k, v, o, lse, batch, Hq, Hkv, Sq, D, kv_len,
                         kv_offset, causal, scale, strides, s);
  if (D <= 80)
    return launch_mma<5>(q, k, v, o, lse, batch, Hq, Hkv, Sq, D, kv_len,
                         kv_offset, causal, scale, strides, s);
  return launch_mma<8>(q, k, v, o, lse, batch, Hq, Hkv, Sq, D, kv_len,
                       kv_offset, causal, scale, strides, s);
}

}  // namespace

extern "C" {

int flash_max_head_dim() { return kMaxD; }

// Pointers are device pointers; ``strides`` holds 12 element strides:
// (batch, head, seq) of q, k, v and o, in that order (the head dim is
// contiguous). ``lse`` is null or an f32 (batch, Hq, Sq) contiguous buffer
// for the rows' log-sum-exp. Returns 0 or the CUDA error of the launch.
int flash_attn_f32(const void* q, const void* k, const void* v, void* o,
                   void* lse, int batch, int Hq, int Hkv, int Sq, int Skv,
                   int D, int kv_len, int kv_offset, int causal, float scale,
                   const long long* strides, void* stream) {
  return launch<float>(q, k, v, o, static_cast<float*>(lse), batch, Hq, Hkv,
                       Sq, Skv, D, kv_len, kv_offset, causal, scale, strides,
                       stream);
}

int flash_attn_bf16(const void* q, const void* k, const void* v, void* o,
                    void* lse, int batch, int Hq, int Hkv, int Sq, int Skv,
                    int D, int kv_len, int kv_offset, int causal, float scale,
                    const long long* strides, void* stream) {
  return launch_bf16(q, k, v, o, static_cast<float*>(lse), batch, Hq, Hkv,
                     Sq, Skv, D, kv_len, kv_offset, causal, scale, strides,
                     stream);
}

}  // extern "C"
