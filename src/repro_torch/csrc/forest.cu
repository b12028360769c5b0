// Dense-forest inference on Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/forest/kernel.py::_forest_kernel
// (launched by forest_predict_kernel). That kernel avoids gathers: it turns
// "which feature does my node test" into one-hot MXU contractions. A GPU
// gathers cheaply, so this kernel ports the computation, not the trick.
//
// What it computes: out[b] = (1/T) * sum_t value[t, leaf(b, t)], where
// leaf(b, t) is reached from node 0 by `depth` steps of
//     i = 2i + 1 + !(feature[t, i] < 0 || x[b, feature[t, i]] <= threshold[t, i])
// over complete binary trees stored one row of N = 2^(depth+1) - 1 nodes per
// tree. The semantics are those of kernels/forest/ref.py: a NaN feature
// goes right, feature -1 goes left, and a non-finite value in a column the
// node does not test has no effect on the walk.
//
// What bounds it: memory. The compare and index work is a few integer
// operations per node, negligible next to the card's rate. The walk reads
// at most min(all tables, B*T*(depth*8 + 4)) bytes of tables: 12.6 MB for
// 512 trees at depth 10, or 2.75 MB at B = 64. At 3.35 TB/s that is 0.8 us
// at B = 64 and 3.8 us at B >= 4096. The reads are dependent gathers, so
// in practice latency, not bandwidth, is what a launch waits on.
//
// What the design does about it:
//   * Each block owns a tile of BS samples; their feature rows sit in
//     shared memory, so the per-node feature gather costs no global read.
//   * The block's 192 threads stride over trees. A thread walks its tree for
//     all BS samples level by level, so the BS walks are independent loads
//     in flight together, and the tree's top levels come from L1 after the
//     first sample touches them.
//   * Tables are read through global memory and L2 (__ldg). The tables of a
//     512-tree depth-10 forest fit in H100's 50 MB L2 and stay there across
//     the engine's calls. Keeping tree tiles in shared memory (about 24 KB
//     per tree at depth 10) is left for later work.
//   * BS is picked per launch so that small batches still spread over the
//     SMs (one sample per block) and large ones reuse each tree read.
//
// Determinism: no atomics. Each thread adds its trees in a fixed order,
// a warp reduces with a fixed shuffle tree, and one thread adds the warps'
// sums in order. The order depends on neither B nor BS, so a row gets the
// same bits in every batch it rides in; the serving engine's cache and
// hot-swap rely on that.
//
// Tree count: the walk covers T rounded up to the 192-thread tree stride.
// The rows past T must be inert trees (feature 0, threshold +inf, value 0),
// which kernels/forest/ops.py pads in; the sum is divided by the real T.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 192;             // tree stride of one block: 6 warps
constexpr int kWarps = kThreads / 32;

template <int BS>
__global__ void __launch_bounds__(kThreads)
forest_kernel(const float* __restrict__ x, const int* __restrict__ feature,
              const float* __restrict__ threshold,
              const float* __restrict__ value, float* __restrict__ out,
              int B, int F, int T, int N, int depth) {
  extern __shared__ float xs[];           // (BS, F) tile of x
  __shared__ float partial[kWarps][BS];

  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * BS;
  const int rows = min(BS, B - b0);
  for (int i = tid; i < BS * F; i += kThreads) {
    xs[i] = (i / F < rows) ? x[(size_t)b0 * F + i] : 0.0f;
  }
  __syncthreads();

  float acc[BS];
#pragma unroll
  for (int s = 0; s < BS; ++s) acc[s] = 0.0f;

  const int t_end = (T + kThreads - 1) / kThreads * kThreads;
  for (int t = tid; t < t_end; t += kThreads) {
    const int* ft = feature + (size_t)t * N;
    const float* th = threshold + (size_t)t * N;
    int node[BS];
#pragma unroll
    for (int s = 0; s < BS; ++s) node[s] = 0;
    for (int d = 0; d < depth; ++d) {
#pragma unroll
      for (int s = 0; s < BS; ++s) {
        const int i = node[s];
        const int f = __ldg(ft + i);
        const float thr = __ldg(th + i);
        const float xv = xs[s * F + max(f, 0)];
        const bool left = (f < 0) | (xv <= thr);
        node[s] = 2 * i + (left ? 1 : 2);
      }
    }
    const float* vt = value + (size_t)t * N;
#pragma unroll
    for (int s = 0; s < BS; ++s) acc[s] += __ldg(vt + node[s]);
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int s = 0; s < BS; ++s) {
    float v = acc[s];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) partial[warp][s] = v;
  }
  __syncthreads();
  if (tid < rows) {
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += partial[w][tid];
    out[b0 + tid] = sum / (float)T;
  }
}

template <int BS>
void launch(const float* x, const int* feature, const float* threshold,
            const float* value, float* out, int B, int F, int T, int N,
            int depth, cudaStream_t stream) {
  const int blocks = (B + BS - 1) / BS;
  const size_t smem = (size_t)BS * F * sizeof(float);
  forest_kernel<BS><<<blocks, kThreads, smem, stream>>>(
      x, feature, threshold, value, out, B, F, T, N, depth);
}

// Samples per block: the largest tile that still gives every SM four blocks
// to hide the gathers' latency; one sample per block below that.
int tile_rows(int B) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  const int min_blocks = 4 * sms;
  for (int bs = 8; bs > 1; bs >>= 1) {
    if ((B + bs - 1) / bs >= min_blocks) return bs;
  }
  return 1;
}

}  // namespace

extern "C" {

// Trees one block strides over; the Python wrapper checks it matches.
int forest_tree_stride() { return kThreads; }

int forest_tile_rows(int B) { return tile_rows(B); }

// x (B, F) f32; feature (>= T rounded up to the tree stride, N) i32;
// threshold, value: same shape, f32; out (B,) f32. All on the current
// device, contiguous. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError().
int forest_predict_f32(const void* x, const void* feature,
                       const void* threshold, const void* value, void* out,
                       int B, int F, int T, int N, int depth, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const int* fp = static_cast<const int*>(feature);
  const float* tp = static_cast<const float*>(threshold);
  const float* vp = static_cast<const float*>(value);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tile_rows(B)) {
    case 8: launch<8>(xp, fp, tp, vp, op, B, F, T, N, depth, st); break;
    case 4: launch<4>(xp, fp, tp, vp, op, B, F, T, N, depth, st); break;
    case 2: launch<2>(xp, fp, tp, vp, op, B, F, T, N, depth, st); break;
    default: launch<1>(xp, fp, tp, vp, op, B, F, T, N, depth, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
