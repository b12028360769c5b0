// Dense-forest inference on Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/forest/kernel.py::_forest_kernel
// (launched by forest_predict_kernel). That kernel avoids gathers: it turns
// "which feature does my node test" into one-hot MXU contractions. A GPU
// gathers cheaply from shared memory, so this kernel ports the computation,
// not the trick.
//
// What it computes: out[b] = (1/T) * sum_t leaf[t, l(b, t)], where l(b, t)
// is reached from node 0 by `depth` steps of
//     i = 2i + 1 + !(x[b, feature[t, i]] <= threshold[t, i])
// with feature -1 going left whatever x holds. The semantics are those of
// kernels/forest/ref.py: a NaN feature goes right, and a non-finite value in
// a column the node does not test has no effect on the walk.
//
// The packed tables (kernels/forest/ops.py::pack_tables, built once per
// forest): per tree, 2^depth node records {threshold f32 bits, feature i32}
// of which records 0 .. 2^depth - 2 are the internal levels 0 .. depth-1
// (the last record is padding, so a tree is a 16-byte multiple), and
// `leaf_stride` >= 2^depth leaf values of level `depth`. A node with
// feature -1 carries threshold +inf. The tree count is padded to a multiple
// of kGroup with inert trees (feature -1, leaves 0).
//
// What bounds it: memory. The compare and index work is a few integer
// operations per node, negligible next to the card's rate. A call must read
// at most every distinct node its walks touch once (8 bytes each) plus the
// leaves: 6.3 MB of packed tables for 512 trees at depth 10, fewer at small
// batches. At 3.35 TB/s that is under 2 us. The walks' reads are dependent,
// so what a launch waits on is the latency of each step's two loads.
//
// What the design does about it:
//   * Grid (sample tile, tree group). A group is kGroup consecutive trees.
//     One thread copies the group's tables into shared memory with
//     cp.async.bulk, completing on an mbarrier, while the block loads its
//     tile of x, transposed, into shared memory (column f at xs[f * bs],
//     so the 32 lanes of a warp read 32 banks whatever features they test;
//     the row before column 0 holds -inf, where feature -1 points, so a
//     -1 node goes left without a branch).
//   * Each thread walks R (1 or 2) samples through the group's trees, the
//     R x kGroup walks interleaved so their loads are in flight together;
//     every level is two loads from shared memory (the 8-byte record, then
//     x).
//   * Deep trees: the top `split` levels of each tree go to shared memory
//     (all of them, and the leaves, when the group fits the budget that
//     ops.py's split_levels applies); the deeper levels and the leaves are
//     then read through L2 with 8-byte __ldg loads. One kernel for every
//     depth.
//   * A second small kernel sums the groups' partials.
//
// Determinism: no atomics. A thread adds its group's trees in tree order
// into a partial (one per group and sample, in a (groups, B) workspace the
// wrapper allocates); forest_sum_kernel adds a sample's partials in a fixed
// order (eight strided runs over the groups, then the runs in order) and
// divides by the real tree count. The order depends on T only,
// never on B or the tile, so a row gets the same bits in every batch it
// rides in; the serving engine's cache and hot-swap rely on that.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroup = 4;          // trees per block; ops.py's TREE_GROUP
constexpr int kMaxThreads = 256;
constexpr int kMaxDevices = 64;

// error codes beside cudaError_t's (which are >= 0)
constexpr int kBadShape = -1;      // no launch shape fits shared memory
constexpr int kBadDevice = -2;
// room left beside the dynamic shared memory for the walk's static mbarrier
constexpr int kStaticSmem = 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Walks R samples of one tile through one group of kGroup trees and writes
// each sample's partial sum to partial[g * B + b].
template <int R>
__global__ void __launch_bounds__(kMaxThreads)
forest_walk_kernel(const float* __restrict__ x, const int2* __restrict__ nodes,
                   const float* __restrict__ leaves,
                   float* __restrict__ partial, int B, int F, int depth,
                   int split, int leaf_stride, int bs) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int b0 = blockIdx.x * bs;
  const int g = blockIdx.y;
  const int ns = 1 << split;       // node records of a tree in shared memory
  const int nd = 1 << depth;       // node records of a tree in the tables
  const bool leaves_shared = split == depth;
  int2* nodes_s = reinterpret_cast<int2*>(smem);
  float* leaves_s = reinterpret_cast<float*>(nodes_s + kGroup * ns);
  float* xs = leaves_s + (leaves_shared ? kGroup * leaf_stride : 0);
  const size_t t0 = static_cast<size_t>(g) * kGroup;
  const uint32_t bar_addr = smem_addr(&bar);

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t node_bytes = split > 0 ? ns * 8u : 0u;
    const uint32_t leaf_bytes = leaves_shared ? leaf_stride * 4u : 0u;
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            bar_addr),
        "r"(kGroup * (node_bytes + leaf_bytes))
        : "memory");
    for (int j = 0; j < kGroup; ++j) {
      if (node_bytes) {
        bulk_copy(nodes_s + j * ns, nodes + (t0 + j) * nd, node_bytes,
                  bar_addr);
      }
      if (leaf_bytes) {
        bulk_copy(leaves_s + j * leaf_stride, leaves + (t0 + j) * leaf_stride,
                  leaf_bytes, bar_addr);
      }
    }
  }

  // the x tile, transposed, behind a row of -inf (feature -1): a thread
  // copies its own rows (L1 serves the warp's neighbouring rows), and the
  // lanes store to neighbouring banks
  float* xcol = xs + bs;
  const int rows = min(bs, B - b0);
  for (int row = tid; row < bs; row += nthreads) {
    xs[row] = -__int_as_float(0x7f800000);
    const float* xr = x + static_cast<size_t>(b0 + row) * F;
    for (int f = 0; f < F; ++f) {
      xcol[f * bs + row] = row < rows ? __ldg(xr + f) : 0.0f;
    }
  }
  __syncthreads();
  mbar_wait(bar_addr, 0);

  int node[R][kGroup];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) node[r][j] = 0;
  }
  for (int d = 0; d < split; ++d) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = tid + r * nthreads;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int2 rec = nodes_s[j * ns + node[r][j]];
        const float xv = xcol[rec.y * bs + s];
        node[r][j] = 2 * node[r][j] + (xv <= __int_as_float(rec.x) ? 1 : 2);
      }
    }
  }
  for (int d = split; d < depth; ++d) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int s = tid + r * nthreads;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int2 rec = __ldg(nodes + (t0 + j) * nd + node[r][j]);
        const float xv = xcol[rec.y * bs + s];
        node[r][j] = 2 * node[r][j] + (xv <= __int_as_float(rec.x) ? 1 : 2);
      }
    }
  }

  const int first_leaf = nd - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int l = node[r][j] - first_leaf;
      acc += leaves_shared ? leaves_s[j * leaf_stride + l]
                           : __ldg(leaves + (t0 + j) * leaf_stride + l);
    }
    const int s = tid + r * nthreads;
    if (s < rows) partial[static_cast<size_t>(g) * B + b0 + s] = acc;
  }
}

// out[b] = (sum over the groups of partial[g * B + b]) / T, in a fixed
// order: a block takes 32 samples; warp w adds groups w, w + kSumWarps, ...
// in order, then warp 0 adds the warps' sums in warp order.
// kernels/forest/ref.py::SUM_RUNS repeats it.
constexpr int kSumWarps = 8;

__global__ void __launch_bounds__(kSumWarps * 32)
forest_sum_kernel(const float* __restrict__ partial, float* __restrict__ out,
                  int B, int groups, int T) {
  __shared__ float sums[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (b < B) {
#pragma unroll 8
    for (int g = w; g < groups; g += kSumWarps) {
      s += partial[static_cast<size_t>(g) * B + b];
    }
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && b < B) {
    float total = 0.0f;
#pragma unroll
    for (int i = 0; i < kSumWarps; ++i) total += sums[i][lane];
    out[b] = total / static_cast<float>(T);
  }
}

struct DeviceInfo {
  int sms = 0;
  int max_smem = 0;                // dynamic shared memory a block may take
  bool raised[2] = {false, false};  // per R = 1, 2
};

DeviceInfo* device_info(int dev) {
  static DeviceInfo info[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return nullptr;
  DeviceInfo& d = info[dev];
  if (d.sms == 0) {
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
    d.max_smem = optin - kStaticSmem;
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    d.sms = sms > 0 ? sms : 1;
  }
  return &d;
}

struct Shape {
  int threads, r, bs, tiles;
  size_t smem;
};

// the layout forest_walk_kernel carves: kGroup x 2^split node records, the
// leaves when split == depth, then the x tile
size_t table_smem(int depth, int split, int leaf_stride) {
  return static_cast<size_t>(kGroup) *
         ((size_t{8} << split) +
          (split == depth ? size_t{4} * leaf_stride : 0));
}

// Samples per thread R: 2 when that still gives the card two blocks per
// SM, else 1; then as many threads (at most 256) as the batch fills. Shrunk
// until the tables and the x tile fit in shared memory. (On an H100 at
// B = 4096 both R = 4 and R = 1 ran slower than R = 2: the walk waits on
// shared-memory latency, and R = 2 keeps more warps resident than R = 4
// and more walks in flight a warp than R = 1.)
bool launch_shape(const DeviceInfo& d, int B, int F, int groups, int depth,
                  int split, int leaf_stride, Shape* out) {
  const size_t tables = table_smem(depth, split, leaf_stride);
  int threads = min(kMaxThreads, (B + 31) / 32 * 32);
  const long tiles2 = (B + 2L * threads - 1) / (2L * threads);
  int r = tiles2 * groups >= 2L * d.sms ? 2 : 1;
  for (;;) {
    const int bs = threads * r;
    const size_t smem = tables + sizeof(float) * (F + 1) * bs;
    if (smem <= static_cast<size_t>(d.max_smem)) {
      out->threads = threads;
      out->r = r;
      out->bs = bs;
      out->tiles = (B + bs - 1) / bs;
      out->smem = smem;
      return true;
    }
    if (r > 1) {
      r >>= 1;
    } else if (threads > 32) {
      threads -= 32;
    } else {
      return false;
    }
  }
}

template <int R>
cudaError_t launch_walk(DeviceInfo& d, int slot, const Shape& sh,
                        const float* x, const int2* nodes,
                        const float* leaves, float* partial, int B, int F,
                        int groups, int depth, int split, int leaf_stride,
                        cudaStream_t stream) {
  // above 48 KB only after raising the kernel's limit, once per device
  if (!d.raised[slot]) {
    const cudaError_t err = cudaFuncSetAttribute(
        forest_walk_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        d.max_smem);
    if (err != cudaSuccess) return err;
    d.raised[slot] = true;
  }
  const dim3 grid(sh.tiles, groups);
  forest_walk_kernel<R><<<grid, sh.threads, sh.smem, stream>>>(
      x, nodes, leaves, partial, B, F, depth, split, leaf_stride, sh.bs);
  return cudaGetLastError();
}

}  // namespace

// What a packed forest hands every call: set once, when the forest is
// packed (kernels/forest/kernel.py::Tables mirrors it).
struct Tables {
  const int2* nodes;    // (groups * kGroup, 2^depth) {threshold bits, feature}
  const float* leaves;  // (groups * kGroup, leaf_stride)
  int n_features, n_trees, groups, depth, split, leaf_stride;
};

extern "C" {

// Trees one block walks; the Python wrapper checks it matches TREE_GROUP.
int forest_tree_group() { return kGroup; }

// Samples per block the walk takes for B rows (0 if no shape fits).
int forest_tile_rows(const Tables* t, int B) {
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo* d = device_info(dev);
  Shape sh;
  if (!d || !launch_shape(*d, B, t->n_features, t->groups, t->depth,
                          t->split, t->leaf_stride, &sh)) {
    return 0;
  }
  return sh.bs;
}

// x (B, n_features) f32 contiguous; partial (groups, B) f32 scratch; out
// (B,) f32; all on the current device, with the tables. Launches the walk
// and the sum on `stream`, does not synchronise, and returns
// cudaGetLastError() (or a negative code when no launch shape fits).
int forest_predict_f32(const void* x, void* partial, void* out, int B,
                       const Tables* t, void* stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  DeviceInfo* d = device_info(dev);
  if (!d) return kBadDevice;
  const int F = t->n_features, groups = t->groups, depth = t->depth;
  const int split = t->split, leaf_stride = t->leaf_stride;
  Shape sh;
  if (!launch_shape(*d, B, F, groups, depth, split, leaf_stride, &sh)) {
    return kBadShape;
  }
  const float* xp = static_cast<const float*>(x);
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sh.r == 2) {
    err = launch_walk<2>(*d, 1, sh, xp, t->nodes, t->leaves, pp, B, F,
                         groups, depth, split, leaf_stride, st);
  } else {
    err = launch_walk<1>(*d, 0, sh, xp, t->nodes, t->leaves, pp, B, F,
                         groups, depth, split, leaf_stride, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  forest_sum_kernel<<<(B + 31) / 32, kSumWarps * 32, 0, st>>>(
      pp, static_cast<float*>(out), B, groups, t->n_trees);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
