// Pair compaction (kernel B1) for the streamed rasterizer, sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/compact.py:
// _compact_kernel` (log-shift compaction of a 16-row candidate plane with a
// cursor-addressed append). It computes the same function: an
// order-preserving stream compaction of the valid candidate rows into a
// static `budget`-row output, with the TPU kernel's exact overflow rule:
//   * candidates form blocks of `window` (compact_window) rows;
//   * block k, with W_k rows already written, is appended iff
//     floor(W_k / 128) * 128 + window + 128 <= budget;
//   * the first block that misfits ends all appending;
//   * the sub-128 remainder is kept only if floor(W/128)*128 + 128 <= budget;
//   * counts = (written, total valid); rows [written, budget) get
//     INT32_MAX keys/ids and zero features.
// No arithmetic touches the features: rows are moved bit for bit.
//
// Bound on the card: memory. Each candidate's flag is read twice and each
// kept row (3 int32 keys + 9 f32 features = 48 bytes) is read once and
// written once. Design: (1) one CTA per window counts its valid rows
// (block reduce); (2) one thread walks the per-window counts in order and
// applies the overflow rule (640 windows at the serving shape); (3) one CTA
// per appended window runs block-wide exclusive scans (cub::BlockScan) over
// 256-row slices, coalesced, and scatters each valid row to
// offset_k + rank; (4) a grid-stride pass fills the tail.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kFeat = 9;
constexpr int32_t kIntMax = 0x7fffffff;

__global__ void count_kernel(const uint8_t* __restrict__ valid, long long n_cand,
                             int window, int32_t* __restrict__ block_counts) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ typename Reduce::TempStorage tmp;
  const long long start = (long long)blockIdx.x * window;
  int c = 0;
  for (int i = threadIdx.x; i < window; i += kThreads) {
    const long long j = start + i;
    c += (j < n_cand && valid[j]) ? 1 : 0;
  }
  const int total = Reduce(tmp).Sum(c);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void fit_kernel(const int32_t* __restrict__ block_counts, int n_blocks,
                           int window, long long budget,
                           int32_t* __restrict__ block_offsets,
                           int32_t* __restrict__ counts) {
  if (threadIdx.x != 0) return;
  long long w = 0, total = 0;
  bool open = true;
  for (int k = 0; k < n_blocks; ++k) {
    const int c = block_counts[k];
    total += c;
    if (open && (w / 128) * 128 + window + 128 <= budget) {
      block_offsets[k] = (int32_t)w;
      w += c;
    } else {
      open = false;
      block_offsets[k] = -1;
    }
  }
  long long written = w;
  if ((w % 128) != 0 && (w / 128) * 128 + 128 > budget) written = (w / 128) * 128;
  counts[0] = (int32_t)written;
  counts[1] = (int32_t)total;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ valid,
                               const int32_t* __restrict__ tile,
                               const int32_t* __restrict__ dkey,
                               const int32_t* __restrict__ pid,
                               const float* __restrict__ feats, long long n_cand,
                               int window, const int32_t* __restrict__ block_offsets,
                               const int32_t* __restrict__ counts, long long budget,
                               int32_t* __restrict__ tile_out,
                               int32_t* __restrict__ dkey_out,
                               int32_t* __restrict__ pid_out,
                               float* __restrict__ feats_out) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ typename Scan::TempStorage tmp;
  const int offset = block_offsets[blockIdx.x];
  if (offset < 0) return;  // uniform across the CTA
  const long long written = counts[0];
  const long long start = (long long)blockIdx.x * window;
  long long base = offset;
  for (int r = 0; r < window; r += kThreads) {
    const long long j = start + r + threadIdx.x;
    const int f = (r + threadIdx.x < window && j < n_cand && valid[j]) ? 1 : 0;
    int rank, slice_total;
    Scan(tmp).ExclusiveSum(f, rank, slice_total);
    const long long dst = base + rank;
    if (f && dst < written) {
      tile_out[dst] = tile[j];
      dkey_out[dst] = dkey[j];
      pid_out[dst] = pid[j];
#pragma unroll
      for (int k = 0; k < kFeat; ++k) feats_out[k * budget + dst] = feats[k * n_cand + j];
    }
    base += slice_total;
    __syncthreads();  // temp storage is reused by the next slice's scan
  }
}

__global__ void tail_kernel(const int32_t* __restrict__ counts, long long budget,
                            int32_t* __restrict__ tile_out,
                            int32_t* __restrict__ dkey_out,
                            int32_t* __restrict__ pid_out,
                            float* __restrict__ feats_out) {
  const long long written = counts[0];
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < budget;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < written) continue;
    tile_out[i] = kIntMax;
    dkey_out[i] = kIntMax;
    pid_out[i] = kIntMax;
#pragma unroll
    for (int k = 0; k < kFeat; ++k) feats_out[k * budget + i] = 0.0f;
  }
}

}  // namespace

// valid (n_cand,) u8; tile/dkey/pid (n_cand,) i32; feats (9, n_cand) f32;
// scratch block_counts/block_offsets (n_blocks,) i32; counts (2,) i32;
// outputs tile/dkey/pid (budget,) i32 and feats (9, budget) f32.
extern "C" int pf3_compact_pairs(const void* valid, const void* tile, const void* dkey,
                                 const void* pid, const void* feats, long long n_cand,
                                 int window, long long budget, void* block_counts,
                                 void* block_offsets, void* counts, void* tile_out,
                                 void* dkey_out, void* pid_out, void* feats_out,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (int)((n_cand + window - 1) / window);
  count_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), n_cand, window,
      static_cast<int32_t*>(block_counts));
  fit_kernel<<<1, 32, 0, s>>>(static_cast<const int32_t*>(block_counts), n_blocks,
                              window, budget, static_cast<int32_t*>(block_offsets),
                              static_cast<int32_t*>(counts));
  scatter_kernel<<<n_blocks, kThreads, 0, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(tile),
      static_cast<const int32_t*>(dkey), static_cast<const int32_t*>(pid),
      static_cast<const float*>(feats), n_cand, window,
      static_cast<const int32_t*>(block_offsets), static_cast<const int32_t*>(counts),
      budget, static_cast<int32_t*>(tile_out), static_cast<int32_t*>(dkey_out),
      static_cast<int32_t*>(pid_out), static_cast<float*>(feats_out));
  const int tail_blocks = (int)((budget + kThreads - 1) / kThreads);
  tail_kernel<<<tail_blocks < 65535 ? tail_blocks : 65535, kThreads, 0, s>>>(
      static_cast<const int32_t*>(counts), budget, static_cast<int32_t*>(tile_out),
      static_cast<int32_t*>(dkey_out), static_cast<int32_t*>(pid_out),
      static_cast<float*>(feats_out));
  return (int)cudaGetLastError();
}
