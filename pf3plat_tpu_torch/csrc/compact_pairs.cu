// Pair compaction (kernel B1) for the streamed rasterizer, sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/compact.py:
// _compact_kernel` (log-shift compaction of a 16-row candidate plane with a
// cursor-addressed append). It computes the same function: an
// order-preserving stream compaction of the valid candidate rows into a
// static `budget`-row output, with the TPU kernel's exact overflow rule:
//   * candidates form windows of `window` (compact_window) rows;
//   * window k, with W_k rows already written, is appended iff
//     floor(W_k / 128) * 128 + window + 128 <= budget;
//   * the first window that misfits ends all appending;
//   * the sub-128 remainder is kept only if floor(W/128)*128 + 128 <= budget;
//   * counts = (written, total valid); rows [written, budget) get
//     INT32_MAX keys/ids and zero features.
// No arithmetic touches the features: rows are moved bit for bit.
//
// Bound on the card: memory. Each candidate's flag and each kept row (3
// int32 keys + 9 f32 features = 48 bytes) are read once, `budget` rows are
// written once. The first design made four launches (count, a one-thread
// fit over all window counts in series, a scatter in 256-row slices with
// one row in flight a thread, the tail) and read every flag twice. This
// one is a single pass by decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016), plus
// the tail:
//   * A CTA takes its window from an atomic ticket, so every window it waits
//     for belongs to a CTA that started before it: the look-back cannot
//     deadlock.
//   * It reads the window's flags once, thread t taking rows t + 256 i (i <
//     16) of each 4,096-row slice, so a warp's loads and, after the ranking,
//     its stores are contiguous. A warp vote per i counts them.
//   * It publishes the window's count, looks back over the predecessors'
//     status words (one 64-bit word each: a flag and a count or an
//     inclusive prefix) for its exclusive prefix P_k, and publishes P_k +
//     count.
//   * The fit: P_k does not decrease, so the appended windows are a prefix
//     and window k is appended iff floor(P_k / 128) * 128 + window + 128 <=
//     budget; no CTA needs another's decision. With window and budget
//     multiples of 128 (the wrapper's rule) the remainder trim never fires:
//     if k is the last window appended, P_{k+1} <= P_k + window <= budget -
//     128 + 127. So written = P_{n_fit}; the property is tested on the plain
//     fit rule (tests/test_torch_rasterizer.py).
//   * Scatter: one scan over the (slice, i, warp) counts ranks the rows;
//     each thread issues the loads of the next plane (3 int32 + 9 f32
//     planes, valid rows only) before the stores of the current one.
//   * counts[0] is written by the last window appended (or by window 0 if
//     none is), counts[1] by the last window; a second launch fills rows
//     [written, budget) in 16-byte stores.
// The ticket and the status words are zeroed by one memset before the
// first launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                    // rows a thread takes per slice
constexpr int kSlice = kThreads * kRows;     // 4,096
constexpr int kCounts = kRows * kWarps;      // (i, warp) counts of a slice
constexpr int kPlanes = 12;                  // tile, dkey, pid, 9 features
constexpr uint32_t kIntMax = 0x7fffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;  // status flags
constexpr unsigned long long kInclusive = 2ull << 32;

struct Planes {
  const uint32_t* in[kPlanes];
  uint32_t* out[kPlanes];
};

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Rows are appended while this holds for the rows written before them.
__device__ __forceinline__ bool fits(long long written, int window, long long budget) {
  return (written / 128) * 128 + window + 128 <= budget;
}

// This thread's flags of slice s of the window at w0: bit i = row t + 256 i.
__device__ __forceinline__ uint32_t slice_flags(const uint8_t* __restrict__ valid, long long w0,
                                                int s, int window, long long n_cand) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = s * kSlice + i * kThreads + threadIdx.x;
    const long long j = w0 + r;
    if (r < window && j < n_cand && valid[j]) bits |= 1u << i;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads) compact_kernel(
    const uint8_t* __restrict__ valid, const __grid_constant__ Planes planes, long long n_cand,
    int window, int n_windows, long long budget, unsigned long long* __restrict__ status,
    unsigned int* __restrict__ ticket, int32_t* __restrict__ counts) {
  extern __shared__ int s_off[];  // n_slices * kCounts: counts, then exclusive offsets
  __shared__ int s_k;
  __shared__ long long s_base;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t lt = (1u << lane) - 1u;
  if (threadIdx.x == 0) s_k = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int k = s_k;
  const long long w0 = (long long)k * window;
  const int n_slices = (window + kSlice - 1) / kSlice;

  // Count: one vote per (slice, i, warp).
  uint32_t mine = 0;
  for (int s = 0; s < n_slices; ++s) {
    mine = slice_flags(valid, w0, s, window, n_cand);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint32_t b = __ballot_sync(0xffffffffu, mine >> i & 1u);
      if (lane == 0) s_off[(s * kRows + i) * kWarps + warp] = __popc(b);
    }
  }
  __syncthreads();

  if (warp == 0) {
    // Exclusive scan of the counts in (slice, i, warp) order: the rows'
    // order in the window.
    long long carry = 0;
    for (int c0 = 0; c0 < n_slices * kCounts; c0 += 128) {
      int v[4], sum = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = s_off[c0 + 4 * lane + q];
        sum += v[q];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      int run = (int)carry + incl - sum;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_off[c0 + 4 * lane + q] = run;
        run += v[q];
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    const long long count = carry;

    // Publish the count, look back for the exclusive prefix, publish the
    // inclusive one.
    long long excl = 0;
    if (k == 0) {
      if (lane == 0) store_status(status, kInclusive | (unsigned long long)count);
    } else {
      if (lane == 0) store_status(status + k, kAggregate | (unsigned long long)count);
      for (int j = k - 1;; j -= 32) {
        const int idx = j - lane;  // lane 0 nearest
        unsigned long long st = kInclusive;  // before window 0: inclusive 0
        if (idx >= 0) {
          do {
            st = load_status(status + idx);
          } while ((st >> 32) == 0);
        }
        const uint32_t done = __ballot_sync(0xffffffffu, (st >> 32) == 2);
        const int first = done ? __ffs(done) - 1 : 32;  // nearest inclusive prefix
        long long v = lane <= first ? (long long)(st & 0xffffffffull) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        excl += v;
        if (done) break;
      }
      if (lane == 0) store_status(status + k, kInclusive | (unsigned long long)(excl + count));
    }
    if (lane == 0) {
      s_base = excl;
      const bool fit = fits(excl, window, budget);
      const bool last = k == n_windows - 1;
      if (fit && (last || !fits(excl + count, window, budget))) counts[0] = (int32_t)(excl + count);
      if (!fit && k == 0) counts[0] = 0;
      if (last) counts[1] = (int32_t)(excl + count);
    }
  }
  __syncthreads();
  const long long base = s_base;
  if (!fits(base, window, budget)) return;  // uniform across the CTA

  const uint32_t last = mine;  // the last slice's flags
  for (int s = 0; s < n_slices; ++s) {
    mine = s == n_slices - 1 ? last : slice_flags(valid, w0, s, window, n_cand);
    int dst[kRows];  // budget < 2^31
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const uint32_t b = __ballot_sync(0xffffffffu, mine >> i & 1u);
      dst[i] = (int)base + s_off[(s * kRows + i) * kWarps + warp] + __popc(b & lt);
    }
    const long long src0 = w0 + (long long)s * kSlice + threadIdx.x;
    uint32_t cur[kRows], nxt[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      cur[i] = mine >> i & 1u ? planes.in[0][src0 + i * kThreads] : 0u;
#pragma unroll
    for (int f = 0; f < kPlanes; ++f) {
      if (f + 1 < kPlanes) {
        const uint32_t* in = planes.in[f + 1];
#pragma unroll
        for (int i = 0; i < kRows; ++i) nxt[i] = mine >> i & 1u ? in[src0 + i * kThreads] : 0u;
      }
      uint32_t* out = planes.out[f];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (mine >> i & 1u) out[dst[i]] = cur[i];
      }
      if (f + 1 < kPlanes) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) cur[i] = nxt[i];
      }
    }
  }
}

// Rows [counts[0], budget) of every output plane: INT32_MAX for the three
// key planes, 0 for the features; 4 rows a thread, whole groups in 16-byte
// stores (budget is a multiple of 4 and every plane 16-byte aligned).
__global__ void tail_kernel(int32_t* __restrict__ counts, int n_windows, long long budget,
                            const __grid_constant__ Planes planes) {
  if (n_windows == 0 && blockIdx.x == 0 && threadIdx.x == 0) {
    counts[0] = 0;
    counts[1] = 0;
  }
  const long long written = n_windows == 0 ? 0 : counts[0];
  for (long long g = written / 4 + (long long)blockIdx.x * blockDim.x + threadIdx.x;
       4 * g < budget; g += (long long)gridDim.x * blockDim.x) {
#pragma unroll
    for (int f = 0; f < kPlanes; ++f) {
      const uint32_t v = f < 3 ? kIntMax : 0u;
      uint32_t* out = planes.out[f] + 4 * g;
      if (4 * g >= written) {
        *reinterpret_cast<uint4*>(out) = make_uint4(v, v, v, v);
      } else {
        for (int q = (int)(written - 4 * g); q < 4; ++q) out[q] = v;
      }
    }
  }
}

}  // namespace

// valid (n_cand,) u8; tile/dkey/pid (n_cand,) i32; feats (9, n_cand) f32;
// scratch (n_windows + 1,) 8-byte words; counts (2,) i32; outputs
// tile/dkey/pid (budget,) i32 and feats (9, budget) f32, each 16-byte
// aligned. window and budget are multiples of 128.
extern "C" int pf3_compact_pairs(const void* valid, const void* tile, const void* dkey,
                                 const void* pid, const void* feats, long long n_cand,
                                 int window, long long budget, void* scratch, void* counts,
                                 void* tile_out, void* dkey_out, void* pid_out, void* feats_out,
                                 void* stream) {
  if (window <= 0 || window % 128 || budget % 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_windows = (n_cand + window - 1) / window;
  Planes planes;
  const void* in[3] = {tile, dkey, pid};
  void* out[3] = {tile_out, dkey_out, pid_out};
  for (int f = 0; f < kPlanes; ++f) {
    planes.in[f] = f < 3 ? static_cast<const uint32_t*>(in[f])
                         : static_cast<const uint32_t*>(feats) + (f - 3) * n_cand;
    planes.out[f] = f < 3 ? static_cast<uint32_t*>(out[f])
                          : static_cast<uint32_t*>(feats_out) + (f - 3) * budget;
  }
  auto* status = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (n_windows + 1) * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return (int)e;
  if (n_windows > 0) {
    const int n_slices = (window + kSlice - 1) / kSlice;
    compact_kernel<<<(unsigned)n_windows, kThreads, n_slices * kCounts * sizeof(int), s>>>(
        static_cast<const uint8_t*>(valid), planes, n_cand, window, (int)n_windows, budget,
        status, reinterpret_cast<unsigned int*>(status + n_windows),
        static_cast<int32_t*>(counts));
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const long long groups = (budget / 4 + kThreads - 1) / kThreads;
  tail_kernel<<<(unsigned)(groups < 1056 ? (groups > 0 ? groups : 1) : 1056), kThreads, 0, s>>>(
      static_cast<int32_t*>(counts), (int)n_windows, budget, planes);
  return (int)cudaGetLastError();
}
