// Long-sequence attention, forward (kernel L forward), sm_90a.
//
// Replaces `pf3plat_tpu/models/layers.py:_flash_attention` (JAX's TPU flash
// attention kernel, forward): out = softmax(q k^T * scale) v per (batch,
// head) without ever writing the (n, m) logits to device memory. q, k, v
// arrive rounded to bf16; logits, the running maximum and the running sum
// are f32; the probabilities are rounded to bf16 before the second product,
// which accumulates in f32. The per-row log-sum-exp of the scaled logits
// (natural log) is saved for the backward. Any n and m: rows past the end
// are read as zeros, key columns past m get probability 0, query rows past
// n are not stored.
//
// Bound on the card: at head dim 32 the exponentials (n m per head on the
// special-function units, 16 per SM and clock: 128 tensor-core operations
// per exponential are not enough to hide them), at head dim 64 the 4 n m d
// tensor-core operations and the exponentials about equally; the bytes
// (q, k, v read once, out written once) are far below both.
//
// Design (attention_mma.cuh has the building blocks):
//   * A CTA of two warpgroups owns 128 query rows; the query fragments are
//     read once from device memory into registers.
//   * K and V tiles of kKeys keys pass through a ring of kStages stages in
//     dynamic shared memory, filled by `cp.async` 16-byte copies (zero fill
//     past m) at the swizzled addresses the `wgmma` descriptors name. Two
//     blocks' copies are in flight while a block is multiplied; one
//     `__syncthreads()` a block both publishes the landed tile and frees
//     the oldest stage. `cp.async` rather than TMA: the libraries are plain
//     `nvcc -shared` objects that link the CUDA runtime only, a ragged end is one
//     source-size operand, and at 2-4 copies a thread and block their
//     cost is small beside the block's arithmetic.
//   * S = Q K^T is one `wgmma.mma_async.m64n{kKeys}k16` chain per
//     warpgroup with K as it lies (K-major B). The online softmax runs on
//     the accumulator in registers: scale * log2(e) is folded into one
//     fused multiply-add before `ex2` (2^(s c - max c)); the rounded
//     probabilities are the register A operand of O += P V, which reads the
//     V tile MN-major through the descriptor's transpose bit.
//   * Within a warpgroup the tensor cores run ahead of the softmax: the
//     logits of block i + 1 and then P V of block i are started together,
//     the softmax of block i + 1 runs while P V of block i is still being
//     multiplied, and the output sums are rescaled only once it is done
//     (they are accumulators of the open `wgmma` group until then). 64-key
//     tiles keep this at <= 128 registers, so two CTAs (four warpgroups)
//     share an SM and fill each other's waits; 128-key tiles at one CTA an
//     SM were slower on the H100.

#include "attention_mma.cuh"

namespace {

constexpr int kKeys = 64;   // keys of a tile
constexpr int kStages = 4;  // tiles of the ring (>= 3: a block's K is read one block early)

template <int D>
constexpr int smem_bytes() {
  return kStages * 2 * kKeys * D * 2 + 1024;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) attention_fwd_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, float* __restrict__ out, float* __restrict__ lse, int n,
    int m, float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTileBytes = kKeys * D * 2;
  static_assert(kStages >= 3, "a block's K is read one block before its V");
  const uint32_t ring = aligned_smem(smem_raw);
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kCtaRows + warp * 16;  // this warp's 16 query rows
  q += (size_t)bh * n * D;
  k += (size_t)bh * m * D;
  v += (size_t)bh * m * D;

  const int blocks = (m + kKeys - 1) / kKeys;
  auto fetch = [&](int blk) {
    if (blk < blocks) {
      const uint32_t stage = ring + (blk % kStages) * 2 * kTileBytes;
      load_tile_async<D, kKeys>(stage, k, blk * kKeys, m);
      load_tile_async<D, kKeys>(stage + kTileBytes, v, blk * kKeys, m);
    }
    cp_async_commit();  // one group a block, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  uint32_t qf[D / 16][4];
  load_a_global<D>(qf, q, row0, n, g, t);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const float c = scale * kLog2e;
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, unscaled logits
  float row_sum[2] = {0.0f, 0.0f};            // this lane's share of the row's sum
  float s[kKeys / 2];           // a block's logits, then its probabilities
  uint32_t pf[kKeys / 16][4];   // the probabilities rounded to bf16, as A fragments
  float corr[2];                // what the latest maximum makes of the older sums

  // Online softmax of block blk on s: key columns past m (only in the last
  // block) masked out, the row statistics updated, the probabilities left in
  // s. A block always holds at least one real key, so the maximum is finite.
  auto softmax = [&](int blk) {
    const int k0 = blk * kKeys;
    if (k0 + kKeys > m) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int col = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col >= m) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      }
      const float new_max = fmaxf(row_max[h], quad_max(mx));
      corr[h] = fast_exp2((row_max[h] - new_max) * c);
      const float shift = new_max * c;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        float p0 = fmaf(s[4 * j + 2 * h], c, -shift);
        float p1 = fmaf(s[4 * j + 2 * h + 1], c, -shift);
        p0 = fast_exp2(p0);
        p1 = fast_exp2(p1);
        s[4 * j + 2 * h] = p0;
        s[4 * j + 2 * h + 1] = p1;
        part += p0 + p1;
      }
      row_sum[h] = row_sum[h] * corr[h] + part;
      row_max[h] = new_max;
    }
  };
  // acc follows the latest maximum; s becomes the next product's A operand
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * h] *= corr[h];
        acc[4 * j + 2 * h + 1] *= corr[h];
      }
    }
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) acc_to_a(pf[ks], s + 8 * ks);
  };
  auto start_pv = [&](int blk) {
    const uint64_t desc_v = tile_desc<D>(ring + (blk % kStages) * 2 * kTileBytes + kTileBytes);
#pragma unroll
    for (int ks = 0; ks < kKeys / 16; ++ks) {
      wgmma_rs<1>(acc, pf[ks], desc_v + ks * ((16 * D * 2) >> 4), 1);
    }
    wgmma_commit();
  };
  auto start_logits = [&](int blk) {
    const uint64_t desc_k = tile_desc<D>(ring + (blk % kStages) * 2 * kTileBytes);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_rs<0>(s, qf[ks], desc_k + ks * 2, ks > 0);
    wgmma_commit();
  };

  cp_async_wait<kStages - 2>();  // this thread's copies of block 0 landed
  fence_proxy_async();
  __syncthreads();  // everyone's landed
  wgmma_fence();
  start_logits(0);
  wgmma_wait<0>();
  softmax(0);
  rescale_and_pack();

  for (int blk = 0; blk + 1 < blocks; ++blk) {
    cp_async_wait<kStages - 3>();  // this thread's copies of block blk + 1 landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed and done with block blk - 1
    fetch(blk + kStages - 1);
    wgmma_fence();
    start_logits(blk + 1);
    start_pv(blk);
    wgmma_wait<1>();  // S of block blk + 1
    softmax(blk + 1);
    wgmma_wait<0>();  // P V of block blk
    rescale_and_pack();
  }
  wgmma_fence();
  start_pv(blocks - 1);
  wgmma_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float total = quad_sum(row_sum[h]);
    const int row = row0 + g + 8 * h;
    if (row < n) {
      const float inv = 1.0f / total;
      float* dst = out + ((size_t)bh * n + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) =
            make_float2(acc[4 * j + 2 * h] * inv, acc[4 * j + 2 * h + 1] * inv);
      }
      if (t == 0) lse[(size_t)bh * n + row] = row_max[h] * scale + logf(total);
    }
  }
}

// Allows the kernel its dynamic shared memory (above 48 KB at d = 64), once.
template <int D>
cudaError_t configure() {
  static const cudaError_t attr =
      cudaFuncSetAttribute(attention_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes<D>());
  return attr;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int n,
           int m, float scale, cudaStream_t s) {
  if (configure<D>() != cudaSuccess) return (int)configure<D>();
  const dim3 grid((n + kCtaRows - 1) / kCtaRows, bh);
  attention_fwd_kernel<D><<<grid, kThreads, smem_bytes<D>(), s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<float*>(out), static_cast<float*>(lse), n, m,
      scale);
  return (int)cudaGetLastError();
}

template <int D>
int occupancy() {
  int ctas = 0;
  cudaError_t e = configure<D>();
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, attention_fwd_kernel<D>, kThreads,
                                                      smem_bytes<D>());
  }
  return e == cudaSuccess ? ctas : -(int)e;
}

}  // namespace

// q (bh, n, d), k and v (bh, m, d) bf16, contiguous, 16-byte aligned;
// outputs out (bh, n, d) f32 and lse (bh, n) f32. d is 32 or 64. Returns the
// CUDA error code, or -1 for a head dim the kernel is not built for.
extern "C" int pf3_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                 void* lse, int bh, int n, int m, int d, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || m <= 0) return -1;
  if (d == 32) return launch<32>(q, k, v, out, lse, bh, n, m, scale, s);
  if (d == 64) return launch<64>(q, k, v, out, lse, bh, n, m, scale, s);
  return -1;
}

// CTAs of the forward kernel that fit one SM at head dim d (registers and
// shared memory as built); negative on an error or an unknown head dim.
extern "C" int pf3_attention_fwd_occupancy(int d) {
  if (d == 32) return occupancy<32>();
  if (d == 64) return occupancy<64>();
  return -1;
}
