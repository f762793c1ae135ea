// What the compositing walks share: the forward walk of kernels B2 and B6
// (composite_fwd_walk.cuh) and the backward walk of kernels B3, B5 and B7
// (composite_bwd_walk.cuh).
//
//   * A walk reads a tile row's pairs from one of the sources in `Layout`:
//     the streamed (9, plane) sorted pair array (B2, B3), the same with the
//     gradients going to per-chunk blocks (B5), or a dense table row (B6,
//     B7).
//   * A CTA has at most kMaxThreads threads, one pixel each; a tile of up to
//     kMaxPixels pixels is walked in equal parts (walk_parts, walk_threads).
//     A part has a whole number of warps, so where the tile's pixel count is
//     no multiple of 32 the last lanes are idle: they read and write nothing
//     of the tile and take part in every barrier and warp vote.
//   * A chunk's pairs are staged pair-major as three float4 (x, y, ca, cb |
//     cc, op, thr, c0 | c1, c2, 0, 0), read back as broadcast 16-byte loads.
//     thr = skip_below(op, alpha_min): a pair whose power (pair_power, with
//     composite_alpha.cuh's rounding) is below it has alpha < alpha_min for
//     certain, so alpha is 0 and the pair adds -0 to the log sum of T: it is
//     skipped without B2's exponential, and T stays bit for bit as it was.
//   * The raw rows arrive by cp.async, feature-major from the streamed pair
//     arrays or slot-major from a dense table; stage_pair reads either
//     through its strides.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "composite_alpha.cuh"

enum class Layout { kStreamed, kBlocks, kTable };

constexpr int kFeat = 9;          // x, y, ca, cb, cc, op, c0, c1, c2
constexpr int kSub = 8;           // pairs per sub-block of a walk
constexpr int kMaxThreads = 256;  // threads of a CTA, one pixel each
constexpr int kMaxPixels = 1024;  // pixels of a tile

// Parts a tile of p pixels is walked in, and the threads of a part: a
// whole number of warps, p itself rounded up to a warp where p <=
// kMaxThreads (then one part).
__host__ __device__ inline int walk_parts(int p) { return (p + kMaxThreads - 1) / kMaxThreads; }

__host__ __device__ inline int walk_threads(int p) {
  const int parts = walk_parts(p);
  return ((p + parts - 1) / parts + 31) / 32 * 32;
}

__host__ __device__ inline int walk_sub_blocks(int chunk) { return (chunk + kSub - 1) / kSub; }

// pair_alpha's power, with its rounding (explicit round-to-nearest).
__device__ __forceinline__ float pair_power(float px, float py, float4 a, float cc) {
  const float dx = __fsub_rn(px, a.x);
  const float dy = __fsub_rn(py, a.y);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a.z, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(a.w, dx), dy));
}

// Power below which op * exp(power) < alpha_min for certain (0.01 below
// the exact bound in the log, far above the rounding of exp and log):
// +inf where op <= 0 can never reach alpha_min > 0, -inf (skip nothing)
// where the bound is not finite (alpha_min <= 0, op NaN or infinite).
__device__ __forceinline__ float skip_below(float op, float alpha_min) {
  if (!(alpha_min > 0.0f)) return -CUDART_INF_F;
  if (op <= 0.0f) return CUDART_INF_F;
  if (!(op <= 3.0e38f)) return -CUDART_INF_F;
  return logf(alpha_min / op) - 0.01f;
}

// Bits lo..hi-1 of a sub-block's mask.
__device__ __forceinline__ uint32_t span_bits(int lo, int hi) {
  return (hi >= kSub ? (1u << kSub) - 1u : (1u << max(hi, 0)) - 1u) & ~((1u << max(lo, 0)) - 1u);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying n contiguous floats at src into s_raw, in 16-byte copies
// where src is 16-byte aligned and n a multiple of 4 (s_raw always is);
// cp.async.wait_all and a barrier make them visible to every thread.
__device__ __forceinline__ void fetch_contiguous(float* s_raw, const float* __restrict__ src,
                                                 int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0 && n % 4 == 0) {
    for (int k = 4 * threadIdx.x; k < n; k += 4 * blockDim.x) cp_async16(s_raw + k, src + k);
  } else {
    for (int k = threadIdx.x; k < n; k += blockDim.x) cp_async4(s_raw + k, src + k);
  }
  cp_async_commit();
}

// Pair q of a chunk, from raw rows where feature f of pair q sits at
// s_raw[f * fs + q * qs], into its three float4 at s_feat[3 q]; q >= chunk
// (the padding of the last sub-block) gets zeros, outside every segment.
__device__ __forceinline__ void stage_pair(float4* s_feat, const float* s_raw, int q, int chunk,
                                           int fs, int qs, int channels, float alpha_min) {
  if (q < chunk) {
    const float* s = s_raw + q * qs;
    const float op = s[5 * fs];
    s_feat[3 * q] = make_float4(s[0], s[fs], s[2 * fs], s[3 * fs]);
    s_feat[3 * q + 1] = make_float4(s[4 * fs], op, skip_below(op, alpha_min), s[6 * fs]);
    s_feat[3 * q + 2] = make_float4(channels > 1 ? s[7 * fs] : 0.0f,
                                    channels > 2 ? s[8 * fs] : 0.0f, 0.0f, 0.0f);
  } else {
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    s_feat[3 * q] = z;
    s_feat[3 * q + 1] = z;
    s_feat[3 * q + 2] = z;
  }
}
