// Building blocks of the attention kernels (attention_fwd.cu,
// attention_bwd.cu) on Hopper: the warpgroup product `wgmma.mma_async`
// (bf16 in, f32 accumulation) with A in registers and B in shared memory,
// swizzled shared-memory tiles filled by `cp.async`, and the matching
// matrix descriptors.
//
// One plan serves every product of both kernels. A CTA of 256 threads = two
// warpgroups owns 128 rows of the RESIDENT operands (queries, or keys); a
// warpgroup owns 64 of them, a warp 16. The resident rows are read from
// device memory once, straight into A fragments. The WALKED operands (key
// and value rows, or query and dO rows) pass through a ring of tiles in
// shared memory; every product reads them as its B operand through a
// descriptor:
//   logits  (A rows) x (tile rows)^T : the tile as it lies is K-major;
//   sums    (weights) x (tile rows)  : the same bytes are MN-major, chosen
//                                      by the product's transpose bit.
// So nothing is ever transposed in shared memory, and the tile is read once
// per warpgroup (64 rows) instead of once per warp.
//
// Fragment layout of wgmma.m64nNk16 per warp (PTX ISA, "Register fragments
// of wgmma.mma_async"), with g = lane / 4 and t = lane % 4, the warp owning
// rows 16 * (warp % 4) .. + 15 of the warpgroup's 64:
//   A (16 x 16):   a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//                  a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   D (16 x N):    d[4j], d[4j+1] = D[g][8j+2t, 8j+2t+1]
//                  d[4j+2], d[4j+3] = D[g+8][8j+2t, 8j+2t+1]
// Each 32-bit register holds two bf16 values, the lower index in the low
// half. Sixteen columns of D (d[8i .. 8i+7]), rounded to bf16, are exactly
// one A fragment: the weights of one product feed the next without leaving
// the registers, and a row of D lives in one quad of lanes.
//
// Shared-memory tiles: ROWS x D bf16, a row of D * 2 bytes (64 or 128),
// 1024-byte aligned, in the 64-byte (D = 32) or 128-byte (D = 64) swizzle
// that the descriptor names: the 16-byte chunk c of row r lies at chunk
// c ^ (r % 8) (128-byte rows) or c ^ ((r / 2) % 4) (64-byte rows).

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kThreads = 256;   // two warpgroups
constexpr int kCtaRows = 128;   // resident rows of a CTA, 64 a warpgroup
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Sixteen columns of an accumulator (d[0 .. 7]), rounded to bf16, as one A fragment.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x on the special-function unit (one `ex2`, no range fix-up).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The dynamic shared memory's first 1024-byte aligned address (the launch
// asks for 1024 bytes more than the tiles take).
__device__ __forceinline__ uint32_t aligned_smem(const void* raw) {
  return ((uint32_t)__cvta_generic_to_shared(raw) + 1023u) & ~1023u;
}

// A fragments of the 16 rows [row0, row0 + 16) of a (total, D) bf16 matrix,
// straight from device memory; rows at or past `total` are zero.
template <int D>
__device__ __forceinline__ void load_a_global(uint32_t (&a)[D / 16][4],
                                              const uint16_t* __restrict__ src, int row0,
                                              int total, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    const uint32_t* p = reinterpret_cast<const uint32_t*>(src + (size_t)row * D) + t;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      a[ks][h] = row < total ? p[ks * 8] : 0u;
      a[ks][h + 2] = row < total ? p[ks * 8 + 4] : 0u;
    }
  }
}

// Rows [row0, row0 + ROWS) of a (total, D) bf16 matrix into the swizzled
// tile at shared address `tile`, asynchronously, 16 bytes a copy; rows at or
// past `total` are filled with zeros (source size 0).
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(uint32_t tile, const uint16_t* __restrict__ src,
                                                int row0, int total) {
  constexpr int kVec = D / 8;  // 16-byte chunks of a row
  static_assert((ROWS * kVec) % kThreads == 0, "a tile is a whole number of copies per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kVec / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / kVec;
    const int c = idx % kVec;
    const int swz = D == 64 ? (r & 7) : ((r >> 1) & 3);
    const uint32_t dst = tile + r * (D * 2) + ((c ^ swz) << 4);
    const bool ok = row0 + r < total;
    const uint16_t* from = src + (ok ? (size_t)(row0 + r) * D + c * 8 : 0);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(from),
                 "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// floats [i0, i0 + COUNT) of `src` to shared address `dst`, one 4-byte copy
// by each of the first COUNT threads; entries at or past `total` are zero.
template <int COUNT>
__device__ __forceinline__ void load_floats_async(uint32_t dst, const float* __restrict__ src,
                                                  int i0, int total) {
  if (threadIdx.x < COUNT) {
    const bool ok = i0 + (int)threadIdx.x < total;
    const float* from = src + (ok ? i0 + (int)threadIdx.x : 0);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst + threadIdx.x * 4),
                 "l"(from), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Orders this thread's landed copies (generic proxy) before the reads of a
// later `wgmma` (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most PENDING of this warpgroup's committed groups are unfinished.
template <int PENDING = 0>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// Matrix descriptor of a swizzled tile with rows of D bf16 starting at
// shared address `addr` (a multiple of 8 rows into a 1024-byte aligned
// tile, plus 32 bytes per 16-column step of a K-major read). Eight rows are
// one swizzle atom; the stride between atoms (SBO) is 8 rows. The leading
// offset is not used while the other dimension fits one atom (D = 32 or 64).
template <int D>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  static_assert(D == 32 || D == 64, "head dims 32 and 64");
  constexpr uint64_t kSbo = (8 * D * 2) >> 4;
  constexpr uint64_t kLayout = D == 64 ? 1 : 2;  // 128-byte or 64-byte swizzle
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (1ull << 16) | (kSbo << 32) | (kLayout << 62);
}

// d (+)= a x B for one warpgroup: m64nNk16 with N = 2 * (registers of d),
// 32 or 64, a from registers, B through its descriptor; TB = 0 reads the
// tile K-major (B = tile^T: its rows are B's columns), TB = 1 MN-major
// (B = tile: its rows are the 16 summed over). `accumulate` 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TB));
}
