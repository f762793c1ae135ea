// Building blocks of the attention kernels (attention_fwd.cu,
// attention_bwd.cu): the bf16 tensor-core product of one warp
// (`mma.sync.m16n8k16`, f32 accumulation), shared-memory tiles of 64 rows,
// and the fragment loads that feed the product from them.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row):  a0 = A[g][2t, 2t+1]      a1 = A[g+8][2t, 2t+1]
//                      a2 = A[g][2t+8, 2t+9]    a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, col):   b0 = B[2t, 2t+1][g]      b1 = B[2t+8, 2t+9][g]
//   C (16 x 8):        c0, c1 = C[g][2t, 2t+1]  c2, c3 = C[g+8][2t, 2t+1]
// Each 32-bit register holds two bf16 values, the lower index in the low
// half. Two neighbouring C tiles (16 columns) are therefore, rounded to
// bf16, exactly one A fragment: a0, a1 from the left tile's (c0, c1),
// (c2, c3) and a2, a3 from the right tile's. That is how the probabilities
// of one product feed the next without leaving the registers.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kTile = 64;     // rows of a shared-memory tile (queries or keys)
constexpr int kThreads = 128; // 4 warps, 16 rows of the output tile each
constexpr int kPad = 8;       // bf16 of padding per row: conflict-free fragment loads

// bf16 values are kept as their 16 bits in shared memory.
template <int D>
struct __align__(16) Tile {
  uint16_t v[kTile][D + kPad];
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

// Rows [row0, row0 + 64) of a (total, D) bf16 matrix into a tile, 16 bytes
// a thread; rows at or past `total` are zero.
template <int D>
__device__ __forceinline__ void load_tile(Tile<D>& dst, const uint16_t* __restrict__ src,
                                          int row0, int total) {
  constexpr int kVec = D / 8;
  for (int idx = threadIdx.x; idx < kTile * kVec; idx += kThreads) {
    const int r = idx / kVec;
    const int c = idx - r * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < total) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(&dst.v[r][c * 8]) = val;
  }
}

// A fragment: A[i][k] = tile[row0 + i][k0 + k].
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const Tile<D>& tile, int row0, int k0,
                                       int g, int t) {
  a[0] = *reinterpret_cast<const uint32_t*>(&tile.v[row0 + g][k0 + 2 * t]);
  a[1] = *reinterpret_cast<const uint32_t*>(&tile.v[row0 + g + 8][k0 + 2 * t]);
  a[2] = *reinterpret_cast<const uint32_t*>(&tile.v[row0 + g][k0 + 2 * t + 8]);
  a[3] = *reinterpret_cast<const uint32_t*>(&tile.v[row0 + g + 8][k0 + 2 * t + 8]);
}

// B fragment of a product with the tile transposed: B[k][n] = tile[n0 + n][k0 + k].
template <int D>
__device__ __forceinline__ void load_b_nt(uint32_t& b0, uint32_t& b1, const Tile<D>& tile, int n0,
                                          int k0, int g, int t) {
  b0 = *reinterpret_cast<const uint32_t*>(&tile.v[n0 + g][k0 + 2 * t]);
  b1 = *reinterpret_cast<const uint32_t*>(&tile.v[n0 + g][k0 + 2 * t + 8]);
}

// B fragment of a product with the tile as it lies: B[k][n] = tile[k0 + k][n0 + n].
template <int D>
__device__ __forceinline__ void load_b_nn(uint32_t& b0, uint32_t& b1, const Tile<D>& tile, int k0,
                                          int n0, int g, int t) {
  b0 = pack_raw(tile.v[k0 + 2 * t][n0 + g], tile.v[k0 + 2 * t + 1][n0 + g]);
  b1 = pack_raw(tile.v[k0 + 2 * t + 8][n0 + g], tile.v[k0 + 2 * t + 9][n0 + g]);
}

// Two neighbouring C tiles, rounded to bf16, as one A fragment.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&left)[4],
                                       const float (&right)[4]) {
  a[0] = pack_bf16(left[0], left[1]);
  a[1] = pack_bf16(left[2], left[3]);
  a[2] = pack_bf16(right[0], right[1]);
  a[3] = pack_bf16(right[2], right[3]);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
