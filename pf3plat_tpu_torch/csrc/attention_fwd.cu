// Long-sequence attention, forward (kernel L forward), sm_90a.
//
// Replaces `pf3plat_tpu/models/layers.py:_flash_attention` (JAX's TPU flash
// attention kernel, forward): out = softmax(q k^T * scale) v per (batch,
// head) without ever writing the (n, m) logits to device memory. q, k, v
// arrive rounded to bf16; logits, the running maximum and the running sum
// are f32; the probabilities are rounded to bf16 before the second product,
// which accumulates in f32. The per-row log-sum-exp of the scaled logits is
// saved for the backward. Any n and m: rows past the end of a tile are read
// as zeros, key columns past m get probability 0, query rows past n are not
// stored.
//
// Bound on the card: operations, 4 n m d per (batch, head) on the tensor
// cores (the bytes are q, k, v read once and out written once, far below).
// Design: the simple FlashAttention-2 plan on `mma.sync` tiles. One CTA of 4
// warps owns 64 query rows (16 a warp) and walks the keys in blocks of 64.
// The query fragments stay in registers; each key block's K and V tiles are
// staged in shared memory; S = Q K^T lands in C fragments, the online
// softmax runs on them in registers (a row lives in one quad of lanes), and
// the rounded probabilities are reused as the A fragments of P V
// (attention_mma.cuh). No `wgmma`, TMA or pipelining yet: loads and
// products of a block do not overlap.

#include "attention_mma.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kThreads) attention_fwd_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, float* __restrict__ out, float* __restrict__ lse, int n,
    int m, float scale) {
  __shared__ Tile<D> s_q, s_k, s_v;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  q += (size_t)bh * n * D;
  k += (size_t)bh * m * D;
  v += (size_t)bh * m * D;

  load_tile<D>(s_q, q, q0, n);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) load_a<D>(qf[ks], s_q, warp * 16, ks * 16, g, t);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  }
  float row_max[2] = {-INFINITY, -INFINITY};  // rows g and g + 8 of the warp's 16
  float row_sum[2] = {0.0f, 0.0f};            // this lane's share of the row's sum

  for (int k0 = 0; k0 < m; k0 += kTile) {
    __syncthreads();  // the previous block's tiles are read
    load_tile<D>(s_k, k, k0, m);
    load_tile<D>(s_v, v, k0, m);
    __syncthreads();

    float s[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0, b1;
        load_b_nt<D>(b0, b1, s_k, nt * 8, ks * 16, g, t);
        mma_bf16(s[nt], qf[ks], b0, b1);
      }
    }

    // scaled logits, key columns past m masked out
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        s[nt][e] = col < m ? s[nt][e] * scale : -INFINITY;
      }
    }

    // online softmax per row; a block always holds at least one real key,
    // so the new maximum is finite
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
      mx = quad_max(mx);
      const float new_max = fmaxf(row_max[h], mx);
      const float corr = __expf(row_max[h] - new_max);
      float part = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt) {
        const float p0 = __expf(s[nt][2 * h] - new_max);
        const float p1 = __expf(s[nt][2 * h + 1] - new_max);
        s[nt][2 * h] = p0;
        s[nt][2 * h + 1] = p1;
        part += p0 + p1;
      }
      row_sum[h] = row_sum[h] * corr + part;
      row_max[h] = new_max;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        acc[dt][2 * h] *= corr;
        acc[dt][2 * h + 1] *= corr;
      }
    }

    // acc += P V, the probabilities rounded to bf16
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t pf[4];
      c_to_a(pf, s[2 * ks], s[2 * ks + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_nn<D>(b0, b1, s_v, ks * 16, dt * 8, g, t);
        mma_bf16(acc[dt], pf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float total = quad_sum(row_sum[h]);
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row < n) {
      const float inv = 1.0f / total;
      float* dst = out + ((size_t)bh * n + row) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<float2*>(dst + dt * 8 + 2 * t) =
            make_float2(acc[dt][2 * h] * inv, acc[dt][2 * h + 1] * inv);
      }
      if (t == 0) lse[(size_t)bh * n + row] = row_max[h] + logf(total);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int n,
           int m, float scale, cudaStream_t s) {
  const dim3 grid((n + kTile - 1) / kTile, bh);
  attention_fwd_kernel<D><<<grid, kThreads, 0, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<float*>(out), static_cast<float*>(lse), n, m,
      scale);
  return (int)cudaGetLastError();
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
