// Long-sequence attention, backward (kernel L backward), sm_90a.
//
// Replaces the backward of `pf3plat_tpu/models/layers.py:_flash_attention`
// (JAX's TPU flash attention kernel: a dk/dv pass and a dq pass). Inputs:
// q, k, v and the output's cotangent dO rounded to bf16, the forward's f32
// output and per-row log-sum-exp. Per key block the probabilities are
// recomputed, P = exp(q k^T * scale - lse), and with
// delta = rowsum(dO * out), dP = dO v^T, dS = P * (dP - delta):
//   dv = P^T dO,   dk = scale * dS^T q,   dq = scale * dS k,
// P and dS rounded to bf16 before these products, all sums in f32.
//
// Three launches, no atomics, so the result is the same on every run:
//   1. delta: one warp per query row;
//   2. dk, dv: one CTA of 4 warps owns 64 key rows (16 a warp) and walks the
//      queries in blocks of 64. It forms the TRANSPOSED logits k q^T, so the
//      C fragments of P^T and dS^T are, rounded, the A fragments of
//      P^T dO and dS^T q (attention_mma.cuh);
//   3. dq: one CTA owns 64 query rows and walks the keys in blocks of 64,
//      with the logits the forward's way round.
//
// Bound on the card: operations, 10 n m d per (batch, head) on the tensor
// cores (five products of 2 n m d, two of them recomputed logits), which is
// 2.5 times the forward. The plan is the forward's: `mma.sync` tiles from
// shared memory, nothing overlapped yet.

#include "attention_mma.cuh"

namespace {

// delta[row] = sum_d dO[row][d] * out[row][d]
__global__ void attention_delta_kernel(const uint16_t* __restrict__ d_out,
                                       const float* __restrict__ out, float* __restrict__ delta,
                                       long long rows, int d) {
  const long long row = (long long)blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.0f;
  for (int c = lane; c < d; c += 32) {
    const float g = __uint_as_float((uint32_t)d_out[row * d + c] << 16);
    s += g * out[row * d + c];
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) delta[row] = s;
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_dkdv_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ d_out,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int n, int m, float scale) {
  __shared__ Tile<D> s_k, s_v, s_q, s_do;
  __shared__ float s_lse[kTile], s_delta[kTile];
  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  q += (size_t)bh * n * D;
  d_out += (size_t)bh * n * D;
  k += (size_t)bh * m * D;
  v += (size_t)bh * m * D;
  lse += (size_t)bh * n;
  delta += (size_t)bh * n;

  load_tile<D>(s_k, k, key0, m);
  load_tile<D>(s_v, v, key0, m);
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a<D>(kf[ks], s_k, warp * 16, ks * 16, g, t);
    load_a<D>(vf[ks], s_v, warp * 16, ks * 16, g, t);
  }
  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.0f;
  }
  // this lane's key rows: g and g + 8 of the warp's 16
  const bool key_ok[2] = {key0 + warp * 16 + g < m, key0 + warp * 16 + g + 8 < m};

  for (int q0 = 0; q0 < n; q0 += kTile) {
    __syncthreads();  // the previous block's tiles are read
    load_tile<D>(s_q, q, q0, n);
    load_tile<D>(s_do, d_out, q0, n);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      // a query row past n gets probability exp(-inf) = 0
      s_lse[threadIdx.x] = row < n ? lse[row] : INFINITY;
      s_delta[threadIdx.x] = row < n ? delta[row] : 0.0f;
    }
    __syncthreads();

    // transposed logits (keys x queries) and dP^T = v dO^T
    float st[kTile / 8][4], dpt[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0, b1;
        load_b_nt<D>(b0, b1, s_q, nt * 8, ks * 16, g, t);
        mma_bf16(st[nt], kf[ks], b0, b1);
        load_b_nt<D>(b0, b1, s_do, nt * 8, ks * 16, g, t);
        mma_bf16(dpt[nt], vf[ks], b0, b1);
      }
    }

    // P^T in st, dS^T in dpt
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);  // query within the block
        const float p = key_ok[e >> 1] ? __expf(st[nt][e] * scale - s_lse[col]) : 0.0f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - s_delta[col]);
      }
    }

    // dv += P^T dO, dk += dS^T q over the block's 64 queries
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t pf[4], dsf[4];
      c_to_a(pf, st[2 * ks], st[2 * ks + 1]);
      c_to_a(dsf, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_nn<D>(b0, b1, s_do, ks * 16, dt * 8, g, t);
        mma_bf16(acc_v[dt], pf, b0, b1);
        load_b_nn<D>(b0, b1, s_q, ks * 16, dt * 8, g, t);
        mma_bf16(acc_k[dt], dsf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key0 + warp * 16 + g + 8 * h;
    if (row < m) {
      float* dst_k = dk + ((size_t)bh * m + row) * D;
      float* dst_v = dv + ((size_t)bh * m + row) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<float2*>(dst_k + dt * 8 + 2 * t) =
            make_float2(acc_k[dt][2 * h] * scale, acc_k[dt][2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dst_v + dt * 8 + 2 * t) =
            make_float2(acc_v[dt][2 * h], acc_v[dt][2 * h + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) attention_dq_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ d_out,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int n, int m, float scale) {
  __shared__ Tile<D> s_q, s_do, s_k, s_v;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  q += (size_t)bh * n * D;
  d_out += (size_t)bh * n * D;
  k += (size_t)bh * m * D;
  v += (size_t)bh * m * D;
  lse += (size_t)bh * n;
  delta += (size_t)bh * n;

  load_tile<D>(s_q, q, q0, n);
  load_tile<D>(s_do, d_out, q0, n);
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    load_a<D>(qf[ks], s_q, warp * 16, ks * 16, g, t);
    load_a<D>(dof[ks], s_do, warp * 16, ks * 16, g, t);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.0f;
  }
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    row_lse[h] = row < n ? lse[row] : INFINITY;  // rows past n: probability 0
    row_delta[h] = row < n ? delta[row] : 0.0f;
  }

  for (int k0 = 0; k0 < m; k0 += kTile) {
    __syncthreads();  // the previous block's tiles are read
    load_tile<D>(s_k, k, k0, m);
    load_tile<D>(s_v, v, k0, m);
    __syncthreads();

    float s[kTile / 8][4], dp[kTile / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t b0, b1;
        load_b_nt<D>(b0, b1, s_k, nt * 8, ks * 16, g, t);
        mma_bf16(s[nt], qf[ks], b0, b1);
        load_b_nt<D>(b0, b1, s_v, nt * 8, ks * 16, g, t);
        mma_bf16(dp[nt], dof[ks], b0, b1);
      }
    }

    // dS in dp
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int h = e >> 1;
        const float p = col < m ? __expf(s[nt][e] * scale - row_lse[h]) : 0.0f;
        dp[nt][e] = p * (dp[nt][e] - row_delta[h]);
      }
    }

    // dq += dS k over the block's 64 keys
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      uint32_t dsf[4];
      c_to_a(dsf, dp[2 * ks], dp[2 * ks + 1]);
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b0, b1;
        load_b_nn<D>(b0, b1, s_k, ks * 16, dt * 8, g, t);
        mma_bf16(acc[dt], dsf, b0, b1);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + g + 8 * h;
    if (row < n) {
      float* dst = dq + ((size_t)bh * n + row) * D;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<float2*>(dst + dt * 8 + 2 * t) =
            make_float2(acc[dt][2 * h] * scale, acc[dt][2 * h + 1] * scale);
      }
    }
  }
}

template <int D>
int launch(const uint16_t* q, const uint16_t* k, const uint16_t* v, const uint16_t* d_out,
           const float* out, const float* lse, float* delta, float* dq, float* dk, float* dv,
           int bh, int n, int m, float scale, cudaStream_t s) {
  const long long rows = (long long)bh * n;
  attention_delta_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, s>>>(d_out, out, delta, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_dkdv_kernel<D><<<dim3((m + kTile - 1) / kTile, bh), kThreads, 0, s>>>(
      q, k, v, d_out, lse, delta, dk, dv, n, m, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_dq_kernel<D><<<dim3((n + kTile - 1) / kTile, bh), kThreads, 0, s>>>(
      q, k, v, d_out, lse, delta, dq, n, m, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, d_out (bh, n, d), k and v (bh, m, d) bf16, contiguous, 16-byte aligned;
// out (bh, n, d), lse (bh, n) f32 from the forward; delta (bh, n) f32
// scratch; outputs dq (bh, n, d), dk and dv (bh, m, d) f32. d is 32 or 64.
// Returns the CUDA error code, or -1 for a head dim the kernel is not built
// for.
extern "C" int pf3_attention_bwd(const void* q, const void* k, const void* v, const void* d_out,
                                 const void* out, const void* lse, void* delta, void* dq,
                                 void* dk, void* dv, int bh, int n, int m, int d, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || n <= 0 || m <= 0) return -1;
  const uint16_t* qp = static_cast<const uint16_t*>(q);
  const uint16_t* kp = static_cast<const uint16_t*>(k);
  const uint16_t* vp = static_cast<const uint16_t*>(v);
  const uint16_t* gp = static_cast<const uint16_t*>(d_out);
  const float* op = static_cast<const float*>(out);
  const float* lp = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* dqp = static_cast<float*>(dq);
  float* dkp = static_cast<float*>(dk);
  float* dvp = static_cast<float*>(dv);
  if (d == 32) return launch<32>(qp, kp, vp, gp, op, lp, dl, dqp, dkp, dvp, bh, n, m, scale, s);
  if (d == 64) return launch<64>(qp, kp, vp, gp, op, lp, dl, dqp, dkp, dvp, bh, n, m, scale, s);
  return -1;
}
