// Long-sequence attention, backward (kernel L backward), sm_90a.
//
// Replaces the backward of `pf3plat_tpu/models/layers.py:_flash_attention`
// (JAX's TPU flash attention kernel: a dk/dv pass and a dq pass). Inputs:
// q, k, v and the output's cotangent dO rounded to bf16, the forward's f32
// output and per-row log-sum-exp (natural log). Per block the probabilities
// are recomputed, P = exp(q k^T * scale - lse), and with
// delta = rowsum(dO * out), dP = dO v^T, dS = P * (dP - delta):
//   dv = P^T dO,   dk = scale * dS^T q,   dq = scale * dS k,
// P and dS rounded to bf16 before these products, all sums in f32.
//
// Three launches, no atomics, so the result is the same on every run:
//   1. delta: one warp per query row;
//   2. dk, dv: a CTA owns 128 key rows and walks the queries in tiles of
//      kWalk (taken in parts of kPart columns). It forms the TRANSPOSED
//      logits k q^T and v dO^T, so the accumulators of P^T and dS^T are,
//      rounded, the register A operands of P^T dO and dS^T q;
//   3. dq: a CTA owns 128 query rows and walks the keys in tiles of kWalk,
//      with the logits the forward's way round.
//
// Bound on the card: at head dim 32 the two passes' 2 n m exponentials per
// head beside 14 n m d tensor-core operations (seven products of 2 n m d,
// where one pass with atomics would need five); the bytes are far below.
//
// Design: the forward's building blocks (attention_mma.cuh). The resident
// rows (K and V, or Q and dO) are A fragments in registers, read once from
// device memory. The walked tiles (Q and dO with their lse and delta, or K
// and V) pass through a ring of kStages stages in shared memory filled by
// `cp.async` with zero fill past the end (`cp.async` rather than TMA for
// the forward's reasons). Every product is a `wgmma.mma_async` chain with
// the walked tile as B: K-major for the logits, MN-major (transpose bit)
// for the accumulating products. 2^(s c - lse log2(e)) with c = scale *
// log2(e) is one fused multiply-add and one `ex2` per probability. Within a
// warpgroup, products and weights of a tile run one after the other; they
// overlap with the other warpgroups on the SM (two CTAs at head dim 32).
// Starting the next tile's logits ahead of this tile's sums, as the forward
// does, raised the registers past two CTAs an SM and was slower on the H100
// at head dim 32, the only one a path runs.
//
// Ragged ends: a resident row past the end is zero, its sums stay in its own
// accumulator rows and are never stored. A walked query row past n is zero
// with lse and delta read as 0, so its probability is 1, its dS 0, and both
// multiply a zero row of dO or Q. A walked key row past m is zero too, but
// its probability 2^(-lse log2(e)) need not be finite: the dq pass sets it
// to 0 in the last block.

#include "attention_mma.cuh"

namespace {

constexpr int kWalk = 64;   // rows of a walked tile
constexpr int kStages = 3;  // tiles of the ring: two in flight behind the one multiplied

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

// a dk/dv stage: Q tile, dO tile, lse and delta of the tile's rows
template <int D>
constexpr int dkdv_stage_bytes() {
  return 2 * kWalk * D * 2 + 2 * kWalk * 4;
}

// a dq stage: K tile, V tile
template <int D>
constexpr int dq_stage_bytes() {
  return 2 * kWalk * D * 2;
}

// The dk/dv pass takes a walked tile in parts of kPart query columns: at
// head dim 32 two parts of 32 keep it at <= 128 registers, so two CTAs share
// an SM (faster on the H100 than one part of 64 at one CTA an SM); at head
// dim 64 the resident fragments and sums alone allow only one CTA, and one
// part of 64 is the faster.
template <int D>
constexpr int kDkdvPart = D == 32 ? 32 : 64;

template <int D>
__global__ void __launch_bounds__(kThreads, D == 32 ? 2 : 1) attention_dkdv_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ d_out,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int n, int m, float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTileBytes = kWalk * D * 2;
  constexpr int kPart = kDkdvPart<D>;
  // tiles first, so that each stays 1024-byte aligned; then the row values
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t ring = aligned_smem(smem_raw);
  const uint32_t rows_at = ring + kStages * 2 * kTileBytes;
  const float* s_rows = reinterpret_cast<const float*>(smem_raw + (rows_at - raw));
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kCtaRows + warp * 16;  // this warp's 16 key rows
  q += (size_t)bh * n * D;
  d_out += (size_t)bh * n * D;
  k += (size_t)bh * m * D;
  v += (size_t)bh * m * D;
  lse += (size_t)bh * n;
  delta += (size_t)bh * n;

  const int blocks = (n + kWalk - 1) / kWalk;
  auto fetch = [&](int blk) {
    if (blk < blocks) {
      const int st = blk % kStages;
      const uint32_t stage = ring + st * 2 * kTileBytes;
      load_tile_async<D, kWalk>(stage, q, blk * kWalk, n);
      load_tile_async<D, kWalk>(stage + kTileBytes, d_out, blk * kWalk, n);
      load_floats_async<kWalk>(rows_at + st * 2 * kWalk * 4, lse, blk * kWalk, n);
      load_floats_async<kWalk>(rows_at + (st * 2 + 1) * kWalk * 4, delta, blk * kWalk, n);
    }
    cp_async_commit();  // one group a block, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a_global<D>(kf, k, row0, m, g, t);
  load_a_global<D>(vf, v, row0, m, g, t);
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.0f;
  const float c = scale * kLog2e;

  for (int blk = 0; blk < blocks; ++blk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of block blk landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed; everyone is done with block blk - 1
    fetch(blk + kStages - 1);
    const int st = blk % kStages;
    const uint32_t stage = ring + st * 2 * kTileBytes;
    const uint64_t desc_q = tile_desc<D>(stage);
    const uint64_t desc_do = tile_desc<D>(stage + kTileBytes);
    const float* s_lse = s_rows + st * 2 * kWalk;
    const float* s_delta = s_lse + kWalk;

    // the tile's queries in parts of kPart columns
#pragma unroll
    for (int part = 0; part < kWalk / kPart; ++part) {
      constexpr int kRowStep = (D * 2) >> 4;  // descriptor units of one tile row
      const uint64_t part_q = desc_q + part * kPart * kRowStep;
      const uint64_t part_do = desc_do + part * kPart * kRowStep;

      // transposed logits (keys x queries) and dP^T = v dO^T
      float st_[kPart / 2], dpt[kPart / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_rs<0>(st_, kf[ks], part_q + ks * 2, ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) wgmma_rs<0>(dpt, vf[ks], part_do + ks * 2, ks > 0);
      wgmma_commit();
      wgmma_wait();

      // P^T in st_, dS^T in dpt; this lane's query columns are 8j + 2t, + 1
#pragma unroll
      for (int j = 0; j < kPart / 8; ++j) {
        const int col = part * kPart + 8 * j + 2 * t;
        const float2 l = *reinterpret_cast<const float2*>(s_lse + col);
        const float2 dl = *reinterpret_cast<const float2*>(s_delta + col);
        const float l0 = l.x * kLog2e, l1 = l.y * kLog2e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float p0 = fast_exp2(fmaf(st_[4 * j + 2 * h], c, -l0));
          const float p1 = fast_exp2(fmaf(st_[4 * j + 2 * h + 1], c, -l1));
          st_[4 * j + 2 * h] = p0;
          st_[4 * j + 2 * h + 1] = p1;
          dpt[4 * j + 2 * h] = p0 * (dpt[4 * j + 2 * h] - dl.x);
          dpt[4 * j + 2 * h + 1] = p1 * (dpt[4 * j + 2 * h + 1] - dl.y);
        }
      }

      // dv += P^T dO, dk += dS^T q over the part's queries
      uint32_t pf[kPart / 16][4], dsf[kPart / 16][4];
#pragma unroll
      for (int ks = 0; ks < kPart / 16; ++ks) {
        acc_to_a(pf[ks], st_ + 8 * ks);
        acc_to_a(dsf[ks], dpt + 8 * ks);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kPart / 16; ++ks) {
        wgmma_rs<1>(acc_v, pf[ks], part_do + ks * 16 * kRowStep, 1);
      }
#pragma unroll
      for (int ks = 0; ks < kPart / 16; ++ks) {
        wgmma_rs<1>(acc_k, dsf[ks], part_q + ks * 16 * kRowStep, 1);
      }
      wgmma_commit();
      wgmma_wait();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < m) {
      float* dst_k = dk + ((size_t)bh * m + row) * D;
      float* dst_v = dv + ((size_t)bh * m + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dst_k + j * 8 + 2 * t) =
            make_float2(acc_k[4 * j + 2 * h] * scale, acc_k[4 * j + 2 * h + 1] * scale);
        *reinterpret_cast<float2*>(dst_v + j * 8 + 2 * t) =
            make_float2(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) attention_dq_kernel(
    const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
    const uint16_t* __restrict__ v, const uint16_t* __restrict__ d_out,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int n, int m, float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTileBytes = kWalk * D * 2;
  const uint32_t ring = aligned_smem(smem_raw);
  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kCtaRows + warp * 16;  // this warp's 16 query rows
  q += (size_t)bh * n * D;
  d_out += (size_t)bh * n * D;
  k += (size_t)bh * m * D;
  v += (size_t)bh * m * D;
  lse += (size_t)bh * n;
  delta += (size_t)bh * n;

  const int blocks = (m + kWalk - 1) / kWalk;
  auto fetch = [&](int blk) {
    if (blk < blocks) {
      const uint32_t stage = ring + (blk % kStages) * 2 * kTileBytes;
      load_tile_async<D, kWalk>(stage, k, blk * kWalk, m);
      load_tile_async<D, kWalk>(stage + kTileBytes, v, blk * kWalk, m);
    }
    cp_async_commit();  // one group a block, empty past the end
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) fetch(s);

  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a_global<D>(qf, q, row0, n, g, t);
  load_a_global<D>(dof, d_out, row0, n, g, t);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  const float c = scale * kLog2e;
  float row_lse[2], row_delta[2];  // rows g and g + 8; lse in base 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    row_lse[h] = row < n ? lse[row] * kLog2e : 0.0f;
    row_delta[h] = row < n ? delta[row] : 0.0f;
  }

  for (int blk = 0; blk < blocks; ++blk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of block blk landed
    fence_proxy_async();
    __syncthreads();  // everyone's landed; everyone is done with block blk - 1
    fetch(blk + kStages - 1);
    const uint32_t stage = ring + (blk % kStages) * 2 * kTileBytes;
    const uint64_t desc_k = tile_desc<D>(stage);
    const uint64_t desc_v = tile_desc<D>(stage + kTileBytes);

    float s[kWalk / 2], dp[kWalk / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_rs<0>(s, qf[ks], desc_k + ks * 2, ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) wgmma_rs<0>(dp, dof[ks], desc_v + ks * 2, ks > 0);
    wgmma_commit();
    wgmma_wait();

    // dS in dp; key columns past m (only in the last block) get probability 0
    const int k0 = blk * kWalk;
    const bool ragged = k0 + kWalk > m;
#pragma unroll
    for (int i = 0; i < kWalk / 2; ++i) {
      const int h = (i >> 1) & 1;
      float p = fast_exp2(fmaf(s[i], c, -row_lse[h]));
      if (ragged && k0 + (i >> 2) * 8 + 2 * t + (i & 1) >= m) p = 0.0f;
      dp[i] = p * (dp[i] - row_delta[h]);
    }

    // dq += dS k over the tile's keys
    uint32_t dsf[kWalk / 16][4];
#pragma unroll
    for (int ks = 0; ks < kWalk / 16; ++ks) acc_to_a(dsf[ks], dp + 8 * ks);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWalk / 16; ++ks) {
      wgmma_rs<1>(acc, dsf[ks], desc_k + ks * ((16 * D * 2) >> 4), 1);
    }
    wgmma_commit();
    wgmma_wait();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row < n) {
      float* dst = dq + ((size_t)bh * n + row) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) =
            make_float2(acc[4 * j + 2 * h] * scale, acc[4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

template <int D>
constexpr int dkdv_smem() {
  return kStages * dkdv_stage_bytes<D>() + 1024;
}

template <int D>
constexpr int dq_smem() {
  return kStages * dq_stage_bytes<D>() + 1024;
}

// Allows both passes their dynamic shared memory, once.
template <int D>
cudaError_t configure() {
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      attention_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      attention_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  return attr_kv != cudaSuccess ? attr_kv : attr_q;
}

template <int D>
int launch(const uint16_t* q, const uint16_t* k, const uint16_t* v, const uint16_t* d_out,
           const float* out, const float* lse, float* delta, float* dq, float* dk, float* dv,
           int bh, int n, int m, float scale, cudaStream_t s) {
  if (configure<D>() != cudaSuccess) return (int)configure<D>();
  const long long rows = (long long)bh * n;
  attention_delta_kernel<<<(unsigned)((rows + 3) / 4), 128, 0, s>>>(d_out, out, delta, rows, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_dkdv_kernel<D><<<dim3((m + kCtaRows - 1) / kCtaRows, bh), kThreads, dkdv_smem<D>(),
                             s>>>(q, k, v, d_out, lse, delta, dk, dv, n, m, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_dq_kernel<D><<<dim3((n + kCtaRows - 1) / kCtaRows, bh), kThreads, dq_smem<D>(), s>>>(
      q, k, v, d_out, lse, delta, dq, n, m, scale);
  return (int)cudaGetLastError();
}

template <int D>
int occupancy(int pass) {
  int ctas = 0;
  cudaError_t e = configure<D>();
  if (e == cudaSuccess) {
    e = pass == 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &ctas, attention_dkdv_kernel<D>, kThreads, dkdv_smem<D>())
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &ctas, attention_dq_kernel<D>, kThreads, dq_smem<D>());
  }
  return e == cudaSuccess ? ctas : -(int)e;
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

// CTAs that fit one SM at head dim d for the dk/dv pass (pass 0) or the dq
// pass (pass 1), registers and shared memory as built; negative on an error
// or an unknown head dim.
extern "C" int pf3_attention_bwd_occupancy(int d, int pass) {
  if (d == 32) return occupancy<32>(pass);
  if (d == 64) return occupancy<64>(pass);
  return -1;
}
