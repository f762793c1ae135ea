// Forward walk of one tile row of the compositor, shared by kernels B2
// (composite_fwd.cu, Layout::kStreamed) and B6 (table_fwd.cu,
// Layout::kTable): the device function, the kernel, its launch, its shared
// memory and its occupancy.
//
// Per tile row it composites the row's segment front to back, walking its
// source in `chunk`-pair chunks. Semantics of the TPU kernels
// `_streamed_fwd_kernel` (pf3plat_tpu/ops/rasterizer/streamed.py:365) and
// `_fwd_kernel` (pallas_impl.py:98):
//   * alpha = min(op * exp(min(power, 0)), alpha_clamp), zeroed unless
//     power <= 0 and alpha >= alpha_min, with the factored (px - x0) form
//     (composite_alpha.cuh);
//   * inside a chunk, T_after is T_chunk_start * exp(running sum of
//     log1p(-alpha)); a pair is alive iff T_after >= t_min, so once one
//     pair fails, every later pair of that chunk is dead; weight = T_after /
//     max(1 - alpha, 1 - alpha_clamp) * alpha;
//   * at the chunk boundary T is RESET to the T after the last alive pair
//     (the failed pair's alpha is forgotten), so T never drops below t_min
//     and the walk covers the whole segment;
//   * tchk[i] = T at the start of chunk i, written before compositing;
//     img = accum + bg * T, tfin = T.
// tfin and tchk are what the backward walk (composite_bwd_walk.cuh, B3, B5,
// B7) replays from: its forward sweep gives the same T bit for bit.
//
// The two sources (`Layout`):
//   * kStreamed (B2): the (9, plane) sorted pair array; the segment is [off,
//     off + count) of the window that starts at base * chunk, chunks i with
//     chunk * i < off + count are walked (at most n_chunks); a chunk that
//     is not walked gets tchk = 1 if it starts before the segment's end
//     (nothing composited before it), else 0 (never reached);
//   * kTable (B6): the table (rows, n_chunks * chunk, 6 + channels), slots
//     [x, y, ca, cb, cc, op, color...], zeros past the row's count; chunk i
//     is one contiguous chunk x (6 + channels) block, walked iff i * chunk <
//     count; every slot of a walked chunk takes part (the segment is [0,
//     min(count, cap)), or the whole cap where alpha_min <= 0, as in B7: an
//     empty slot has alpha 0 and changes nothing); tchk = 0 for every chunk
//     that is not walked.
//
// Bound on the card: the (pixel, pair) evaluations of the walked chunks,
// each, as first written, exp + log1p + exp on the SFU and ~20 FP32
// operations, although a few percent of them touch their pixel (alpha !=
// 0). The first designs paid all of that for every evaluation, staged each
// chunk with scalar loads between two barriers, let each lane stop at its
// own first dead pair, started the rows in launch order and ran one CTA of
// ts^2 threads. This walk, B3's forward sweep plus the colour sum:
//   * One CTA of at most 256 threads per tile row, one pixel a thread, 4
//     CTAs an SM (kFwdMinCtas: <= 64 registers; at 3 CTAs B2's build took
//     69 and the bench scene ran slower); a tile of up to 1024 pixels is
//     walked in parts, each pixel's T and colour sums kept in shared memory
//     between chunks; lanes past the tile's last pixel idle. Rows start
//     heaviest first (`order`, the wrapper's).
//   * Staging (composite_walk_common.cuh): a thread copies its own pairs'
//     rows with 4-byte cp.async one chunk ahead (B2: 9 feature rows; B6:
//     the pair's 6 + channels contiguous floats of the table row) and lays
//     them out pair-major (three float4, with the pair's power threshold)
//     in one of two buffers, so one barrier a chunk suffices. For B6 the
//     other form, the chunk's contiguous block in 16-byte copies (B7's
//     fetch) staged after a second barrier, was measured within 1% of this
//     one (faster by 0.5% on a saturating scene, slower on the bench scene;
//     PERF.md) and dropped: this one keeps a single barrier and B2's code
//     path.
//   * Per sub-block of kSub = 8 pairs: the 8 power tests (independent), then
//     pair_alpha, log1p, exp and the colour update only for the candidates
//     that pass, in order, to the first dead pair; a sub-block where no lane
//     of the warp has a candidate costs its power tests only. The test is
//     B3's, so both skip exactly the same evaluations: each adds -0 to the
//     log sum, which leaves T unchanged bit for bit, and 0 to the colour.
//   * One reciprocal of 1 - alpha in the colour weight instead of an IEEE
//     division (T is not touched by it).
// Deterministic, no atomics.
//
// The power-test skip, the cp.async prefetch and the colour update were
// each timed by a build that left that part out (the splits are in the
// history of PERF.md).

#pragma once

#include "composite_walk_common.cuh"

constexpr int kFwdMinCtas = 4;  // CTAs an SM the build is held to

// The kernels' arguments. feat: (9, plane) sorted pairs, or the table
// (rows, n_chunks * chunk, 6 + channels) for kTable; base / off: per row,
// the window and the segment's start in it (unused for kTable); count,
// tile_ids, order (the tile row of each CTA, a permutation) (rows,) i32; bg
// (rows, ch) f32; outputs img (rows, ch, p), tfin (rows, p), tchk (rows,
// n_chunks, p) f32.
struct FwdArgs {
  const float* feat;
  long long plane;
  const int32_t* base;
  const int32_t* off;
  const int32_t* count;
  const int32_t* tile_ids;
  const int32_t* order;
  const float* bg;
  int channels, tiles_x, ts, chunk, n_chunks;
  float alpha_clamp, alpha_min, one_minus_clamp, t_min;
  float* img;
  float* tfin;
  float* tchk;
};

// Shared memory of one CTA, bytes: two pair-major buffers (three float4 a
// pair, padded to whole sub-blocks), the raw rows of the chunk in flight
// (at most 9 floats a pair), and each pixel's T and colour sums where the
// tile is walked in parts. The wrappers read it through pf3_*_smem.
inline size_t composite_fwd_smem(int ts, int chunk) {
  const int p = ts * ts;
  const size_t n_pad = (size_t)walk_sub_blocks(chunk) * kSub;
  return 2 * 3 * sizeof(float4) * n_pad + sizeof(float) * kFeat * chunk +
         (walk_parts(p) > 1 ? 4 * sizeof(float) * p : 0);
}

// Start copying the 9 feature rows of the pairs this thread stages (q =
// threadIdx.x + k * blockDim.x < chunk) of the window at g0 into s_raw,
// feature-major: the thread's own cp.async.wait_all makes them visible to
// it, without a barrier.
__device__ __forceinline__ void fetch_own_pairs(float* s_raw, const float* __restrict__ feat,
                                                long long plane, long long g0, int chunk) {
  for (int q = threadIdx.x; q < chunk; q += blockDim.x) {
#pragma unroll
    for (int f = 0; f < kFeat; ++f) cp_async4(s_raw + f * chunk + q, feat + f * plane + g0 + q);
  }
  cp_async_commit();
}

// The same for a table chunk at src: the n_col contiguous floats of each of
// this thread's slots, slot-major.
__device__ __forceinline__ void fetch_own_slots(float* s_raw, const float* __restrict__ src,
                                                int chunk, int n_col) {
  for (int q = threadIdx.x; q < chunk; q += blockDim.x) {
    for (int f = 0; f < n_col; ++f) cp_async4(s_raw + q * n_col + f, src + q * n_col + f);
  }
  cp_async_commit();
}

template <Layout L>
__device__ __forceinline__ void composite_fwd_row(const FwdArgs& a) {
  constexpr bool kTable = L == Layout::kTable;
  extern __shared__ float4 sm4[];
  const int ts = a.ts;
  const int chunk = a.chunk;
  const int channels = a.channels;
  const int p = ts * ts;
  const int nt = blockDim.x;  // pixels of a part
  const int n_parts = (p + nt - 1) / nt;
  const int n_pad = walk_sub_blocks(chunk) * kSub;
  float4* s_feat = sm4;                                         // 2 x 3 * n_pad
  float* s_raw = reinterpret_cast<float*>(s_feat + 6 * n_pad);  // kFeat * chunk
  float* s_state = s_raw + kFeat * chunk;                       // 4 * p, if n_parts > 1
  const int r = a.order[blockIdx.x];
  const int l = threadIdx.x;
  const int t_img = a.tile_ids[r];
  const int x0 = (t_img % a.tiles_x) * ts;
  const int y0 = (t_img / a.tiles_x) * ts;
  const int n_col = kTable ? 6 + channels : kFeat;
  const int cap = a.n_chunks * chunk;
  const int seg_lo = kTable ? 0 : a.off[r];
  const int seg_hi = kTable ? min(a.count[r], cap) : seg_lo + a.count[r];
  const int span_hi = kTable && !(a.alpha_min > 0.0f) ? cap : seg_hi;  // pairs composited
  const long long w0 = kTable ? 0 : (long long)a.base[r] * chunk;
  const float* row_src = a.feat + (kTable ? (long long)r * cap * n_col : 0);
  // Chunk i's raw rows into s_raw.
  auto fetch = [&](int i) {
    const float* src = row_src + (long long)i * chunk * n_col;
    if (kTable) {
      fetch_own_slots(s_raw, src, chunk, n_col);
    } else {
      fetch_own_pairs(s_raw, a.feat, a.plane, w0 + (long long)i * chunk, chunk);
    }
  };

  // Chunks [i_lo, i_hi) hold the segment and are walked. Every other chunk
  // composites nothing: T = 1 at its start if it starts before the
  // segment's end, else it is never reached (0); for a table i_lo = 0, so
  // every such chunk gets 0.
  const int i_lo = seg_lo / chunk;
  const int i_hi = seg_hi > seg_lo ? min((seg_hi + chunk - 1) / chunk, a.n_chunks) : i_lo;
  float* row_chk = a.tchk + (long long)r * a.n_chunks * p;
  for (int q = l; q < a.n_chunks * p; q += nt) {
    const int i = q / p;
    if (i < i_lo || i >= i_hi) row_chk[q] = i * chunk < seg_hi ? 1.0f : 0.0f;
  }

  float T = 1.0f;
  float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f;
  if (n_parts > 1) {  // each thread's own pixels: no barrier
    for (int q = l; q < p; q += nt) {
      s_state[q] = 1.0f;
      s_state[p + q] = 0.0f;
      s_state[2 * p + q] = 0.0f;
      s_state[3 * p + q] = 0.0f;
    }
  }
  if (i_lo < i_hi) fetch(i_lo);
  for (int i = i_lo; i < i_hi; ++i) {
    float4* fs_buf = s_feat + 3 * n_pad * ((i - i_lo) & 1);
    cp_async_wait_all();  // this thread's copies of chunk i are in
    for (int q = l; q < n_pad; q += nt) {
      stage_pair(fs_buf, s_raw, q, chunk, kTable ? 1 : chunk, kTable ? n_col : 1, channels,
                 a.alpha_min);
    }
    // Chunk i is staged, and every thread is past chunk i - 1, whose
    // buffer chunk i + 1 takes.
    __syncthreads();
    if (i + 1 < i_hi) fetch(i + 1);
    const int j_lo = max(seg_lo - i * chunk, 0);
    const int j_hi = min(span_hi - i * chunk, chunk);
    const int sb_lo = j_lo / kSub;
    const int sb_hi = (j_hi + kSub - 1) / kSub;

    for (int part = 0; part < n_parts; ++part) {
      const int pix = part * nt + l;
      const bool valid = pix < p;
      if (n_parts > 1 && valid) {
        T = s_state[pix];
        acc0 = s_state[p + pix];
        acc1 = s_state[2 * p + pix];
        acc2 = s_state[3 * p + pix];
      }
      const float px = (float)(x0 + pix % ts) + 0.5f;
      const float py = (float)(y0 + pix / ts) + 0.5f;
      if (valid) row_chk[(long long)i * p + pix] = T;
      const float t0 = T;
      float incl = 0.0f;
      bool live = valid;
      for (int sb = sb_lo; sb < sb_hi; ++sb) {
        const float4* fs = fs_buf + 3 * sb * kSub;
        uint32_t cand = 0;
        if (live) {
#pragma unroll
          for (int s = 0; s < kSub; ++s) {
            const float power = pair_power(px, py, fs[3 * s], fs[3 * s + 1].x);
            if (!(power < fs[3 * s + 1].z)) cand |= 1u << s;
          }
          cand &= span_bits(j_lo - sb * kSub, j_hi - sb * kSub);
        }
        if (!__any_sync(0xffffffffu, cand != 0)) continue;
        while (cand) {
          const int s = __ffs(cand) - 1;
          cand &= cand - 1;
          const float4 fa = fs[3 * s];
          const float4 fb = fs[3 * s + 1];
          const float alpha = pair_alpha(px, py, fa.x, fa.y, fa.z, fa.w, fb.x, fb.y,
                                         a.alpha_clamp, a.alpha_min).alpha;
          if (alpha == 0.0f) continue;
          incl += log1pf(-alpha);
          const float t_after = t0 * expf(incl);
          if (!(t_after >= a.t_min)) {  // every later pair of the chunk is dead
            live = false;
            break;
          }
          const float4 fc = fs[3 * s + 2];
          const float w =
              t_after * __fdividef(1.0f, fmaxf(1.0f - alpha, a.one_minus_clamp)) * alpha;
          acc0 += w * fb.w;
          acc1 += w * fc.x;
          acc2 += w * fc.y;
          T = t_after;  // the T after the chunk's last alive pair, so far
        }
      }
      if (n_parts > 1 && valid) {
        s_state[pix] = T;
        s_state[p + pix] = acc0;
        s_state[2 * p + pix] = acc1;
        s_state[3 * p + pix] = acc2;
      }
    }
  }

  for (int part = 0; part < n_parts; ++part) {
    const int pix = part * nt + l;
    if (pix >= p) break;
    if (n_parts > 1) {
      T = s_state[pix];
      acc0 = s_state[p + pix];
      acc1 = s_state[2 * p + pix];
      acc2 = s_state[3 * p + pix];
    }
    const float acc[3] = {acc0, acc1, acc2};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < channels)
        a.img[((long long)r * channels + c) * p + pix] = acc[c] + a.bg[r * channels + c] * T;
    }
    a.tfin[(long long)r * p + pix] = T;
  }
}

template <Layout L>
__global__ void __launch_bounds__(kMaxThreads, kFwdMinCtas) composite_fwd_kernel(
    const __grid_constant__ FwdArgs a) {
  composite_fwd_row<L>(a);
}

template <Layout L>
cudaError_t composite_fwd_configure(int ts, int chunk) {
  const size_t smem = composite_fwd_smem(ts, chunk);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(composite_fwd_kernel<L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch one CTA per tile row (FwdArgs); ts * ts at most kMaxPixels.
template <Layout L>
int composite_fwd_launch(const FwdArgs& a, int rows, void* stream) {
  const int p = a.ts * a.ts;
  if (p <= 0 || p > kMaxPixels || a.chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = composite_fwd_configure<L>(a.ts, a.chunk);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    composite_fwd_kernel<L><<<rows, walk_threads(p), composite_fwd_smem(a.ts, a.chunk),
                              static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

// CTAs of the kernel that fit one SM at this tile size and chunk (registers
// and shared memory as built); negative on an error.
template <Layout L>
int composite_fwd_occupancy(int ts, int chunk) {
  int ctas = 0;
  cudaError_t e = composite_fwd_configure<L>(ts, chunk);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, composite_fwd_kernel<L>, walk_threads(ts * ts), composite_fwd_smem(ts, chunk));
  }
  return e == cudaSuccess ? ctas : -(int)e;
}
