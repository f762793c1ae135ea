// Reverse walk of one tile row of the compositor, shared by kernels B3
// (composite_bwd.cu), B5 (composite_bwd_blocks.cu) and B7 (table_bwd.cu):
// the device function, the kernel, its launch, its shared memory and its
// occupancy.
//
// Per tile row it replays, in reverse, the chunks the forward (B2 or B6)
// processed (`nproc`, from the checkpoints) and forms the per-pair
// gradients of [x, y, ca, cb, cc, op, c0..c2], plus d(background) per
// tile. Semantics of the TPU kernels' `_bwd_chunk_grads`
// (pf3plat_tpu/ops/rasterizer/streamed.py:523) and `_bwd_kernel`
// (pallas_impl.py:187):
//   * gt = sum_c bg_c g_c (+ g_tfin, the cotangent of T_final, for B7);
//     dbg = sum_pixels g tfin; tail starts at tfin gt;
//   * chunk i starts from its checkpoint tchk[i]; alpha, T_after, alive and
//     one_m = max(1 - alpha, 1 - alpha_clamp) are the forward's own (same
//     helper, composite_alpha.cuh, same left-to-right log1p sum), t_before =
//     T_after / one_m;
//   * wgt = alive ? t_before alpha : 0, cg = sum_c color_c g_c, m = wgt cg;
//     suffix = (sum of m over the chunk's LATER pairs) + tail;
//   * dalpha = alive ? t_before cg - suffix / one_m : 0, zeroed unless the
//     pair is unclamped; dpow = alpha dalpha;
//   * per pair, summed over the tile's pixels: d_op = gexp dalpha,
//     d_ca = -dx^2/2 dpow, d_cb = -dx dy dpow, d_cc = -dy^2/2 dpow,
//     d_x0 = (ca dx + cb dy) dpow, d_y0 = (cc dy + cb dx) dpow,
//     d_col = g wgt; then tail += sum_pairs m.
//
// What bounds it on the card: instruction rate and latency, not bytes.
// Every (pixel, in-segment pair) evaluation needs the forward's alpha;
// where the pair touches the pixel (a few percent of evaluations on the
// bench scene) also a log1p, an exponential, ~35 operations of gradient and
// its share of the 9 sums over the tile's pixels. The first designs kept
// T_after of every (pair, pixel) of a chunk in shared memory (128 KB: one
// CTA of 8 warps an SM, nothing hid the serial sweeps' latency), walked
// every pair for every pixel and reduced each pair with 9 x 5 shuffles a
// warp. This design:
//   * One CTA of at most 256 threads per tile row, one pixel a thread, >= 3
//     CTAs an SM (__launch_bounds__(256, 3), <= 80 registers; 68,096 bytes
//     of shared memory at chunk 128 and 16 x 16 tiles, composite_bwd_smem).
//     A larger tile (up to 1024 pixels) is walked in parts of at most 256
//     pixels (walk_threads), each part's per-pixel state kept in shared
//     memory between chunks; lanes past the tile's last pixel idle. The
//     wrapper starts the rows heaviest first (`order`).
//   * Staging (composite_walk_common.cuh): the next chunk's rows are copied
//     with cp.async while the current one is walked, then laid out
//     pair-major as three float4 per pair with the pair's power threshold.
//   * A pair contributes to a pixel iff it is alive and alpha != 0 or it is
//     unclamped. One that does not adds log1p(-0) = -0 to the log sum,
//     which leaves it unchanged bit for bit, and nothing to any gradient.
//   * Forward sweep, per sub-block of kSub = 8 pairs: the 8 power tests
//     (independent), then the forward's recurrence over the candidates that
//     pass, to the first dead pair. No per-(pair, pixel) T store: per pixel
//     and sub-block it keeps the log sum at the sub-block's start and a bit
//     mask of the contributing pairs (16 + 4 KB of shared memory).
//   * Reverse sweep, sub-blocks last first, over the active steps only (the
//     pairs that contribute to some pixel of the warp): the replay adds the
//     same log1p terms in the same order from the sub-block's checkpoint
//     (T_after = t0 exp(incl) bit-equal to the forward sweep's and B2's),
//     then the gradients, last first, with one reciprocal of one_m per
//     evaluation instead of two divisions. Inactive pairs' partials are
//     zeros and cost no shuffle.
//   * A step's 9 partials are summed over the warp by a transposing
//     butterfly (warp_sum9): each of 5 steps halves the values a lane holds
//     and doubles the lanes they cover, 5 + 3 + 2 + 1 + 1 = 12 shuffles
//     instead of 9 x 5.
//   * After one barrier the warps' partials are summed in fixed warp order
//     and each value is written once. Every sum has a fixed order: two runs
//     are bit-equal, and B5's blocks hold B3's values bit for bit.
//
// The three kernels differ in where a row's pairs come from and where the
// sums go (`Layout`):
//   * kStreamed (B3): the (9, plane) sorted pair array, window base * chunk,
//     segment [off, off + count); row j of chunk i goes to
//     out[k * plane + window + j], for the rows of the tile's own segment
//     only (the caller zero-fills);
//   * kBlocks (B5): the same source; chunk i goes to the (9, chunk) block
//     out[((r * n_chunks + i) * 9 + k) * chunk + j], exact zeros outside
//     the segment, and every block of a chunk that is not walked is
//     written as zeros, so the caller need not clear the output;
//   * kTable (B7): a dense table (rows, n_chunks * chunk, F), F = 6 +
//     channels, chunk i being one contiguous chunk x F block; the segment
//     is the row's first count slots (all of a walked chunk where alpha_min
//     <= 0 lets an empty slot count as unclamped); d(table) of chunk i is
//     written slot-major as one chunk x F block, zeros outside the segment
//     and in the chunks that are not walked; gt adds g_tfin.
//
// The replay, the shuffles, the reciprocal, the feature copies after the
// first chunk and the reverse sweep were each timed by a build that left
// that part out (the splits are in the history of PERF.md).

#pragma once

#include "composite_walk_common.cuh"

constexpr int kMinCtas = 3;  // CTAs an SM the build is held to

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// One butterfly step: the low lanes (bit `offset` clear) keep the first
// ceil(N/2) values, the high lanes the rest (and a zero), each adding its
// partner's copy of what it keeps.
template <int N>
__device__ __forceinline__ void halve(const float (&in)[N], float (&out)[(N + 1) / 2],
                                      int offset, bool hi) {
  constexpr int L = (N + 1) / 2;
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const float lo_v = in[k];
    const float hi_v = k + L < N ? in[k + L] : 0.0f;
    out[k] = (hi ? hi_v : lo_v) + __shfl_xor_sync(0xffffffffu, hi ? lo_v : hi_v, offset);
  }
}

// The 9 values summed over the warp; lane `sum9_index(lane)` >= 0 holds the
// sum of v[sum9_index(lane)] (each index on one even lane).
__device__ __forceinline__ float warp_sum9(const float (&v)[kFeat], int lane) {
  float w[5], u[3], t[2], s[1];
  halve<9>(v, w, 16, lane & 16);
  halve<5>(w, u, 8, lane & 8);
  halve<3>(u, t, 4, lane & 4);
  halve<2>(t, s, 2, lane & 2);
  return s[0] + __shfl_xor_sync(0xffffffffu, s[0], 1);
}

__device__ __forceinline__ int sum9_index(int lane) {
  int base = 0, valid = kFeat, n = kFeat;
  for (int o = 16; o >= 2; o >>= 1) {
    const int low = (n + 1) / 2;
    if (lane & o) {
      base += low;
      valid -= low;
    } else {
      valid = min(valid, low);
    }
    n = low;
  }
  return valid > 0 && !(lane & 1) ? base : -1;
}

// Shared memory of one CTA, bytes: features (pair-major, padded to whole
// sub-blocks, and the next chunk's rows in flight), sub-block log sums, the
// warps' partials, the tile's tails where it is walked in parts, and the
// sub-block masks. The wrappers read it through pf3_*_smem.
inline size_t composite_bwd_smem(int ts, int chunk) {
  const int p = ts * ts;
  const size_t nt = walk_threads(p);
  const size_t n_sub = walk_sub_blocks(chunk);
  return 3 * sizeof(float4) * n_sub * kSub + sizeof(float) * kFeat * chunk +
         (sizeof(float) + sizeof(uint8_t)) * n_sub * nt +
         sizeof(float) * (nt / 32) * chunk * kFeat +
         (walk_parts(p) > 1 ? sizeof(float) * p : 0);
}

// Start copying the 9 x chunk feature rows of the window at g0 into s_raw
// (feature-major); cp.async.wait_all and a barrier make them visible.
__device__ __forceinline__ void fetch_chunk(float* s_raw, const float* __restrict__ feat,
                                            long long plane, long long g0, int chunk) {
  for (int k = threadIdx.x; k < kFeat * chunk; k += blockDim.x) {
    const int f = k / chunk;
    cp_async4(s_raw + k, feat + f * plane + g0 + (k - f * chunk));
  }
  cp_async_commit();
}

// A thread's pixel in part `part` of its tile (tile origin x0, y0), whether
// it lies inside the tile, and the upstream gradient there (gimg: the row's
// (ch, p) image; zeros beyond `channels` and for idle lanes).
struct WalkPixel {
  int pix;
  bool valid;
  float x, y;
  float g[3];
};

__device__ __forceinline__ WalkPixel walk_pixel(int part, int nt, int ts, int x0, int y0,
                                                const float* __restrict__ gimg, int p,
                                                int channels) {
  WalkPixel w;
  w.pix = part * nt + threadIdx.x;
  w.valid = w.pix < p;
  w.x = (float)(x0 + w.pix % ts) + 0.5f;
  w.y = (float)(y0 + w.pix / ts) + 0.5f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    w.g[c] = c < channels && w.valid ? gimg[(long long)c * p + w.pix] : 0.0f;
  return w;
}

// A warp's partial of one (pair, feature): the first part of the tile sets
// it, a later part adds to it.
__device__ __forceinline__ void put_partial(float* dst, float v, bool first) {
  *dst = first ? v : *dst + v;
}

// The kernels' arguments. feat: (9, plane) sorted pairs, or the table
// (rows, n_chunks * chunk, 6 + channels) for kTable; base / off: per row,
// the window and the segment's start in it (unused for kTable); count,
// tile_ids, nproc (chunks walked), order (the tile row of each CTA, a
// permutation) (rows,) i32; bg (rows, ch), tfin (rows, p), tchk (rows,
// n_chunks, p), gimg (rows, ch, p), gtfin (rows, p) or null f32; out: dP,
// the block set or d(table); dbg (rows, ch).
struct WalkArgs {
  const float* feat;
  long long plane;
  const int32_t* base;
  const int32_t* off;
  const int32_t* count;
  const int32_t* tile_ids;
  const int32_t* nproc;
  const int32_t* order;
  const float* bg;
  const float* tfin;
  const float* tchk;
  const float* gimg;
  const float* gtfin;
  int channels, tiles_x, ts, chunk, n_chunks;
  float alpha_clamp, alpha_min, one_minus_clamp, t_min;
  float* out;
  float* dbg;
};

template <Layout L>
__device__ __forceinline__ void composite_bwd_row(const WalkArgs& a) {
  constexpr bool kTable = L == Layout::kTable;
  extern __shared__ float4 sm4[];
  const int ts = a.ts;
  const int chunk = a.chunk;
  const int channels = a.channels;
  const int p = ts * ts;
  const int nt = blockDim.x;  // pixels of a part
  const int n_parts = (p + nt - 1) / nt;
  const int n_warps = nt / 32;
  const int n_sub = walk_sub_blocks(chunk);
  const int n_pad = n_sub * kSub;
  float4* s_feat = sm4;                                          // 3 * n_pad
  float* s_raw = reinterpret_cast<float*>(s_feat + 3 * n_pad);   // kFeat * chunk
  float* s_ck = s_raw + kFeat * chunk;                           // n_sub * nt
  float* s_red = s_ck + n_sub * nt;                              // n_warps * chunk * kFeat
  float* s_tail = s_red + n_warps * chunk * kFeat;               // p, if n_parts > 1
  uint8_t* s_mask = reinterpret_cast<uint8_t*>(s_tail + (n_parts > 1 ? p : 0));  // n_sub * nt
  const int r = a.order[blockIdx.x];
  const int l = threadIdx.x;
  const int warp = l >> 5;
  const int lane = l & 31;
  const int red_k = sum9_index(lane);
  const int t_img = a.tile_ids[r];
  const int x0 = (t_img % a.tiles_x) * ts;
  const int y0 = (t_img / a.tiles_x) * ts;
  // Table rows: slot columns, and the segment (empty slots are zeros, so
  // past the count alpha is 0; with alpha_min <= 0 an empty slot is
  // unclamped and takes part, as in the plain version).
  const int n_col = kTable ? 6 + channels : kFeat;
  const int cap = a.n_chunks * chunk;
  const int seg_lo = kTable ? 0 : a.off[r];
  const int seg_hi = kTable ? (a.alpha_min > 0.0f ? min(a.count[r], cap) : cap)
                            : seg_lo + a.count[r];
  const long long w0 = kTable ? 0 : (long long)a.base[r] * chunk;
  const float* row_src = a.feat + (kTable ? (long long)r * cap * n_col : 0);

  // This thread's pixel in the current part, and its upstream gradient.
  const float* g_row = a.gimg + (long long)r * channels * p;
  WalkPixel pixel = walk_pixel(0, nt, ts, x0, y0, g_row, p, channels);

  // tail = tfin gt per pixel; d(bg) = sum over pixels of g tfin, each warp
  // over its parts in order, then the warps in order.
  float tail = 0.0f;
  float dsum[3] = {0.0f, 0.0f, 0.0f};
  for (int part = 0; part < n_parts; ++part) {
    if (part > 0) pixel = walk_pixel(part, nt, ts, x0, y0, g_row, p, channels);
    const long long px_at = (long long)r * p + pixel.pix;
    float gt = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < channels) gt += a.bg[r * channels + c] * pixel.g[c];
    }
    if (kTable && pixel.valid) gt += a.gtfin[px_at];
    const float tf = pixel.valid ? a.tfin[px_at] : 0.0f;
    tail = tf * gt;
    if (n_parts > 1 && pixel.valid) s_tail[pixel.pix] = tail;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < channels) dsum[c] += warp_sum(pixel.g[c] * tf);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < channels) s_red[warp * 3 + c] = dsum[c];
    }
  }
  __syncthreads();
  if (l < channels) {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s += s_red[w * 3 + l];
    a.dbg[r * channels + l] = s;
  }

  // Chunks wholly before the segment composite nothing: skip them.
  const int i_min = seg_lo / chunk;
  const int i_top = a.nproc[r];
  const int blk = n_col * chunk;  // floats of a chunk's block (kBlocks, kTable)
  if (L != Layout::kStreamed) {
    // Blocks of the chunks that are not walked hold zeros.
    float* row_out = a.out + (long long)r * a.n_chunks * blk;
    const int head = min(i_min, i_top) * blk;
    for (int q = l; q < head; q += blockDim.x) row_out[q] = 0.0f;
    for (int q = max(i_top, 0) * blk + l; q < a.n_chunks * blk; q += blockDim.x)
      row_out[q] = 0.0f;
  }
  // Chunk i's raw rows into s_raw: feature-major from the pair array, or one
  // contiguous slot-major block of the table row.
  auto fetch = [&](int i) {
    if (kTable) {
      fetch_contiguous(s_raw, row_src + (long long)i * blk, blk);
    } else {
      fetch_chunk(s_raw, a.feat, a.plane, w0 + (long long)i * chunk, chunk);
    }
  };
  float* w_red = s_red + warp * chunk * kFeat;  // this warp's partials
  if (i_top - 1 >= i_min) fetch(i_top - 1);
  for (int i = i_top - 1; i >= i_min; --i) {
    const long long g0 = w0 + (long long)i * chunk;
    cp_async_wait_all();
    __syncthreads();  // chunk i's rows are in; the previous chunk's are read
    for (int q = l; q < n_pad; q += blockDim.x) {
      stage_pair(s_feat, s_raw, q, chunk, kTable ? 1 : chunk, kTable ? n_col : 1, channels,
                 a.alpha_min);
    }
    __syncthreads();  // features staged; s_raw is free
    // The next chunk's rows arrive while this one is walked.
    if (i - 1 >= i_min) fetch(i - 1);
    const int j_lo = max(seg_lo - i * chunk, 0);
    const int j_hi = min(seg_hi - i * chunk, chunk);
    const int sb_lo = j_lo / kSub;
    const int sb_hi = (j_hi + kSub - 1) / kSub;

    for (int part = 0; part < n_parts; ++part) {
      const bool first = part == 0;
      if (n_parts > 1) {
        pixel = walk_pixel(part, nt, ts, x0, y0, g_row, p, channels);
        tail = pixel.valid ? s_tail[pixel.pix] : 0.0f;
      }
      const float t0 =
          pixel.valid ? a.tchk[((long long)r * a.n_chunks + i) * p + pixel.pix] : 0.0f;

      // Forward sweep: the forward's recurrence over the contributing pairs,
      // to the first dead pair; per sub-block the log sum at its start and
      // the mask. The power tests of a sub-block's pairs are independent
      // (ILP); the candidates that pass go through pair_alpha one by one.
      float incl = 0.0f;
      bool live = pixel.valid;
      for (int sb = sb_lo; sb < sb_hi; ++sb) {
        uint32_t bits = 0;
        s_ck[sb * nt + l] = incl;
        if (live) {
          const float4* fs = s_feat + 3 * sb * kSub;
          uint32_t cand = 0;
#pragma unroll
          for (int s = 0; s < kSub; ++s) {
            const float power = pair_power(pixel.x, pixel.y, fs[3 * s], fs[3 * s + 1].x);
            if (!(power < fs[3 * s + 1].z)) cand |= 1u << s;
          }
          cand &= span_bits(j_lo - sb * kSub, j_hi - sb * kSub);
          while (cand) {
            const int s = __ffs(cand) - 1;
            cand &= cand - 1;
            const float4 fa = fs[3 * s];
            const float4 fb = fs[3 * s + 1];
            const PairAlpha pa = pair_alpha(pixel.x, pixel.y, fa.x, fa.y, fa.z, fa.w, fb.x,
                                            fb.y, a.alpha_clamp, a.alpha_min);
            if (pa.alpha == 0.0f && !pa.unclamped) continue;
            incl += log1pf(-pa.alpha);
            const float t_after = t0 * expf(incl);
            if (!(t_after >= a.t_min)) {  // every later pair of the chunk is dead
              live = false;
              break;
            }
            bits |= 1u << s;
          }
        }
        s_mask[sb * nt + l] = (uint8_t)bits;
      }

      // Reverse sweep, sub-blocks last first. Only the steps (pairs) that
      // contribute to some pixel of the warp are walked; the other pairs'
      // partials are zeros.
      float run = 0.0f;  // sum of m over the chunk's later pairs
      for (int sb = sb_hi - 1; sb >= sb_lo; --sb) {
        const uint32_t span = span_bits(j_lo - sb * kSub, j_hi - sb * kSub);
        const uint32_t bits = s_mask[sb * nt + l];
        const uint32_t active = __reduce_or_sync(0xffffffffu, bits);  // within span
        float* sb_red = w_red + sb * kSub * kFeat;
        if (first && lane < kFeat) {
          for (uint32_t z = span & ~active; z != 0; z &= z - 1)
            sb_red[(__ffs(z) - 1) * kFeat + lane] = 0.0f;
        }
        if (active == 0) continue;
        const int n_act = __popc(active);
        const float4* fs = s_feat + 3 * sb * kSub;
        // Replay, active steps in order: the log sum after the k-th in
        // inc[k]. A step this lane's pixel does not take adds +-0 (alpha 0)
        // or comes after its dead pair.
        float inc[kSub];
        float acc = s_ck[sb * nt + l];
        uint32_t rest = active;
#pragma unroll
        for (int k = 0; k < kSub; ++k) {
          if (k >= n_act) break;
          const int s = __ffs(rest) - 1;
          rest &= rest - 1;
          const float4 fa = fs[3 * s];
          const float4 fb = fs[3 * s + 1];
          acc += log1pf(-pair_alpha(pixel.x, pixel.y, fa.x, fa.y, fa.z, fa.w, fb.x, fb.y,
                                    a.alpha_clamp, a.alpha_min).alpha);
          inc[k] = acc;
        }
        // Gradients, active steps last first.
        rest = active;
#pragma unroll
        for (int k = kSub - 1; k >= 0; --k) {
          if (k >= n_act) continue;
          const int s = 31 - __clz(rest);
          rest ^= 1u << s;
          const bool c = bits >> s & 1u;  // alive, contributing, in the segment
          const float4 fa = fs[3 * s];
          const float4 fb = fs[3 * s + 1];
          const float4 fc = fs[3 * s + 2];
          const PairAlpha pa = pair_alpha(pixel.x, pixel.y, fa.x, fa.y, fa.z, fa.w, fb.x, fb.y,
                                          a.alpha_clamp, a.alpha_min);
          const float t_after = t0 * expf(inc[k]);
          const float one_m = fmaxf(1.0f - pa.alpha, a.one_minus_clamp);
          const float rcp = __fdividef(1.0f, one_m);
          const float t_before = t_after * rcp;
          const float wgt = t_before * pa.alpha;
          const float cg = fb.w * pixel.g[0] + fc.x * pixel.g[1] + fc.y * pixel.g[2];
          const float suffix = run + tail;
          const float dalpha = pa.unclamped ? t_before * cg - suffix * rcp : 0.0f;
          const float m = wgt * cg;
          run += c ? m : 0.0f;
          const float dpow = pa.alpha * dalpha;
          float v[kFeat];
          v[0] = c ? (fa.z * pa.dx + fa.w * pa.dy) * dpow : 0.0f;
          v[1] = c ? (fb.x * pa.dy + fa.w * pa.dx) * dpow : 0.0f;
          v[2] = c ? -0.5f * pa.dx * pa.dx * dpow : 0.0f;
          v[3] = c ? -pa.dx * pa.dy * dpow : 0.0f;
          v[4] = c ? -0.5f * pa.dy * pa.dy * dpow : 0.0f;
          v[5] = c ? pa.gexp * dalpha : 0.0f;
          v[6] = c ? pixel.g[0] * wgt : 0.0f;
          v[7] = c ? pixel.g[1] * wgt : 0.0f;
          v[8] = c ? pixel.g[2] * wgt : 0.0f;
          const float sum = warp_sum9(v, lane);
          if (red_k >= 0) put_partial(sb_red + s * kFeat + red_k, sum, first);
        }
      }
      tail += run;
      if (n_parts > 1) {
        if (pixel.valid) s_tail[pixel.pix] = tail;
        __syncwarp();  // this part's partials before the next part adds to them
      }
    }
    __syncthreads();

    // Sum the warps' partials in fixed order; write each value once.
    if (L == Layout::kStreamed) {
      const int nj = j_hi - j_lo;
      for (int q = l; q < nj * kFeat; q += blockDim.x) {
        const int k = q / nj;
        const int j = j_lo + (q - k * nj);
        float s = 0.0f;
        for (int w = 0; w < n_warps; ++w) s += s_red[(w * chunk + j) * kFeat + k];
        a.out[k * a.plane + g0 + j] = s;
      }
    } else {
      // kBlocks: feature-major (9, chunk); kTable: slot-major (chunk, F).
      float* blk_out = a.out + ((long long)r * a.n_chunks + i) * blk;
      for (int q = l; q < blk; q += blockDim.x) {
        const int k = kTable ? q % n_col : q / chunk;
        const int j = kTable ? q / n_col : q - k * chunk;
        float s = 0.0f;
        if (j >= j_lo && j < j_hi) {
          for (int w = 0; w < n_warps; ++w) s += s_red[(w * chunk + j) * kFeat + k];
        }
        blk_out[q] = s;
      }
    }
  }
}

template <Layout L>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas) composite_bwd_kernel(
    const __grid_constant__ WalkArgs a) {
  composite_bwd_row<L>(a);
}

template <Layout L>
cudaError_t composite_bwd_configure(int ts, int chunk) {
  const size_t smem = composite_bwd_smem(ts, chunk);
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(composite_bwd_kernel<L>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch one CTA per tile row (WalkArgs); ts * ts at most kMaxPixels.
template <Layout L>
int composite_bwd_launch(const WalkArgs& a, int rows, void* stream) {
  const int p = a.ts * a.ts;
  if (p <= 0 || p > kMaxPixels || a.chunk <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = composite_bwd_configure<L>(a.ts, a.chunk);
  if (e != cudaSuccess) return (int)e;
  if (rows > 0) {
    composite_bwd_kernel<L><<<rows, walk_threads(p), composite_bwd_smem(a.ts, a.chunk),
                              static_cast<cudaStream_t>(stream)>>>(a);
  }
  return (int)cudaGetLastError();
}

// The streamed layouts' arguments (B3, B5): see their C entry points.
inline WalkArgs streamed_walk_args(const void* feat, long long plane, const void* base,
                                   const void* off, const void* count, const void* tile_ids,
                                   const void* nproc, const void* order, const void* bg,
                                   const void* tfin, const void* tchk, const void* gimg,
                                   int channels, int tiles_x, int ts, int chunk, int n_chunks,
                                   float alpha_clamp, float alpha_min, float one_minus_clamp,
                                   float t_min, void* out, void* dbg) {
  return WalkArgs{static_cast<const float*>(feat), plane,
                  static_cast<const int32_t*>(base), static_cast<const int32_t*>(off),
                  static_cast<const int32_t*>(count), static_cast<const int32_t*>(tile_ids),
                  static_cast<const int32_t*>(nproc), static_cast<const int32_t*>(order),
                  static_cast<const float*>(bg), static_cast<const float*>(tfin),
                  static_cast<const float*>(tchk), static_cast<const float*>(gimg), nullptr,
                  channels, tiles_x, ts, chunk, n_chunks, alpha_clamp, alpha_min,
                  one_minus_clamp, t_min, static_cast<float*>(out), static_cast<float*>(dbg)};
}

// CTAs of the kernel that fit one SM at this tile size and chunk (registers
// and shared memory as built); negative on an error.
template <Layout L>
int composite_bwd_occupancy(int ts, int chunk) {
  int ctas = 0;
  cudaError_t e = composite_bwd_configure<L>(ts, chunk);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, composite_bwd_kernel<L>, walk_threads(ts * ts), composite_bwd_smem(ts, chunk));
  }
  return e == cudaSuccess ? ctas : -(int)e;
}
