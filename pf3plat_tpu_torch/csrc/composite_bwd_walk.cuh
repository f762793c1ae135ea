// Reverse walk of one tile row of the streamed compositor: the two sweeps
// shared by kernels B3 (composite_bwd.cu) and B5 (composite_bwd_blocks.cu).
//
// Per tile row it replays, in reverse, the chunks the forward (B2)
// processed (`nproc`, from the checkpoints) and forms the per-pair
// gradients of [x, y, ca, cb, cc, op, c0..c2], plus d(background) per
// tile. Semantics of the TPU kernels' `_bwd_chunk_grads`:
//   * gt = sum_c bg_c g_c; dbg = sum_pixels g tfin; tail starts at tfin gt;
//   * chunk i starts from its checkpoint tchk[i]; alpha, T_after, alive and
//     one_m = max(1 - alpha, 1 - alpha_clamp) are B2's own (same helper,
//     composite_alpha.cuh), t_before = T_after / one_m;
//   * wgt = alive ? t_before alpha : 0, cg = sum_c color_c g_c, m = wgt cg;
//     suffix = (sum of m over the chunk's LATER pairs) + tail;
//   * dalpha = alive ? t_before cg - suffix / one_m : 0, zeroed unless the
//     pair is unclamped; dpow = alpha dalpha;
//   * per pair, summed over the tile's pixels: d_op = gexp dalpha,
//     d_ca = -dx^2/2 dpow, d_cb = -dx dy dpow, d_cc = -dy^2/2 dpow,
//     d_x0 = (ca dx + cb dy) dpow, d_y0 = (cc dy + cb dx) dpow,
//     d_col = g wgt; then tail += sum_pairs m.
//
// One CTA of tile_size^2 threads per tile row, one thread per pixel. Per
// chunk the 9 x chunk features are staged in shared memory; each thread
// runs the forward sweep and keeps T_after per (pair, pixel) in shared
// memory (chunk x 256 x 4 B = 128 KB, 0 once dead); the reverse sweep forms
// the per-pixel partials, each warp reduces a pair's 9 partials with
// shuffles into [warp][chunk][9] shared memory, and after one barrier the
// warps' partials are summed in fixed order and each value is written once.
//
// The two kernels differ only in where the sums go (`kBlocks`):
//   * false (B3): row j of chunk i goes to out[k * plane + window + j], for
//     the rows of the tile's own segment only (the caller zero-fills);
//   * true (B5): chunk i goes to the (9, chunk) block
//     out[((r * n_chunks + i) * 9 + k) * chunk + j], exact zeros outside
//     the segment, and every block of a chunk that is not walked is
//     written as zeros, so the caller need not clear the output.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "composite_alpha.cuh"

constexpr int kFeat = 9;  // x, y, ca, cb, cc, op, c0, c1, c2

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

inline size_t composite_bwd_smem(int ts, int chunk) {
  const int p = ts * ts;
  return sizeof(float) * ((size_t)kFeat * chunk + (size_t)chunk * p +
                          (size_t)(p / 32) * chunk * kFeat);
}

template <bool kBlocks>
__device__ __forceinline__ void composite_bwd_row(
    const float* __restrict__ feat, long long plane,
    const int32_t* __restrict__ base, const int32_t* __restrict__ off,
    const int32_t* __restrict__ count, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ nproc, const float* __restrict__ bg,
    const float* __restrict__ tfin, const float* __restrict__ tchk,
    const float* __restrict__ gimg, int channels, int tiles_x, int ts, int chunk,
    int n_chunks, float alpha_clamp, float alpha_min, float one_minus_clamp,
    float t_min, float* __restrict__ out, float* __restrict__ dbg) {
  extern __shared__ float sm[];
  const int p = ts * ts;
  const int n_warps = p / 32;
  float* s_feat = sm;                     // kFeat * chunk
  float* s_t = s_feat + kFeat * chunk;    // chunk * p: T_after, 0 once dead
  float* s_red = s_t + chunk * p;         // n_warps * chunk * kFeat
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int warp = l >> 5;
  const int lane = l & 31;
  const int t_img = tile_ids[r];
  const int tx = t_img % tiles_x;
  const int ty = t_img / tiles_x;
  const float px = (float)(tx * ts + l % ts) + 0.5f;
  const float py = (float)(ty * ts + l / ts) + 0.5f;
  const int seg_lo = off[r];
  const int seg_hi = seg_lo + count[r];
  const long long w0 = (long long)base[r] * chunk;

  float g[3] = {0.0f, 0.0f, 0.0f};
  float gt = 0.0f;
  for (int c = 0; c < channels; ++c) {
    g[c] = gimg[((long long)r * channels + c) * p + l];
    gt += bg[r * channels + c] * g[c];
  }
  const float tf = tfin[(long long)r * p + l];
  float tail = tf * gt;

  for (int c = 0; c < channels; ++c) {
    const float v = warp_sum(g[c] * tf);
    if (lane == 0) s_red[warp * 3 + c] = v;
  }
  __syncthreads();
  if (l < channels) {
    float s = 0.0f;
    for (int w = 0; w < n_warps; ++w) s += s_red[w * 3 + l];
    dbg[r * channels + l] = s;
  }

  // Chunks wholly before the segment composite nothing: skip them.
  const int i_min = seg_lo / chunk;
  const int i_top = nproc[r];
  if (kBlocks) {
    // Blocks of the chunks that are not walked hold zeros.
    const int blk = kFeat * chunk;
    float* row_out = out + (long long)r * n_chunks * blk;
    const int head = min(i_min, i_top) * blk;
    for (int q = l; q < head; q += blockDim.x) row_out[q] = 0.0f;
    for (int q = max(i_top, 0) * blk + l; q < n_chunks * blk; q += blockDim.x) row_out[q] = 0.0f;
  }
  for (int i = i_top - 1; i >= i_min; --i) {
    __syncthreads();  // the previous chunk's features and partials are read
    const long long g0 = w0 + (long long)i * chunk;
    for (int k = l; k < kFeat * chunk; k += blockDim.x) {
      const int f = k / chunk;
      const int j = k - f * chunk;
      s_feat[k] = feat[f * plane + g0 + j];
    }
    __syncthreads();
    const int j_lo = max(seg_lo - i * chunk, 0);
    const int j_hi = min(seg_hi - i * chunk, chunk);

    // Forward sweep: B2's recurrence from the chunk's checkpoint.
    const float t0 = tchk[((long long)r * n_chunks + i) * p + l];
    float incl = 0.0f;
    bool dead = false;
    for (int j = j_lo; j < j_hi; ++j) {
      float t_after = 0.0f;
      if (!dead) {
        const float alpha = pair_alpha(px, py, s_feat[j], s_feat[chunk + j],
                                       s_feat[2 * chunk + j], s_feat[3 * chunk + j],
                                       s_feat[4 * chunk + j], s_feat[5 * chunk + j],
                                       alpha_clamp, alpha_min).alpha;
        incl += log1pf(-alpha);
        t_after = t0 * expf(incl);
        if (!(t_after >= t_min)) {  // every later pair of the chunk is dead
          dead = true;
          t_after = 0.0f;
        }
      }
      s_t[j * p + l] = t_after;
    }

    // Reverse sweep: per-pixel partials, reduced per warp.
    float run = 0.0f;  // sum of m over the chunk's later pairs
    for (int j = j_hi - 1; j >= j_lo; --j) {
      const float ca = s_feat[2 * chunk + j];
      const float cb = s_feat[3 * chunk + j];
      const float cc = s_feat[4 * chunk + j];
      const PairAlpha a = pair_alpha(px, py, s_feat[j], s_feat[chunk + j], ca, cb, cc,
                                     s_feat[5 * chunk + j], alpha_clamp, alpha_min);
      const float t_after = s_t[j * p + l];
      const bool alive = t_after >= t_min;
      const float one_m = fmaxf(1.0f - a.alpha, one_minus_clamp);
      const float t_before = t_after / one_m;
      const float wgt = alive ? t_before * a.alpha : 0.0f;
      float cg = 0.0f;
      for (int c = 0; c < channels; ++c) cg += s_feat[(6 + c) * chunk + j] * g[c];
      const float m = wgt * cg;
      const float suffix = run + tail;
      const float dalpha = (alive && a.unclamped) ? t_before * cg - suffix / one_m : 0.0f;
      run += m;
      const float dpow = a.alpha * dalpha;
      float v[kFeat];
      v[0] = (ca * a.dx + cb * a.dy) * dpow;
      v[1] = (cc * a.dy + cb * a.dx) * dpow;
      v[2] = -0.5f * a.dx * a.dx * dpow;
      v[3] = -a.dx * a.dy * dpow;
      v[4] = -0.5f * a.dy * a.dy * dpow;
      v[5] = a.gexp * dalpha;
      v[6] = g[0] * wgt;
      v[7] = g[1] * wgt;
      v[8] = g[2] * wgt;
#pragma unroll
      for (int k = 0; k < kFeat; ++k) {
        const float s = warp_sum(v[k]);
        if (lane == 0) s_red[(warp * chunk + j) * kFeat + k] = s;
      }
    }
    tail += run;
    __syncthreads();

    // Sum the warps' partials in fixed order; write each value once.
    if (kBlocks) {
      float* blk_out = out + ((long long)r * n_chunks + i) * kFeat * chunk;
      for (int q = l; q < chunk * kFeat; q += blockDim.x) {
        const int k = q / chunk;
        const int j = q - k * chunk;
        float s = 0.0f;
        if (j >= j_lo && j < j_hi) {
          for (int w = 0; w < n_warps; ++w) s += s_red[(w * chunk + j) * kFeat + k];
        }
        blk_out[q] = s;
      }
    } else {
      const int nj = j_hi - j_lo;
      for (int q = l; q < nj * kFeat; q += blockDim.x) {
        const int k = q / nj;
        const int j = j_lo + (q - k * nj);
        float s = 0.0f;
        for (int w = 0; w < n_warps; ++w) s += s_red[(w * chunk + j) * kFeat + k];
        out[k * plane + g0 + j] = s;
      }
    }
  }
}
