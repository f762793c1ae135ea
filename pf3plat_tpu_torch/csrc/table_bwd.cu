// Dense-table compositing backward (kernel B7), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/pallas_impl.py:
// _bwd_kernel`. Per table row (one (camera, tile); slots [x, y, ca, cb, cc,
// op, color...], F = 6 + channels floats each) it replays, in reverse, the
// chunks the forward (B6, table_fwd.cu) walked and writes d(table) for
// every slot of the row, plus d(background) of the row. Semantics of the
// TPU kernel:
//   * gt = sum_c bg_c g_c + g_tfin (the cotangent of t_final is an input);
//     dbg = sum_pixels g tfin; the running tail starts at tfin gt;
//   * chunk i is walked iff i * chunk < count[row] and its checkpoint
//     tchk[i] is above 0 at some pixel; every slot of a chunk that is not
//     walked gets a zero gradient;
//   * a walked chunk starts from tchk[i]; alpha, T_after, alive and
//     one_m = max(1 - alpha, 1 - alpha_clamp) are B6's own (same helper,
//     composite_alpha.cuh), t_before = T_after / one_m;
//   * wgt = alive ? t_before alpha : 0, cg = sum_c color_c g_c, m = wgt cg;
//     suffix = (sum of m over the chunk's LATER slots) + tail;
//   * dalpha = alive ? t_before cg - suffix / one_m : 0, zeroed unless the
//     slot is unclamped; dpow = alpha dalpha;
//   * per slot, summed over the tile's pixels: d_x0 = (ca dx + cb dy) dpow,
//     d_y0 = (cc dy + cb dx) dpow, d_ca = -dx^2/2 dpow, d_cb = -dx dy dpow,
//     d_cc = -dy^2/2 dpow, d_op = gexp dalpha, d_col = g wgt; then
//     tail += sum_slots m.
//
// Each (row, slot) of d(table) is written once, by the row's own CTA:
// deterministic, no atomics, fixed summation order.
//
// Bound on the card: operations. Per (pixel, slot) evaluation of a walked
// chunk the forward sweep repeats B6's ~23 operations and the reverse sweep
// adds ~59 (one exp, one division, the 6 + channels partials and their
// share of the warp reductions): ~82 in all, as kernel B3. Design: one CTA
// of tile_size^2 threads per row, one thread per pixel. Per chunk the
// chunk x F features are staged in shared memory; each thread runs the
// forward sweep and keeps T_after per (slot, pixel) in shared memory
// (chunk x pixels x 4 B, 0 once dead); the reverse sweep forms the
// per-pixel partials, each warp reduces a slot's partials with shuffles
// into [warp][chunk][9] shared memory, and after one barrier the warps'
// partials are summed in fixed order and the chunk's contiguous
// chunk x F block of d(table) is written once. The buffers are sized from
// chunk and tile_size at launch; what does not fit a block's shared memory
// is refused by the wrapper.

#include <cstdint>
#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

constexpr int kPart = 9;  // partial sums kept per slot: 6 + up to 3 colours

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void table_bwd_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ count,
    const int32_t* __restrict__ tile_ids, const float* __restrict__ bg,
    const float* __restrict__ tfin, const float* __restrict__ tchk,
    const float* __restrict__ gimg, const float* __restrict__ gtfin, int channels, int cap,
    int tiles_x, int ts, int chunk, int n_chunks, float alpha_clamp, float alpha_min,
    float one_minus_clamp, float t_min, float* __restrict__ dtab, float* __restrict__ dbg) {
  extern __shared__ float sm[];
  const int p = ts * ts;
  const int feat = 6 + channels;
  const int n_warps = p / 32;
  float* s_feat = sm;                    // chunk * feat
  float* s_t = s_feat + chunk * feat;    // chunk * p: T_after, 0 once dead
  float* s_red = s_t + chunk * p;        // n_warps * chunk * kPart
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int warp = l >> 5;
  const int lane = l & 31;
  const int t_img = tile_ids[r];
  const int tx = t_img % tiles_x;
  const int ty = t_img / tiles_x;
  const float px = (float)(tx * ts + l % ts) + 0.5f;
  const float py = (float)(ty * ts + l / ts) + 0.5f;
  const int cnt = count[r];
  const float* row = table + (long long)r * cap * feat;
  float* drow = dtab + (long long)r * cap * feat;

  float g[3] = {0.0f, 0.0f, 0.0f};
  float gt = gtfin[(long long)r * p + l];
  {
    float bgg = 0.0f;
    for (int c = 0; c < channels; ++c) {
      g[c] = gimg[((long long)r * channels + c) * p + l];
      bgg += bg[r * channels + c] * g[c];
    }
    gt = bgg + gt;
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

  for (int i = n_chunks - 1; i >= 0; --i) {
    float* dst = drow + (long long)i * chunk * feat;
    const float t0 = tchk[((long long)r * n_chunks + i) * p + l];
    // Uniform across the CTA; the barrier also ends the reads of the
    // previous chunk's features and partials.
    const bool walked = __syncthreads_or(t0 > 0.0f) && i * chunk < cnt;
    if (!walked) {
      for (int k = l; k < chunk * feat; k += blockDim.x) dst[k] = 0.0f;
      continue;
    }
    const float* src = row + (long long)i * chunk * feat;
    for (int k = l; k < chunk * feat; k += blockDim.x) s_feat[k] = src[k];
    __syncthreads();

    // Forward sweep: B6's recurrence from the chunk's checkpoint.
    float incl = 0.0f;
    bool dead = false;
    for (int j = 0; j < chunk; ++j) {
      float t_after = 0.0f;
      if (!dead) {
        const float* f = s_feat + j * feat;
        const float alpha = pair_alpha(px, py, f[0], f[1], f[2], f[3], f[4], f[5],
                                       alpha_clamp, alpha_min).alpha;
        incl += log1pf(-alpha);
        t_after = t0 * expf(incl);
        if (!(t_after >= t_min)) {  // every later slot of the chunk is dead
          dead = true;
          t_after = 0.0f;
        }
      }
      s_t[j * p + l] = t_after;
    }

    // Reverse sweep: per-pixel partials, reduced per warp.
    float run = 0.0f;  // sum of m over the chunk's later slots
    for (int j = chunk - 1; j >= 0; --j) {
      const float* f = s_feat + j * feat;
      const float ca = f[2];
      const float cb = f[3];
      const float cc = f[4];
      const PairAlpha a = pair_alpha(px, py, f[0], f[1], ca, cb, cc, f[5], alpha_clamp,
                                     alpha_min);
      const float t_after = s_t[j * p + l];
      const bool alive = t_after >= t_min;
      const float one_m = fmaxf(1.0f - a.alpha, one_minus_clamp);
      const float t_before = t_after / one_m;
      const float wgt = alive ? t_before * a.alpha : 0.0f;
      float cg = 0.0f;
      for (int c = 0; c < channels; ++c) cg += f[6 + c] * g[c];
      const float m = wgt * cg;
      const float suffix = run + tail;
      const float dalpha = (alive && a.unclamped) ? t_before * cg - suffix / one_m : 0.0f;
      run += m;
      const float dpow = a.alpha * dalpha;
      float v[kPart];
      v[0] = (ca * a.dx + cb * a.dy) * dpow;
      v[1] = (cc * a.dy + cb * a.dx) * dpow;
      v[2] = -0.5f * a.dx * a.dx * dpow;
      v[3] = -a.dx * a.dy * dpow;
      v[4] = -0.5f * a.dy * a.dy * dpow;
      v[5] = a.gexp * dalpha;
      v[6] = g[0] * wgt;
      v[7] = g[1] * wgt;
      v[8] = g[2] * wgt;
      // All kPart sums, unguarded (the unused colours are zeros): nine
      // independent shuffle chains that the compiler can interleave.
#pragma unroll
      for (int k = 0; k < kPart; ++k) {
        const float s = warp_sum(v[k]);
        if (lane == 0) s_red[(warp * chunk + j) * kPart + k] = s;
      }
    }
    tail += run;
    __syncthreads();

    // Sum the warps' partials in fixed order; write the chunk's block once.
    for (int q = l; q < chunk * feat; q += blockDim.x) {
      const int j = q / feat;
      const int k = q - j * feat;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += s_red[(w * chunk + j) * kPart + k];
      dst[q] = s;
    }
  }
}

size_t table_bwd_smem(int ts, int chunk, int channels) {
  const int p = ts * ts;
  return sizeof(float) * ((size_t)(6 + channels) * chunk + (size_t)chunk * p +
                          (size_t)(p / 32) * chunk * kPart);
}

}  // namespace

// table (rows, cap, 6 + channels) f32; count/tile_ids (rows,) i32;
// bg (rows, ch), tfin (rows, ts*ts), tchk (rows, n_chunks, ts*ts),
// gimg (rows, ch, ts*ts), gtfin (rows, ts*ts) f32; outputs dtab (the table's
// shape, every element written) and dbg (rows, ch). n_chunks * chunk == cap.
extern "C" int pf3_table_bwd(const void* table, const void* count, const void* tile_ids,
                             const void* bg, const void* tfin, const void* tchk,
                             const void* gimg, const void* gtfin, int rows, int channels,
                             int cap, int tiles_x, int ts, int chunk, int n_chunks,
                             float alpha_clamp, float alpha_min, float one_minus_clamp,
                             float t_min, void* dtab, void* dbg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = table_bwd_smem(ts, chunk, channels);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        table_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0) {
    table_bwd_kernel<<<rows, ts * ts, smem, s>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(tile_ids), static_cast<const float*>(bg),
        static_cast<const float*>(tfin), static_cast<const float*>(tchk),
        static_cast<const float*>(gimg), static_cast<const float*>(gtfin), channels, cap,
        tiles_x, ts, chunk, n_chunks, alpha_clamp, alpha_min, one_minus_clamp, t_min,
        static_cast<float*>(dtab), static_cast<float*>(dbg));
  }
  return (int)cudaGetLastError();
}
