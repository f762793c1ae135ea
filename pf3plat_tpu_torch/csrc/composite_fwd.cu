// Streamed forward compositing (kernel B2), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/streamed.py:
// _streamed_fwd_kernel` (+ `_fwd_one_tile`, `_chunk_alpha_cols`). Per tile
// row it composites the tile's depth-sorted segment [off, off + count) of
// the window that starts at base * chunk, front to back, walking the window
// in `chunk`-row chunks while chunk * i < off + count. Semantics copied from
// the TPU kernel exactly:
//   * alpha = min(op * exp(min(power, 0)), alpha_clamp), zeroed unless
//     power <= 0 and alpha >= alpha_min, with the factored (px - x0) form;
//   * inside a chunk, T_after is T_chunk_start * exp(running sum of
//     log1p(-alpha)); a pair is alive iff T_after >= t_min, so once one
//     pair fails, every later pair of that chunk is dead;
//   * at the chunk boundary T is RESET to the T after the last alive pair
//     (the failed pair's alpha is forgotten), so T never drops below t_min
//     and the walk covers the whole segment;
//   * tchk[i] = T at the start of chunk i (0 for chunks never reached),
//     img = accum + bg * T, tfin = T.
// This differs from the CUDA 3DGS rasterizer, which stops at the first
// failure for good.
//
// Bound on the card: the (pixel, in-segment pair) evaluations, each one
// exp + log1p + exp on the SFU and ~20 FP32 operations. Design: one CTA of
// tile_size^2 threads per tile row (one thread per pixel); each chunk's
// 9 x chunk feature rows are staged through shared memory cooperatively,
// then every thread walks them in order and stops at its first dead pair.
// Deterministic, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 9;  // x, y, ca, cb, cc, op, c0, c1, c2

__global__ void composite_fwd_kernel(
    const float* __restrict__ feat, long long plane,
    const int32_t* __restrict__ base, const int32_t* __restrict__ off,
    const int32_t* __restrict__ count, const int32_t* __restrict__ tile_ids,
    const float* __restrict__ bg, int channels, int tiles_x, int ts, int chunk,
    int n_chunks, float alpha_clamp, float alpha_min, float one_minus_clamp,
    float t_min, float* __restrict__ img, float* __restrict__ tfin,
    float* __restrict__ tchk) {
  extern __shared__ float sm[];  // kFeat * chunk
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int p = ts * ts;
  const int t_img = tile_ids[r];
  const int tx = t_img % tiles_x;
  const int ty = t_img / tiles_x;
  const float px = (float)(tx * ts + l % ts) + 0.5f;
  const float py = (float)(ty * ts + l / ts) + 0.5f;
  const int seg_lo = off[r];
  const int seg_hi = seg_lo + count[r];
  const long long w0 = (long long)base[r] * chunk;

  float T = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n_chunks; ++i) {
    float* chk = tchk + ((long long)r * n_chunks + i) * p + l;
    if (i * chunk >= seg_hi) {  // uniform across the CTA
      *chk = 0.0f;
      continue;
    }
    __syncthreads();  // the previous chunk's rows are no longer read
    const long long g0 = w0 + (long long)i * chunk;
    for (int k = l; k < kFeat * chunk; k += blockDim.x) {
      const int f = k / chunk;
      const int j = k - f * chunk;
      sm[k] = feat[f * plane + g0 + j];
    }
    __syncthreads();
    *chk = T;

    const int j_lo = max(seg_lo - i * chunk, 0);
    const int j_hi = min(seg_hi - i * chunk, chunk);
    float incl = 0.0f;
    float t_last = T;
    bool any_alive = false;
    for (int j = j_lo; j < j_hi; ++j) {
      const float dx = px - sm[j];
      const float dy = py - sm[chunk + j];
      const float ca = sm[2 * chunk + j];
      const float cb = sm[3 * chunk + j];
      const float cc = sm[4 * chunk + j];
      const float op = sm[5 * chunk + j];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      float alpha = fminf(op * expf(fminf(power, 0.0f)), alpha_clamp);
      if (!(power <= 0.0f && alpha >= alpha_min)) alpha = 0.0f;
      incl += log1pf(-alpha);
      const float t_after = T * expf(incl);
      if (!(t_after >= t_min)) break;  // every later pair of the chunk is dead
      const float w = (t_after / fmaxf(1.0f - alpha, one_minus_clamp)) * alpha;
      for (int c = 0; c < channels; ++c) acc[c] += w * sm[(6 + c) * chunk + j];
      t_last = t_after;
      any_alive = true;
    }
    if (any_alive) T = t_last;
  }
  for (int c = 0; c < channels; ++c)
    img[((long long)r * channels + c) * p + l] = acc[c] + bg[r * channels + c] * T;
  tfin[(long long)r * p + l] = T;
}

}  // namespace

// feat (9, plane) f32; base/off/count/tile_ids (rows,) i32; bg (rows, ch)
// f32; outputs img (rows, ch, ts*ts), tfin (rows, ts*ts),
// tchk (rows, n_chunks, ts*ts) f32.
extern "C" int pf3_composite_fwd(const void* feat, long long plane, const void* base,
                                 const void* off, const void* count,
                                 const void* tile_ids, const void* bg, int rows,
                                 int channels, int tiles_x, int ts, int chunk,
                                 int n_chunks, float alpha_clamp, float alpha_min,
                                 float one_minus_clamp, float t_min, void* img,
                                 void* tfin, void* tchk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * kFeat * chunk;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0) {
    composite_fwd_kernel<<<rows, ts * ts, smem, s>>>(
        static_cast<const float*>(feat), plane, static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(off), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(tile_ids), static_cast<const float*>(bg), channels,
        tiles_x, ts, chunk, n_chunks, alpha_clamp, alpha_min, one_minus_clamp, t_min,
        static_cast<float*>(img), static_cast<float*>(tfin), static_cast<float*>(tchk));
  }
  return (int)cudaGetLastError();
}
