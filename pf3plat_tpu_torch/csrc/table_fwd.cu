// Dense-table forward compositing (kernel B6), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/pallas_impl.py:
// _fwd_kernel` (+ `_chunk_alpha`). One table row is one (camera, tile): its
// first `cap` gaussians in depth order, one slot each, slot-major
// [x, y, ca, cb, cc, op, color...] (F = 6 + channels floats a slot), zeros
// past the row's count. Semantics copied from the TPU kernel exactly:
//   * pixel centres come from tile_ids[row], not from the block index;
//   * chunk i is walked iff i * chunk < count[row]; tchk[i] = T at its start,
//     written before compositing, and 0 for chunks never walked;
//   * every slot of a walked chunk is composited (a zero slot has alpha 0);
//   * alpha as in the streamed kernels (composite_alpha.cuh); inside a chunk
//     T_after = T_chunk_start * exp(running sum of log1p(-alpha)), a slot is
//     alive iff T_after >= t_min, so after the first dead slot the rest of
//     the chunk is dead; weight = T_after / max(1 - alpha, 1 - alpha_clamp)
//     * alpha;
//   * at the chunk's end T becomes the T_after of the last alive slot (or
//     stays): the chunk reset of the streamed kernels. T therefore never
//     drops below t_min, so the TPU kernel's second loop condition
//     (max T >= t_min) never ends the walk and is not carried over;
//   * img = accum + bg * T, tfin = T.
//
// Bound on the card: the (pixel, slot) evaluations of the walked chunks,
// each one exp + log1p + exp on the SFU and ~20 FP32 operations; the table
// itself is read once (36 B a slot against 256 evaluations). Design: one CTA
// of tile_size^2 threads per row, one thread per pixel; a chunk's
// chunk x F floats are one contiguous block of the row, staged through
// shared memory with coalesced loads, then every thread walks the slots in
// order (all threads read the same shared address: a broadcast) and stops at
// its first dead slot. Deterministic, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

#include "composite_alpha.cuh"

namespace {

__global__ void table_fwd_kernel(
    const float* __restrict__ table, const int32_t* __restrict__ count,
    const int32_t* __restrict__ tile_ids, const float* __restrict__ bg, int channels,
    int cap, int tiles_x, int ts, int chunk, int n_chunks, float alpha_clamp,
    float alpha_min, float one_minus_clamp, float t_min, float* __restrict__ img,
    float* __restrict__ tfin, float* __restrict__ tchk) {
  extern __shared__ float sm[];  // chunk * feat
  const int r = blockIdx.x;
  const int l = threadIdx.x;
  const int p = ts * ts;
  const int feat = 6 + channels;
  const int t_img = tile_ids[r];
  const int tx = t_img % tiles_x;
  const int ty = t_img / tiles_x;
  const float px = (float)(tx * ts + l % ts) + 0.5f;
  const float py = (float)(ty * ts + l / ts) + 0.5f;
  const int cnt = count[r];
  const float* row = table + (long long)r * cap * feat;

  float T = 1.0f;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int i = 0; i < n_chunks; ++i) {
    float* chk = tchk + ((long long)r * n_chunks + i) * p + l;
    if (i * chunk >= cnt) {  // uniform across the CTA
      *chk = 0.0f;
      continue;
    }
    __syncthreads();  // the previous chunk's slots are no longer read
    const float* src = row + (long long)i * chunk * feat;
    for (int k = l; k < chunk * feat; k += blockDim.x) sm[k] = src[k];
    __syncthreads();
    *chk = T;

    float incl = 0.0f;
    float t_last = T;
    bool any_alive = false;
    for (int j = 0; j < chunk; ++j) {
      const float* f = sm + j * feat;
      const float alpha =
          pair_alpha(px, py, f[0], f[1], f[2], f[3], f[4], f[5], alpha_clamp, alpha_min).alpha;
      incl += log1pf(-alpha);
      const float t_after = T * expf(incl);
      if (!(t_after >= t_min)) break;  // every later slot of the chunk is dead
      const float w = (t_after / fmaxf(1.0f - alpha, one_minus_clamp)) * alpha;
      for (int c = 0; c < channels; ++c) acc[c] += w * f[6 + c];
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

// table (rows, cap, 6 + channels) f32; count/tile_ids (rows,) i32;
// bg (rows, ch) f32; outputs img (rows, ch, ts*ts), tfin (rows, ts*ts),
// tchk (rows, n_chunks, ts*ts) f32, with n_chunks * chunk == cap.
extern "C" int pf3_table_fwd(const void* table, const void* count, const void* tile_ids,
                             const void* bg, int rows, int channels, int cap, int tiles_x,
                             int ts, int chunk, int n_chunks, float alpha_clamp,
                             float alpha_min, float one_minus_clamp, float t_min, void* img,
                             void* tfin, void* tchk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)chunk * (6 + channels);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        table_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0) {
    table_fwd_kernel<<<rows, ts * ts, smem, s>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(tile_ids), static_cast<const float*>(bg), channels, cap,
        tiles_x, ts, chunk, n_chunks, alpha_clamp, alpha_min, one_minus_clamp, t_min,
        static_cast<float*>(img), static_cast<float*>(tfin), static_cast<float*>(tchk));
  }
  return (int)cudaGetLastError();
}
