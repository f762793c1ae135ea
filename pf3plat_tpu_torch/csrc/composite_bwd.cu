// Streamed compositing backward (kernel B3), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/streamed.py:
// _streamed_bwd_rmw_kernel` (+ `_bwd_rmw_one_tile`, `_bwd_chunk_grads`):
// per tile row, the per-pair gradients of [x, y, ca, cb, cc, op, c0..c2]
// in sorted order, plus d(background) per tile. The arithmetic and the
// block's plan are in composite_bwd_walk.cuh, shared with kernel B5.
//
// The TPU kernel read-modify-writes each 128-row window because adjacent
// tiles' windows overlap. Here each sorted row belongs to exactly one tile
// segment, so a CTA writes only its own rows [off, off + count) of its
// window, once, and leaves every other row to the caller's zero fill:
// deterministic, no atomics.
//
// Bound on the card: operations. Per (pixel, in-segment pair) evaluation
// the forward sweep repeats B2's ~23 operations (2 SFU: exp, log1p, exp)
// and the reverse sweep ~59 more (one exp, one division, the 9 partials and
// their share of the warp reductions): ~82 in all.

#include "composite_bwd_walk.cuh"

namespace {

__global__ void composite_bwd_kernel(
    const float* __restrict__ feat, long long plane,
    const int32_t* __restrict__ base, const int32_t* __restrict__ off,
    const int32_t* __restrict__ count, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ nproc, const float* __restrict__ bg,
    const float* __restrict__ tfin, const float* __restrict__ tchk,
    const float* __restrict__ gimg, int channels, int tiles_x, int ts, int chunk,
    int n_chunks, float alpha_clamp, float alpha_min, float one_minus_clamp,
    float t_min, float* __restrict__ dP, float* __restrict__ dbg) {
  composite_bwd_row<false>(feat, plane, base, off, count, tile_ids, nproc, bg, tfin, tchk,
                           gimg, channels, tiles_x, ts, chunk, n_chunks, alpha_clamp,
                           alpha_min, one_minus_clamp, t_min, dP, dbg);
}

}  // namespace

// feat (9, plane) f32; base/off/count/tile_ids/nproc (rows,) i32;
// bg (rows, ch), tfin (rows, ts*ts), tchk (rows, n_chunks, ts*ts),
// gimg (rows, ch, ts*ts) f32; outputs dP (9, plane) f32, zero-filled by the
// caller (only rows inside a tile segment are written), and dbg (rows, ch).
extern "C" int pf3_composite_bwd(const void* feat, long long plane, const void* base,
                                 const void* off, const void* count, const void* tile_ids,
                                 const void* nproc, const void* bg, const void* tfin,
                                 const void* tchk, const void* gimg, int rows, int channels,
                                 int tiles_x, int ts, int chunk, int n_chunks,
                                 float alpha_clamp, float alpha_min, float one_minus_clamp,
                                 float t_min, void* dP, void* dbg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = composite_bwd_smem(ts, chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0) {
    composite_bwd_kernel<<<rows, ts * ts, smem, s>>>(
        static_cast<const float*>(feat), plane, static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(off), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(tile_ids), static_cast<const int32_t*>(nproc),
        static_cast<const float*>(bg), static_cast<const float*>(tfin),
        static_cast<const float*>(tchk), static_cast<const float*>(gimg), channels, tiles_x,
        ts, chunk, n_chunks, alpha_clamp, alpha_min, one_minus_clamp, t_min,
        static_cast<float*>(dP), static_cast<float*>(dbg));
  }
  return (int)cudaGetLastError();
}
