// Streamed forward compositing (kernel B2), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/streamed.py:
// _streamed_fwd_kernel` (+ `_fwd_one_tile`, `_chunk_alpha_cols`). Per tile
// row it composites the tile's depth-sorted segment [off, off + count) of
// the window that starts at base * chunk, front to back, walking the window
// in `chunk`-row chunks while chunk * i < off + count, with the TPU
// kernel's chunk reset; tchk[i] = T at the start of chunk i (1 for chunks
// before the segment, 0 for chunks never reached), img = accum + bg * T,
// tfin = T. This differs from the CUDA 3DGS rasterizer, which stops at the
// first failure for good. tfin and tchk are what kernels B3 and B5 replay
// from.
//
// The walk, its arithmetic, its launch and its design for the card are in
// composite_fwd_walk.cuh (Layout::kStreamed), shared with kernel B6. Bound
// on the card: operations, ~23 per (pixel, in-segment pair) evaluation as
// first counted, although a few percent of them touch their pixel.

#include "composite_fwd_walk.cuh"

// feat (9, plane) f32; base/off/count/tile_ids (rows,) i32; order (rows,)
// i32, the tile row of each CTA (a permutation); bg (rows, ch) f32; outputs
// img (rows, ch, ts*ts), tfin (rows, ts*ts), tchk (rows, n_chunks, ts*ts)
// f32. ts * ts is at most 1024.
extern "C" int pf3_composite_fwd(const void* feat, long long plane, const void* base,
                                 const void* off, const void* count, const void* tile_ids,
                                 const void* order, const void* bg, int rows, int channels,
                                 int tiles_x, int ts, int chunk, int n_chunks,
                                 float alpha_clamp, float alpha_min, float one_minus_clamp,
                                 float t_min, void* img, void* tfin, void* tchk, void* stream) {
  const FwdArgs a{static_cast<const float*>(feat), plane, static_cast<const int32_t*>(base),
                  static_cast<const int32_t*>(off), static_cast<const int32_t*>(count),
                  static_cast<const int32_t*>(tile_ids), static_cast<const int32_t*>(order),
                  static_cast<const float*>(bg), channels, tiles_x, ts, chunk, n_chunks,
                  alpha_clamp, alpha_min, one_minus_clamp, t_min, static_cast<float*>(img),
                  static_cast<float*>(tfin), static_cast<float*>(tchk)};
  return composite_fwd_launch<Layout::kStreamed>(a, rows, stream);
}

// Shared memory of one CTA (bytes) at this tile size and chunk.
extern "C" long long pf3_composite_fwd_smem(int ts, int chunk) {
  return (long long)composite_fwd_smem(ts, chunk);
}

// CTAs that fit one SM; negative on an error.
extern "C" int pf3_composite_fwd_occupancy(int ts, int chunk) {
  return composite_fwd_occupancy<Layout::kStreamed>(ts, chunk);
}
