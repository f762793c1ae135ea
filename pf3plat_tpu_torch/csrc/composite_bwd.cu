// Streamed compositing backward (kernel B3), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/streamed.py:
// _streamed_bwd_rmw_kernel` (+ `_bwd_rmw_one_tile`, `_bwd_chunk_grads`):
// per tile row, the per-pair gradients of [x, y, ca, cb, cc, op, c0..c2]
// in sorted order, plus d(background) per tile. The walk, its arithmetic
// and its launch are in composite_bwd_walk.cuh, shared with kernels B5 and
// B7.
//
// The TPU kernel read-modify-writes each 128-row window because adjacent
// tiles' windows overlap. Here each sorted row belongs to exactly one tile
// segment, so a CTA writes only its own rows [off, off + count) of its
// window, once, and leaves every other row to the caller's zero fill:
// deterministic, no atomics.
//
// Bound on the card: operations, ~82 per (pixel, in-segment pair)
// evaluation as first counted (B2's alpha and T recurrence, then the
// gradients); instruction rate and latency hold the walk below that. The
// design (composite_bwd_walk.cuh): no per-(pair, pixel) T store (a replay from
// 8-pair sub-block checkpoints), 68,096 bytes of shared memory at chunk
// 128 and >= 3 CTAs of 8 warps an SM, no log1p, exponential, gradient or
// shuffle for an evaluation whose alpha is 0, and 12 shuffles instead of
// 45 for a pair's 9 sums over a warp. Tiles of up to 1024 pixels are
// walked in parts of at most 256; where the pixel count is no multiple of
// 32 the lanes past the tile's last pixel idle.

#include "composite_bwd_walk.cuh"

// feat (9, plane) f32; base/off/count/tile_ids/nproc (rows,) i32; order
// (rows,) i32, the tile row of each CTA; bg (rows, ch), tfin (rows, ts*ts),
// tchk (rows, n_chunks, ts*ts), gimg (rows, ch, ts*ts) f32; outputs dP (9,
// plane) f32, zero-filled by the caller (only rows inside a tile segment
// are written), and dbg (rows, ch).
extern "C" int pf3_composite_bwd(const void* feat, long long plane, const void* base,
                                 const void* off, const void* count, const void* tile_ids,
                                 const void* nproc, const void* order, const void* bg,
                                 const void* tfin, const void* tchk, const void* gimg, int rows,
                                 int channels, int tiles_x, int ts, int chunk, int n_chunks,
                                 float alpha_clamp, float alpha_min, float one_minus_clamp,
                                 float t_min, void* dP, void* dbg, void* stream) {
  return composite_bwd_launch<Layout::kStreamed>(
      streamed_walk_args(feat, plane, base, off, count, tile_ids, nproc, order, bg, tfin, tchk,
                         gimg, channels, tiles_x, ts, chunk, n_chunks, alpha_clamp,
                         alpha_min, one_minus_clamp, t_min, dP, dbg),
      rows, stream);
}

// Shared memory of one CTA (bytes) at this tile size and chunk.
extern "C" long long pf3_composite_bwd_smem(int ts, int chunk) {
  return (long long)composite_bwd_smem(ts, chunk);
}

// CTAs that fit one SM; negative on an error.
extern "C" int pf3_composite_bwd_occupancy(int ts, int chunk) {
  return composite_bwd_occupancy<Layout::kStreamed>(ts, chunk);
}

// Pairs per sub-block of the walk (kSub), shared with kernels B2, B5 and B7.
extern "C" int pf3_composite_bwd_sub_block() { return kSub; }
