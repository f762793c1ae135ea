// Streamed compositing backward with block outputs (kernel B5), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/streamed.py:
// _streamed_bwd_blocks_kernel`, the backward of the mesh path without pair
// compaction: a shard composites a slice of the tile rows against the whole
// sorted feature array, and its backward may not write into that shared
// array. So the kernel emits, per (tile row r, chunk i), the (9, chunk)
// gradients of the window rows base[r] * chunk + i * chunk + lane as one
// block, pure writes with no ordering between rows or shards; the caller
// concatenates the shards' blocks and merges them into sorted order with one
// scatter-add over rows * n_chunks window indices (`streamed.merge_blocks`).
// A block holds exact zeros outside the tile's segment [off, off + count),
// and the blocks of chunks the forward did not process are zeros too, all
// written here: the caller allocates without clearing. 9 feature rows per
// block, not the 16 sublane-padded rows of the TPU kernel.
//
// The walk is kernel B3's own (composite_bwd_walk.cuh), so a merged result
// equals B3's output on the same inputs bit for bit.
//
// Bound on the card: the operations of the walk (~82 per (pixel,
// in-segment pair) evaluation, as B3) or the bytes of the blocks
// (rows * n_chunks * 9 * chunk floats written once), whichever is larger.
// The design against it is B3's: no per-(pair, pixel) T store, >= 3 CTAs
// of 8 warps an SM (68,096 bytes of shared memory at chunk 128), 12
// shuffles per pair and warp, no work for evaluations whose alpha is 0.

#include "composite_bwd_walk.cuh"

// feat (9, plane) f32; base/off/count/tile_ids/nproc (rows,) i32; order
// (rows,) i32, the tile row of each CTA; bg (rows, ch), tfin (rows, ts*ts),
// tchk (rows, n_chunks, ts*ts), gimg (rows, ch, ts*ts) f32; outputs dblk
// (rows, n_chunks, 9, chunk) f32, every element written, and dbg (rows,
// ch).
extern "C" int pf3_composite_bwd_blocks(
    const void* feat, long long plane, const void* base, const void* off, const void* count,
    const void* tile_ids, const void* nproc, const void* order, const void* bg, const void* tfin,
    const void* tchk, const void* gimg, int rows, int channels, int tiles_x, int ts, int chunk,
    int n_chunks, float alpha_clamp, float alpha_min, float one_minus_clamp, float t_min,
    void* dblk, void* dbg, void* stream) {
  return composite_bwd_launch<Layout::kBlocks>(
      streamed_walk_args(feat, plane, base, off, count, tile_ids, nproc, order, bg, tfin, tchk,
                         gimg, channels, tiles_x, ts, chunk, n_chunks, alpha_clamp,
                         alpha_min, one_minus_clamp, t_min, dblk, dbg),
      rows, stream);
}

// Shared memory of one CTA (bytes) at this tile size and chunk.
extern "C" long long pf3_composite_bwd_blocks_smem(int ts, int chunk) {
  return (long long)composite_bwd_smem(ts, chunk);
}

// CTAs that fit one SM; negative on an error.
extern "C" int pf3_composite_bwd_blocks_occupancy(int ts, int chunk) {
  return composite_bwd_occupancy<Layout::kBlocks>(ts, chunk);
}
