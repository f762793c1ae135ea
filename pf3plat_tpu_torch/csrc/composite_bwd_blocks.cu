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
// The arithmetic is kernel B3's own (composite_bwd_walk.cuh), so a merged
// result equals B3's output on the same inputs bit for bit.
//
// Bound on the card: the operations of the walk (~82 per (pixel,
// in-segment pair) evaluation, as B3) or the bytes of the blocks
// (rows * n_chunks * 9 * chunk floats written once), whichever is larger.
// Shared memory as B3: 172 KB at chunk 128 and 256 pixels, one CTA per SM.

#include "composite_bwd_walk.cuh"

namespace {

__global__ void composite_bwd_blocks_kernel(
    const float* __restrict__ feat, long long plane,
    const int32_t* __restrict__ base, const int32_t* __restrict__ off,
    const int32_t* __restrict__ count, const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ nproc, const float* __restrict__ bg,
    const float* __restrict__ tfin, const float* __restrict__ tchk,
    const float* __restrict__ gimg, int channels, int tiles_x, int ts, int chunk,
    int n_chunks, float alpha_clamp, float alpha_min, float one_minus_clamp,
    float t_min, float* __restrict__ dblk, float* __restrict__ dbg) {
  composite_bwd_row<true>(feat, plane, base, off, count, tile_ids, nproc, bg, tfin, tchk,
                          gimg, channels, tiles_x, ts, chunk, n_chunks, alpha_clamp,
                          alpha_min, one_minus_clamp, t_min, dblk, dbg);
}

}  // namespace

// feat (9, plane) f32; base/off/count/tile_ids/nproc (rows,) i32;
// bg (rows, ch), tfin (rows, ts*ts), tchk (rows, n_chunks, ts*ts),
// gimg (rows, ch, ts*ts) f32; outputs dblk (rows, n_chunks, 9, chunk) f32,
// every element written, and dbg (rows, ch).
extern "C" int pf3_composite_bwd_blocks(
    const void* feat, long long plane, const void* base, const void* off, const void* count,
    const void* tile_ids, const void* nproc, const void* bg, const void* tfin,
    const void* tchk, const void* gimg, int rows, int channels, int tiles_x, int ts,
    int chunk, int n_chunks, float alpha_clamp, float alpha_min, float one_minus_clamp,
    float t_min, void* dblk, void* dbg, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = composite_bwd_smem(ts, chunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        composite_bwd_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0) {
    composite_bwd_blocks_kernel<<<rows, ts * ts, smem, s>>>(
        static_cast<const float*>(feat), plane, static_cast<const int32_t*>(base),
        static_cast<const int32_t*>(off), static_cast<const int32_t*>(count),
        static_cast<const int32_t*>(tile_ids), static_cast<const int32_t*>(nproc),
        static_cast<const float*>(bg), static_cast<const float*>(tfin),
        static_cast<const float*>(tchk), static_cast<const float*>(gimg), channels, tiles_x,
        ts, chunk, n_chunks, alpha_clamp, alpha_min, one_minus_clamp, t_min,
        static_cast<float*>(dblk), static_cast<float*>(dbg));
  }
  return (int)cudaGetLastError();
}
