// Dense-table forward compositing (kernel B6), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/pallas_impl.py:
// _fwd_kernel` (+ `_chunk_alpha`). One table row is one (camera, tile): its
// first `cap` gaussians in depth order, one slot each, slot-major
// [x, y, ca, cb, cc, op, color...] (F = 6 + channels floats a slot), zeros
// past the row's count. Semantics copied from the TPU kernel exactly:
//   * pixel centres come from tile_ids[row], not from the block index;
//   * chunk i is walked iff i * chunk < count[row]; tchk[i] = T at its start,
//     written before compositing, and 0 for chunks never walked (kernel B7
//     walks the chunks whose checkpoint is above 0);
//   * every slot of a walked chunk is composited (a zero slot has alpha 0);
//   * alpha, the chunk's T recurrence, the weight and the chunk reset are
//     the streamed kernels' (composite_fwd_walk.cuh). T therefore never
//     drops below t_min, so the TPU kernel's second loop condition (max T
//     >= t_min) never ends the walk and is not carried over;
//   * img = accum + bg * T, tfin = T.
//
// Bound on the card: operations, ~23 per (pixel, slot) evaluation of a
// walked chunk as first counted; the table itself is read once (36 B a slot
// against 256 evaluations). B6 computes what B2 computes on another
// layout, so it is B2's walk (composite_fwd_walk.cuh, Layout::kTable): its
// first design (one CTA of ts^2 threads per row in launch order, each chunk
// copied with scalar loads between two barriers, exp + log1p + exp for
// every evaluation, tiles of a multiple of 32 pixels only) is gone; this one
// runs power tests per 8-slot sub-block and the exponentials only for
// candidates, 4 CTAs an SM, rows heaviest first, any tile of up to 1024
// pixels. Deterministic, no atomics.

#include "composite_fwd_walk.cuh"

// table (rows, cap, 6 + channels) f32; count/tile_ids (rows,) i32; order
// (rows,) i32, the table row of each CTA (a permutation); bg (rows, ch)
// f32; outputs img (rows, ch, ts*ts), tfin (rows, ts*ts), tchk (rows,
// n_chunks, ts*ts) f32, with n_chunks * chunk == cap and ts * ts at most
// 1024.
extern "C" int pf3_table_fwd(const void* table, const void* count, const void* tile_ids,
                             const void* order, const void* bg, int rows, int channels, int cap,
                             int tiles_x, int ts, int chunk, int n_chunks, float alpha_clamp,
                             float alpha_min, float one_minus_clamp, float t_min, void* img,
                             void* tfin, void* tchk, void* stream) {
  if (n_chunks * chunk != cap || channels < 1 || channels > 3) return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const float*>(table), 0, nullptr, nullptr,
                  static_cast<const int32_t*>(count), static_cast<const int32_t*>(tile_ids),
                  static_cast<const int32_t*>(order), static_cast<const float*>(bg), channels,
                  tiles_x, ts, chunk, n_chunks, alpha_clamp, alpha_min, one_minus_clamp, t_min,
                  static_cast<float*>(img), static_cast<float*>(tfin), static_cast<float*>(tchk)};
  return composite_fwd_launch<Layout::kTable>(a, rows, stream);
}

// Shared memory of one CTA (bytes) at this tile size and chunk.
extern "C" long long pf3_table_fwd_smem(int ts, int chunk) {
  return (long long)composite_fwd_smem(ts, chunk);
}

// CTAs that fit one SM; negative on an error.
extern "C" int pf3_table_fwd_occupancy(int ts, int chunk) {
  return composite_fwd_occupancy<Layout::kTable>(ts, chunk);
}
