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
//     tchk[i] is above 0 at some pixel: B6 writes a checkpoint above 0 for
//     exactly the chunks with i * chunk < count, a prefix, so the wrapper
//     passes their number (`streamed.n_processed`); every slot of a chunk
//     that is not walked gets a zero gradient;
//   * the gradients are B3's, slot for pair (composite_bwd_walk.cuh).
//
// Each (row, slot) of d(table) is written once, by the row's own CTA:
// deterministic, no atomics, fixed summation order.
//
// Bound on the card: operations, ~82 per (pixel, slot) evaluation of a
// walked chunk as first counted, as kernel B3. B7 computes what B3
// computes on another layout, so it is B3's walk (Layout::kTable): a
// chunk is one contiguous chunk x F block of the row, fetched with 16-byte
// cp.async copies while the previous chunk is walked; no per-(slot, pixel)
// T store, >= 3 CTAs of 8 warps an SM (68,096 bytes of shared memory at
// chunk 128 and 16 x 16 tiles, where the first design needed 172,544 and
// refused 32 x 32 tiles), no log1p, exponential, gradient or shuffle for an
// evaluation whose alpha is 0, 12 shuffles per slot and warp, rows started
// heaviest first; tiles of up to 1024 pixels walked in parts.

#include "composite_bwd_walk.cuh"

// table (rows, n_chunks * chunk, 6 + channels) f32; count/tile_ids/nproc
// (rows,) i32; order (rows,) i32, the table row of each CTA; bg (rows, ch),
// tfin (rows, ts*ts), tchk (rows, n_chunks, ts*ts), gimg (rows, ch, ts*ts),
// gtfin (rows, ts*ts) f32; outputs dtab (the table's shape, every element
// written) and dbg (rows, ch).
extern "C" int pf3_table_bwd(const void* table, const void* count, const void* tile_ids,
                             const void* nproc, const void* order, const void* bg,
                             const void* tfin, const void* tchk, const void* gimg,
                             const void* gtfin, int rows, int channels, int tiles_x, int ts,
                             int chunk, int n_chunks, float alpha_clamp, float alpha_min,
                             float one_minus_clamp, float t_min, void* dtab, void* dbg,
                             void* stream) {
  const WalkArgs a{static_cast<const float*>(table), 0, nullptr, nullptr,
                   static_cast<const int32_t*>(count), static_cast<const int32_t*>(tile_ids),
                   static_cast<const int32_t*>(nproc), static_cast<const int32_t*>(order),
                   static_cast<const float*>(bg), static_cast<const float*>(tfin),
                   static_cast<const float*>(tchk), static_cast<const float*>(gimg),
                   static_cast<const float*>(gtfin), channels, tiles_x, ts, chunk, n_chunks,
                   alpha_clamp, alpha_min, one_minus_clamp, t_min, static_cast<float*>(dtab),
                   static_cast<float*>(dbg)};
  return composite_bwd_launch<Layout::kTable>(a, rows, stream);
}

// Shared memory of one CTA (bytes) at this tile size and chunk.
extern "C" long long pf3_table_bwd_smem(int ts, int chunk) {
  return (long long)composite_bwd_smem(ts, chunk);
}

// CTAs that fit one SM; negative on an error.
extern "C" int pf3_table_bwd_occupancy(int ts, int chunk) {
  return composite_bwd_occupancy<Layout::kTable>(ts, chunk);
}
