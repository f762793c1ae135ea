// Clipped Adam over every trained leaf at once: a norm pass and an update
// pass, sm_90a.
//
// Replaces no TPU kernel: the JAX package's optimizer is optax's
// apply_if_finite(chain(clip_by_global_norm, adam)), which XLA fuses into
// the jitted train step. The port's plain version
// (`training/train.py:opt_update`, then `p.add_`) issues about fifteen
// PyTorch operations a leaf and syncs with the host twice; these two
// kernels make an update in two launches and one host read between them.
//
// Bound on the card: bytes, 32 B an element in float32. The norm pass reads
// each gradient once (4 B); the update pass reads the gradient, the
// parameter and both moments and writes the parameter and both moments
// (28 B). Both passes walk a work list of (leaf, start, length, vector
// length) items, each at most one chunk of a leaf (`train.ADAM_CHUNK`
// elements), over per-leaf pointer tables: a persistent grid of as many
// blocks as fit the card, each taking items blockIdx.x, + gridDim.x, ...
// An item's first `vector length` elements move in 16-byte accesses (the
// wrapper sets it to 0 where the leaf's parameter or moments are not
// 16-byte aligned; the gradient's alignment, which changes every step, is
// tested here), the rest one at a time; every access is a streaming one
// (__ldcs / __stcs), since each byte is touched once a pass. A null
// gradient pointer is a leaf without a gradient: zeros.
//
// The norm pass is deterministic: each item's sum of squares is reduced in
// a fixed order into partials[item]; a non-finite element sets an integer
// flag (atomicOr); the last block to take a ticket sums the partials in
// item order with one fixed tree and writes out = [sum, flag, sqrt(sum)],
// then rearms the flag and the ticket for the next launch.
//
// The update pass repeats opt_update's float32 operations one rounding at
// a time (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into
// an FMA), with the constants as the wrapper computes them from the Python
// scalars torch receives:
//   clip (only when the host found !(norm < max_norm)): g = (g / norm) * max_norm
//   m = b1c * g + b1 * m;  v = b2c * (g * g) + b2 * v
//   p = p + neg_lr * ((m * inv_bc1) / (sqrt(v * inv_bc2 + eps_root) + eps))
// (torch on the card divides a tensor by a host scalar as a product with
// the scalar's float32 reciprocal, so m / bc1 is m * inv_bc1 here too).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct AdamArgs {
  int clip;
  float norm, max_norm, b1c, b1, b2c, b2, inv_bc1, inv_bc2, eps_root, eps, neg_lr;
};

__device__ __forceinline__ unsigned nonfinite(float x) {
  return (__float_as_uint(x) & 0x7f800000u) == 0x7f800000u;
}

// The block's sum in a fixed order (valid in thread 0); every thread calls it.
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = 0.0f;
  if (warp == 0) {
    x = lane < kWarps ? red[lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  }
  __syncthreads();
  return x;
}

__device__ __forceinline__ const float* grad_of(const unsigned long long* grads, int4 it,
                                                int* vec) {
  const float* g = reinterpret_cast<const float*>(grads[it.x]);
  if (g == nullptr) return nullptr;
  g += it.y;
  if (reinterpret_cast<uintptr_t>(g) & 15) *vec = 0;
  return g;
}

// items (n_items, 4) int32: leaf, start, length, vector length; grads: one
// pointer a leaf (0: no gradient); partials (n_items,) f32 scratch; sync
// (2,) u32 zeroed before the first launch (flag, ticket); out (3,) f32.
__global__ void __launch_bounds__(kThreads)
adam_norm_kernel(const int4* __restrict__ items, int n_items,
                 const unsigned long long* __restrict__ grads, float* __restrict__ partials,
                 unsigned* __restrict__ sync, float* __restrict__ out) {
  __shared__ float red[kWarps];
  __shared__ bool last;
  unsigned bad = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int4 it = items[w];
    int vec = it.w;
    const float* g = grad_of(grads, it, &vec);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (g != nullptr) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      for (int i = threadIdx.x; i < vec / 4; i += kThreads) {
        const float4 x = __ldcs(g4 + i);
        a0 = fmaf(x.x, x.x, a0);
        a1 = fmaf(x.y, x.y, a1);
        a2 = fmaf(x.z, x.z, a2);
        a3 = fmaf(x.w, x.w, a3);
        bad |= nonfinite(x.x) | nonfinite(x.y) | nonfinite(x.z) | nonfinite(x.w);
      }
      for (int i = vec + threadIdx.x; i < it.z; i += kThreads) {
        const float x = __ldcs(g + i);
        a0 = fmaf(x, x, a0);
        bad |= nonfinite(x);
      }
    }
    const float s = block_sum((a0 + a1) + (a2 + a3), red);
    if (threadIdx.x == 0) partials[w] = s;
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) {
    if (bad) atomicOr(sync, 1u);
    __threadfence();
    last = atomicAdd(sync + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float s = 0.0f;
  for (int i = threadIdx.x; i < n_items; i += kThreads) s += __ldcg(partials + i);
  s = block_sum(s, red);
  if (threadIdx.x == 0) {
    const unsigned flag = atomicExch(sync, 0u);
    sync[1] = 0u;
    out[0] = s;
    out[1] = flag ? 1.0f : 0.0f;
    out[2] = __fsqrt_rn(s);
  }
}

__device__ __forceinline__ void adam_one(float g, float& p, float& m, float& v,
                                         const AdamArgs& a) {
  if (a.clip) g = __fmul_rn(__fdiv_rn(g, a.norm), a.max_norm);
  m = __fadd_rn(__fmul_rn(a.b1c, g), __fmul_rn(a.b1, m));
  v = __fadd_rn(__fmul_rn(a.b2c, __fmul_rn(g, g)), __fmul_rn(a.b2, v));
  const float den =
      __fadd_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(v, a.inv_bc2), a.eps_root)), a.eps);
  p = __fadd_rn(p, __fmul_rn(a.neg_lr, __fdiv_rn(__fmul_rn(m, a.inv_bc1), den)));
}

// params, mus, nus: one pointer a leaf; updated in place.
__global__ void __launch_bounds__(kThreads)
adam_update_kernel(const int4* __restrict__ items, int n_items,
                   const unsigned long long* __restrict__ grads,
                   const unsigned long long* __restrict__ params,
                   const unsigned long long* __restrict__ mus,
                   const unsigned long long* __restrict__ nus, const AdamArgs a) {
  for (int w = blockIdx.x; w < n_items; w += gridDim.x) {
    const int4 it = items[w];
    int vec = it.w;
    const float* g = grad_of(grads, it, &vec);
    float* p = reinterpret_cast<float*>(params[it.x]) + it.y;
    float* m = reinterpret_cast<float*>(mus[it.x]) + it.y;
    float* v = reinterpret_cast<float*>(nus[it.x]) + it.y;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int i = threadIdx.x; i < vec / 4; i += kThreads) {
      const float4 gx = g != nullptr ? __ldcs(g4 + i) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 px = __ldcs(p4 + i);
      float4 mx = __ldcs(m4 + i);
      float4 vx = __ldcs(v4 + i);
      adam_one(gx.x, px.x, mx.x, vx.x, a);
      adam_one(gx.y, px.y, mx.y, vx.y, a);
      adam_one(gx.z, px.z, mx.z, vx.z, a);
      adam_one(gx.w, px.w, mx.w, vx.w, a);
      __stcs(p4 + i, px);
      __stcs(m4 + i, mx);
      __stcs(v4 + i, vx);
    }
    for (int i = vec + threadIdx.x; i < it.z; i += kThreads) {
      float px = __ldcs(p + i);
      float mx = __ldcs(m + i);
      float vx = __ldcs(v + i);
      adam_one(g != nullptr ? __ldcs(g + i) : 0.0f, px, mx, vx, a);
      __stcs(p + i, px);
      __stcs(m + i, mx);
      __stcs(v + i, vx);
    }
  }
}

// A persistent grid: as many blocks as fit the card at once, at most one an item.
template <typename Kernel>
int grid_for(Kernel kernel, int n_items, int* grid) {
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long fit = (long long)sms * per_sm;
  *grid = (int)(fit < n_items ? fit : n_items);
  return (int)err;
}

}  // namespace

extern "C" int pf3_adam_norm(const void* items, int n_items, const void* grads, void* partials,
                             void* sync, void* out, void* stream) {
  int grid = 0;
  const int rc = grid_for(adam_norm_kernel, n_items, &grid);
  if (rc != 0) return rc;
  if (grid > 0) {
    adam_norm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(items), n_items,
        static_cast<const unsigned long long*>(grads), static_cast<float*>(partials),
        static_cast<unsigned*>(sync), static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

extern "C" int pf3_adam_update(const void* items, int n_items, const void* grads,
                               const void* params, const void* mus, const void* nus, int clip,
                               float norm, float max_norm, float b1c, float b1, float b2c,
                               float b2, float inv_bc1, float inv_bc2, float eps_root, float eps,
                               float neg_lr, void* stream) {
  int grid = 0;
  const int rc = grid_for(adam_update_kernel, n_items, &grid);
  if (rc != 0) return rc;
  const AdamArgs a{clip, norm, max_norm, b1c, b1, b2c, b2, inv_bc1, inv_bc2, eps_root, eps,
                   neg_lr};
  if (grid > 0) {
    adam_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(items), n_items,
        static_cast<const unsigned long long*>(grads),
        static_cast<const unsigned long long*>(params),
        static_cast<const unsigned long long*>(mus), static_cast<const unsigned long long*>(nus),
        a);
  }
  return (int)cudaGetLastError();
}
