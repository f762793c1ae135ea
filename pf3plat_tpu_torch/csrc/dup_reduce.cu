// Per-gaussian gradient reduce (kernel B4), sm_90a.
//
// Replaces the TPU kernel `pf3plat_tpu/ops/rasterizer/compact.py:
// _banded_reduce_kernel` (+ `banded_dup_reduce`): the unsorted per-pair
// gradient plane (9, budget), in ascending pair-id order, is summed per
// gaussian over its <= max_dup rows (owner = id / max_dup; pad ids
// INT32_MAX own nothing). The TPU kernel did this as a one-hot matmul and
// needed Precision.HIGHEST to keep the sums exact f32; here each sum is a
// plain f32 add chain in ascending-id order from 0.0 (no matmul, no TF32),
// the order the plain version uses too.
//
// Bound on the card: bytes (the plane and the ids read once, the output
// written once). Design: one thread per gaussian g: a lower-bound binary
// search for g * max_dup in the ids, then a walk over the <= max_dup rows
// while id / max_dup == g, summing each of the 9 channels; every output is
// written once, deterministic, no atomics.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 9;

__global__ void dup_reduce_kernel(const float* __restrict__ grads, long long plane,
                                  const int32_t* __restrict__ ids, int n_gauss,
                                  int max_dup, float* __restrict__ out) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n_gauss) return;
  const long long target = (long long)g * max_dup;
  long long lo = 0;
  long long hi = plane;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if ((long long)ids[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float acc[kFeat];
#pragma unroll
  for (int f = 0; f < kFeat; ++f) acc[f] = 0.0f;
  for (long long k = lo; k < plane && k < lo + max_dup; ++k) {
    if (ids[k] / max_dup != g) break;
#pragma unroll
    for (int f = 0; f < kFeat; ++f) acc[f] += grads[f * plane + k];
  }
#pragma unroll
  for (int f = 0; f < kFeat; ++f) out[(long long)f * n_gauss + g] = acc[f];
}

}  // namespace

// grads (9, plane) f32 in ascending-id order; ids (plane,) i32 ascending,
// INT32_MAX pads last; out (9, n_gauss) f32.
extern "C" int pf3_dup_reduce(const void* grads, long long plane, const void* ids,
                              int n_gauss, int max_dup, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  if (n_gauss > 0) {
    dup_reduce_kernel<<<(n_gauss + threads - 1) / threads, threads, 0, s>>>(
        static_cast<const float*>(grads), plane, static_cast<const int32_t*>(ids), n_gauss,
        max_dup, static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}
