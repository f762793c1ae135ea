// Per-(pixel, pair) alpha of the streamed compositor, shared by kernels B2
// (composite_fwd.cu) and B3 (composite_bwd.cu).
//
// The backward recomputes the forward's transmittance and thresholds it
// (alive iff T_after >= t_min), so both kernels must round every step the
// same way or a pair near the threshold flips between the two passes. The
// arithmetic is written with explicit round-to-nearest intrinsics, which
// nvcc never contracts into FMAs, so it is the same instruction sequence in
// both translation units.

#pragma once

struct PairAlpha {
  float dx, dy;      // pixel centre minus the gaussian's mean
  float power;       // -0.5 (ca dx^2 + cc dy^2) - cb dx dy
  float gexp;        // exp(min(power, 0))
  float alpha;       // min(op * gexp, alpha_clamp), 0 unless kept
  bool unclamped;    // kept and op * gexp < alpha_clamp
};

__device__ __forceinline__ PairAlpha pair_alpha(float px, float py, float x0, float y0,
                                                float ca, float cb, float cc, float op,
                                                float alpha_clamp, float alpha_min) {
  PairAlpha a;
  a.dx = __fsub_rn(px, x0);
  a.dy = __fsub_rn(py, y0);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, a.dx), a.dx),
                               __fmul_rn(__fmul_rn(cc, a.dy), a.dy));
  a.power = __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, a.dx), a.dy));
  a.gexp = expf(fminf(a.power, 0.0f));
  const float raw = __fmul_rn(op, a.gexp);
  a.alpha = fminf(raw, alpha_clamp);
  const bool keep = a.power <= 0.0f && a.alpha >= alpha_min;
  if (!keep) a.alpha = 0.0f;
  a.unclamped = keep && raw < alpha_clamp;
  return a;
}
