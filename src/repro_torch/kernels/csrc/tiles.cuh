// Tile bodies of the kernel-matrix kernel (kernel_matrix.cu): one kernel
// value K(x, z) per call.  The fused dual-ascent solver (solver.cu) shares
// the kinds, the sech2 constants and softplus, and repeats these bodies in
// its own layout (fill_column), in the same arithmetic order.
//
// Counterparts of repro/kernels/rbf.py linear_tile / rbf_tile / sech2_tile,
// resolved there by tile_body().  The arithmetic is f32 throughout:
//   linear: x.z
//   rbf:    exp(-gamma * max(|x|^2 + |z|^2 - 2 x.z, 0))   (expanded form:
//           the reference tolerances are set against its cancellation)
//   sech2:  exp(sum_k [log 4 - softplus(-s dv_k) - softplus(s dv_k)]),
//           s = sqrt(gamma / gamma0) * v_scale / (n_slope V_T)
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

enum TileKind : int { kLinear = 0, kRbf = 1, kSech2 = 2, kGram = 3 };

// f32 constants of the sech2 input scaling, rounded from the host's double
// values exactly as the reference's weakly typed Python floats are.
struct Sech2Consts {
  float gamma0;   // v_scale^2 / (4 n_slope^2 V_T^2)
  float v_scale;
  float nvt;      // n_slope * V_T
};

__device__ __forceinline__ float sech2_scale(float gamma, Sech2Consts c) {
  return sqrtf(gamma / c.gamma0) * c.v_scale / c.nvt;
}

__device__ __forceinline__ float dot_d(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], b[k], acc);
  return acc;
}

__device__ __forceinline__ float linear_tile(const float* x, const float* z,
                                             int d) {
  return dot_d(x, z, d);
}

// xx = |x|^2 and zz = |z|^2 are precomputed by the caller (once per row).
__device__ __forceinline__ float rbf_tile(const float* x, const float* z,
                                          float xx, float zz, int d,
                                          float gamma) {
  const float xz = dot_d(x, z, d);
  const float d2 = fmaxf(xx + zz - 2.f * xz, 0.f);
  return expf(-gamma * d2);
}

// Stable softplus, as jax.nn.softplus computes it (logaddexp(v, 0)).
__device__ __forceinline__ float softplus(float v) {
  return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
}

__device__ __forceinline__ float sech2_tile(const float* x, const float* z,
                                            int d, float s) {
  const float log4 = 1.38629436111989061883f;
  float acc = 0.f;
  for (int k = 0; k < d; ++k) {
    const float dv = (x[k] - z[k]) * s;
    acc += log4 - softplus(-dv) - softplus(dv);
  }
  return expf(acc);
}

// One kernel value of the given kind.  `s` is the sech2 input scale
// (ignored otherwise); `xx`/`zz` the squared norms (rbf only).
__device__ __forceinline__ float tile_value(int kind, const float* x,
                                            const float* z, float xx,
                                            float zz, int d, float gamma,
                                            float s) {
  if (kind == kRbf) return rbf_tile(x, z, xx, zz, d, gamma);
  if (kind == kSech2) return sech2_tile(x, z, d, s);
  return linear_tile(x, z, d);
}

__device__ __forceinline__ float sq_norm(const float* x, int d) {
  return dot_d(x, x, d);
}

}  // namespace repro_torch
