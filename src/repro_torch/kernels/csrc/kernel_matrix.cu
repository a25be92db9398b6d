// K1: the RBF / sech2 kernel matrix of a whole kernel bank in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/rbf.py kernel_matrix_pallas
// (bodies _rbf_kernel / _sech2_kernel), which the reference vmaps over the
// bank's pairs (repro/api/compiled.py _bank_scores).  Here the pair axis is
// the grid's z dimension:
//
//   x (n, d) queries, sv (P, m, d) support vectors, gamma (P,)
//   out (P, n, m) = K(x_i, sv[p, j]) per pair p.
//
// What bounds it on this card: d <= 5 in the paper's hardware, so the work
// per output is a handful of FMAs plus the transcendentals, and no matrix
// product is worth the tensor cores.  Both kinds are bound by writing
// their output (47 MB at har12's width, 4 x 1875 x 1582: 0.0142 ms at the
// H100 SXM's published 3.35 TB/s, 700 W); sech2's product form below,
// about 10 operations per dimension and one division, needs 0.009 ms of
// the 67 TFLOP/s f32 peak there.
//
// Design: no shared memory and no barrier.  A CTA of 32 x 8 threads covers
// up to 64 query rows x 128 support vectors.  Each thread keeps its 4
// consecutive support vectors (and their squared norms) in registers, then
// walks up to 8 query rows, each read once into registers (one broadcast
// load per warp), and writes its 4 outputs per row as one float4
// streaming store (two float2 or four scalars where m's alignment does not
// allow it).  d is a template parameter for d <= 5 (loops unrolled,
// everything in registers); larger d reads the rows in place.  Ragged row
// and column edges are masked.  Small banks (the main path's: a few
// thousand outputs) take fewer query rows per thread, so that their CTAs
// still spread over the SMs.  The rbf arithmetic is tiles.cuh's rbf_tile,
// unchanged; sech2 is evaluated in product form, one exp per dimension
// (sech2_value).
#include <cuda_runtime.h>

#include <cstdint>

#include "tiles.cuh"

namespace repro_torch {
namespace {

constexpr int kTx = 32, kTy = 8;      // 256 threads
constexpr int kCols = 4;              // consecutive outputs per thread
constexpr int kMaxRows = 8;           // query rows per thread, at most
constexpr int kFillCtas = 2 * 132;    // CTAs that keep every SM of an H100 busy

// One sech2 value in product form: per dimension, with t = exp(-|v|),
// 4 / ((1 + e^-v)(1 + e^v)) = 4t / (1 + t)^2, so one exp per dimension
// replaces sech2_tile's two softplus (an exp and a log1p each) per
// dimension and its final exp.  For d <= 5 (D > 0) the numerators and the
// denominators are multiplied apart and divided once: both stay within
// 4^5.  For larger d (D == 0) each factor, at most 1, is divided on its
// own, since 4^d overflows f32 from d = 64.  t <= 1 never overflows; where
// the value underflows it is below 1e-38.
template <int D>
__device__ __forceinline__ float sech2_value(const float* x, const float* z,
                                             int d, float s) {
  if constexpr (D > 0) {
    float num = 1.f, den = 1.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float t = expf(-fabsf((x[k] - z[k]) * s));
      const float q = 1.f + t;
      num *= 4.f * t;
      den *= q * q;
    }
    return num / den;
  } else {
    float v = 1.f;
    for (int k = 0; k < d; ++k) {
      const float t = expf(-fabsf((x[k] - z[k]) * s));
      const float q = 1.f + t;
      v *= 4.f * t / (q * q);
    }
    return v;
  }
}

template <int KIND, int D>
__device__ __forceinline__ float value(const float* x, const float* z,
                                       float xx, float zz, int d, float g,
                                       float s) {
  if constexpr (KIND == kRbf) {
    return rbf_tile(x, z, xx, zz, d, g);
  } else {
    return sech2_value<D>(x, z, d, s);
  }
}

// Four consecutive outputs at dst; vec (4, 2 or 1) is the widest store m's
// and out's alignment allow; ncol < 4 on the ragged column edge.
__device__ __forceinline__ void store4(float* dst, const float (&v)[kCols],
                                       int ncol, int vec) {
  if (ncol == kCols && vec == 4) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
  } else if (ncol == kCols && vec == 2) {
    __stcs(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
    __stcs(reinterpret_cast<float2*>(dst + 2), make_float2(v[2], v[3]));
  } else {
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      if (q < ncol) __stcs(dst + q, v[q]);
    }
  }
}

// D > 0: d == D, rows held in registers.  D == 0: any d, rows read in place.
template <int KIND, int D>
__global__ void __launch_bounds__(kTx * kTy)
kernel_matrix_kernel(const float* __restrict__ x,
                     const float* __restrict__ sv,
                     const float* __restrict__ gamma,
                     float* __restrict__ out, int n, int m, int d_rt,
                     int rows, int vec, Sech2Consts c) {
  constexpr int kReg = D > 0 ? D : 1;
  const int d = D > 0 ? D : d_rt;
  const int p = blockIdx.z;
  const int j0 = (blockIdx.x * kTx + threadIdx.x) * kCols;
  if (j0 >= m) return;
  const int ncol = min(kCols, m - j0);
  const float* svp = sv + static_cast<size_t>(p) * m * d;
  const float g = gamma[p];
  const float s = KIND == kSech2 ? sech2_scale(g, c) : 0.f;

  // The thread's support vectors; past the edge, the last one again (its
  // values are not stored).
  float zr[kCols][kReg];
  const float* zp[kCols];
  float zz[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    zp[q] = svp + static_cast<size_t>(min(j0 + q, m - 1)) * d;
    if constexpr (D > 0) {
#pragma unroll
      for (int k = 0; k < D; ++k) zr[q][k] = __ldg(zp[q] + k);
      zz[q] = sq_norm(zr[q], D);
    } else {
      zz[q] = sq_norm(zp[q], d);
    }
  }

  const int i0 = blockIdx.y * (kTy * rows) + threadIdx.y;
#pragma unroll 2
  for (int r = 0; r < rows; ++r) {
    const int i = i0 + r * kTy;
    if (i >= n) break;
    const float* xp = x + static_cast<size_t>(i) * d;
    float v[kCols];
    if constexpr (D > 0) {
      float xr[kReg];
#pragma unroll
      for (int k = 0; k < D; ++k) xr[k] = __ldg(xp + k);
      const float xx = sq_norm(xr, D);
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        v[q] = value<KIND, D>(xr, zr[q], xx, zz[q], D, g, s);
    } else {
      const float xx = sq_norm(xp, d);
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        v[q] = value<KIND, D>(xp, zp[q], xx, zz[q], d, g, s);
    }
    store4(out + (static_cast<size_t>(p) * n + i) * m + j0, v, ncol, vec);
  }
}

template <int KIND>
cudaError_t launch_kind(const float* x, const float* sv, const float* gamma,
                        float* out, int n_pairs, int n, int m, int d,
                        int vec, Sech2Consts c, cudaStream_t stream) {
  const int col_tiles = (m + kTx * kCols - 1) / (kTx * kCols);
  int rows = kMaxRows;   // halved while the grid would not fill the card
  while (rows > 1 && static_cast<long long>(col_tiles) * n_pairs *
                             ((n + kTy * rows - 1) / (kTy * rows)) <
                         kFillCtas) {
    rows /= 2;
  }
  const dim3 block(kTx, kTy);
  const dim3 grid(col_tiles, (n + kTy * rows - 1) / (kTy * rows), n_pairs);
  switch (d) {
#define K1_CASE(DD)                                                      \
  case DD:                                                               \
    kernel_matrix_kernel<KIND, DD><<<grid, block, 0, stream>>>(         \
        x, sv, gamma, out, n, m, d, rows, vec, c);                       \
    break;
    K1_CASE(1)
    K1_CASE(2)
    K1_CASE(3)
    K1_CASE(4)
    K1_CASE(5)
#undef K1_CASE
    default:
      kernel_matrix_kernel<KIND, 0><<<grid, block, 0, stream>>>(
          x, sv, gamma, out, n, m, d, rows, vec, c);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K1 on `stream`.  All tensors contiguous f32 on the device.
// Returns cudaGetLastError() after the launch (0 on success).
int k1_kernel_matrix(const float* x, const float* sv, const float* gamma,
                     float* out, int n_pairs, int n, int m, int d, int kind,
                     float gamma0, float v_scale, float nvt, void* stream) {
  using namespace repro_torch;
  if (n_pairs <= 0 || n <= 0 || m <= 0) return 0;
  if (d <= 0 || (kind != kRbf && kind != kSech2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto addr = reinterpret_cast<uintptr_t>(out);
  const int vec = (m % 4 == 0 && addr % 16 == 0) ? 4
                  : (m % 2 == 0 && addr % 8 == 0) ? 2 : 1;
  const Sech2Consts c{gamma0, v_scale, nvt};
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      kind == kRbf
          ? launch_kind<kRbf>(x, sv, gamma, out, n_pairs, n, m, d, vec, c, st)
          : launch_kind<kSech2>(x, sv, gamma, out, n_pairs, n, m, d, vec, c,
                                st);
  return static_cast<int>(err);
}

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
