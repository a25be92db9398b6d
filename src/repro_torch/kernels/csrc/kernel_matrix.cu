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
// Each block computes a 32 x 32 output tile: its 32 query rows and 32
// support vectors (and their squared norms) are staged in shared memory,
// 256 threads each write four outputs with neighbouring threads on
// neighbouring columns.  d <= 5 in the paper's hardware, so the work per
// output is a handful of FMAs plus the transcendentals: the tile is bound
// by exp / softplus throughput (sech2) or by the output write (rbf), not by
// a matrix product, and this simple kernel does no tensor-core work.
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace repro_torch {
namespace {

constexpr int kTile = 32;
constexpr int kRowsPerThread = 4;   // blockDim = (32, 8)

__global__ void kernel_matrix_kernel(const float* __restrict__ x,
                                     const float* __restrict__ sv,
                                     const float* __restrict__ gamma,
                                     float* __restrict__ out, int n, int m,
                                     int d, int kind, Sech2Consts c) {
  extern __shared__ float smem[];
  float* xs = smem;                     // kTile * d
  float* zs = xs + kTile * d;           // kTile * d
  float* xx = zs + kTile * d;           // kTile
  float* zz = xx + kTile;               // kTile

  const int p = blockIdx.z;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const float* svp = sv + static_cast<size_t>(p) * m * d;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int e = tid; e < kTile * d; e += nthreads) {
    const int r = e / d, k = e % d;
    xs[e] = (i0 + r < n) ? x[static_cast<size_t>(i0 + r) * d + k] : 0.f;
    zs[e] = (j0 + r < m) ? svp[static_cast<size_t>(j0 + r) * d + k] : 0.f;
  }
  __syncthreads();
  if (tid < kTile) {
    xx[tid] = sq_norm(xs + tid * d, d);
  } else if (tid < 2 * kTile) {
    zz[tid - kTile] = sq_norm(zs + (tid - kTile) * d, d);
  }
  __syncthreads();

  const float g = gamma[p];
  const float s = (kind == kSech2) ? sech2_scale(g, c) : 0.f;
  const int tj = threadIdx.x;
  const int j = j0 + tj;
  if (j >= m) return;
  for (int q = 0; q < kRowsPerThread; ++q) {
    const int ti = threadIdx.y + q * blockDim.y;
    const int i = i0 + ti;
    if (i >= n) break;
    out[(static_cast<size_t>(p) * n + i) * m + j] =
        tile_value(kind, xs + ti * d, zs + tj * d, xx[ti], zz[tj], d, g, s);
  }
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
  const size_t smem = sizeof(float) * (2 * kTile * d + 2 * kTile);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kTile, kTile / kRowsPerThread);
  const dim3 grid((m + kTile - 1) / kTile, (n + kTile - 1) / kTile, n_pairs);
  Sech2Consts c{gamma0, v_scale, nvt};
  kernel_matrix_kernel<<<grid, block, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, sv, gamma, out, n, m, d, kind, c);
  return static_cast<int>(cudaGetLastError());
}

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
