// K2: fused dual coordinate ascent over solver lanes, one block per lane.
//
// Replaces the Pallas TPU kernel repro/kernels/solver.py
// dual_ascent_lanes_pallas (body _solver_kernel).  Grid (L, G, P): one
// thread block per (pair p, width g, C x fold lane l).  The lane's state
// lives in shared memory for the whole epoch loop: alpha, y and the box
// c (n floats each) and, in the tile modes, the inputs x (n x d) with their
// squared norms.  Per coordinate block of 16 rows j0..j0+15 it
//
//   1. computes the block margins fb_r = sum_j alpha_j y_j K'(x_{j0+r}, x_j)
//      with K' = K + 1 recomputed from x by the tile bodies of tiles.cuh
//      (the (16, n) Gram row slab is never stored), reduced over the block;
//      the (16, 16) diagonal tile goes to shared memory on the way;
//   2. runs the 16 Gauss-Seidel updates
//        a_new = clip(a + (1 - y f) / max(K'_ii, 1e-12), 0, c)
//      in one warp, lane r keeping fb_r and adding dlt * y_i * K'_{r,i}.
//
// That is the update order of the oracle, repro/core/trainer.py
// dual_coordinate_ascent_blocked: fresh margins per block from all n
// columns, Gauss-Seidel inside the block.  A final pass writes the margins
// f = K'(alpha * y).  Rows with c = 0 (padding, held-out folds) clip to
// [0, 0], so their alpha stays exactly 0 and they add exact zeros.
//
// Gram-input mode (kind == kGram): the hardware measured-curve kernel has
// no tile body, so K' rows are read from a stored (P, G, n, n) Gram (bias
// folded in) instead of being recomputed; the update sequence is the same.
//
// What bounds it: each lane is a serial chain of n_epochs * n dependent
// coordinate updates; the margin pass between them is short and parallel.
// Lanes, not coordinates, fill the 132 SMs, so the grid carries every
// (pair, gamma, C x fold) cell of a CV grid at once.
#include <cuda_runtime.h>

#include "tiles.cuh"

namespace repro_torch {
namespace {

constexpr int kBlock = 16;     // coordinate block = ref.SOLVER_BLOCK
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct LaneSmem {
  float* alpha;  // n
  float* y;      // n
  float* c;      // n
  float* kbb;    // kBlock * kBlock  diagonal tile K'[j0+r, j0+i]
  float* red;    // kWarps * kBlock  per-warp partial margins
  float* fb;     // kBlock           block margins
  float* x;      // n * d            (tile modes)
  float* xx;     // n                (rbf)
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fb[r] = sum_j alpha_j y_j K'[j0 + r, j] for r < rows; kbb filled.
__device__ void block_margins(const LaneSmem& s, int j0, int rows, int n,
                              int d, int kind, float gamma, float scale,
                              const float* __restrict__ kp) {
  float acc[kBlock];
#pragma unroll
  for (int r = 0; r < kBlock; ++r) acc[r] = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float w = s.alpha[j] * s.y[j];
    const bool diag = (j >= j0) && (j < j0 + kBlock);
    if (w == 0.f && !diag) continue;  // exact zero contribution
#pragma unroll
    for (int r = 0; r < kBlock; ++r) {
      if (r < rows) {
        const int row = j0 + r;
        float k;
        if (kind == kGram) {
          k = kp[static_cast<size_t>(row) * n + j];
        } else {
          k = tile_value(kind, s.x + row * d, s.x + j * d,
                         kind == kRbf ? s.xx[row] : 0.f,
                         kind == kRbf ? s.xx[j] : 0.f, d, gamma, scale) +
              1.f;
        }
        acc[r] += w * k;
        if (diag) s.kbb[r * kBlock + (j - j0)] = k;
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kBlock; ++r) {
    const float v = warp_sum(acc[r]);
    if (lane == 0) s.red[warp * kBlock + r] = v;
  }
  __syncthreads();
  if (threadIdx.x < kBlock) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += s.red[w * kBlock + threadIdx.x];
    s.fb[threadIdx.x] = t;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
solver_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ c_box,
              const float* __restrict__ gamma,
              const float* __restrict__ gram, float* __restrict__ alpha_out,
              float* __restrict__ f_out, int n_gamma, int n_lanes, int n,
              int d, int kind, int n_epochs, Sech2Consts consts) {
  extern __shared__ float smem[];
  const int l = blockIdx.x, g = blockIdx.y, p = blockIdx.z;
  const bool tiles = (kind != kGram);
  LaneSmem s;
  s.alpha = smem;
  s.y = s.alpha + n;
  s.c = s.y + n;
  s.kbb = s.c + n;
  s.red = s.kbb + kBlock * kBlock;
  s.fb = s.red + kWarps * kBlock;
  s.x = s.fb + kBlock;
  s.xx = s.x + (tiles ? n * d : 0);

  const float* yp = y + static_cast<size_t>(p) * n;
  const float* cp = c_box + (static_cast<size_t>(p) * n_lanes + l) * n;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    s.alpha[j] = 0.f;
    s.y[j] = yp[j];
    s.c[j] = cp[j];
  }
  if (tiles) {
    const float* xp = x + static_cast<size_t>(p) * n * d;
    for (int e = threadIdx.x; e < n * d; e += kThreads) s.x[e] = xp[e];
  }
  for (int e = threadIdx.x; e < kBlock * kBlock; e += kThreads) s.kbb[e] = 0.f;
  __syncthreads();
  if (kind == kRbf) {
    for (int j = threadIdx.x; j < n; j += kThreads)
      s.xx[j] = sq_norm(s.x + j * d, d);
  }
  const float gm = tiles ? gamma[static_cast<size_t>(p) * n_gamma + g] : 0.f;
  const float scale = (kind == kSech2) ? sech2_scale(gm, consts) : 0.f;
  const float* kp =
      tiles ? nullptr
            : gram + (static_cast<size_t>(p) * n_gamma + g) * n * n;
  __syncthreads();

  const int n_blocks = (n + kBlock - 1) / kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int epoch = 0; epoch < n_epochs; ++epoch) {
    for (int b = 0; b < n_blocks; ++b) {
      const int j0 = b * kBlock;
      const int rows = min(kBlock, n - j0);
      block_margins(s, j0, rows, n, d, kind, gm, scale, kp);
      if (warp == 0) {
        float fb = lane < rows ? s.fb[lane] : 0.f;
        for (int i = 0; i < rows; ++i) {
          const int j = j0 + i;
          const float fi = __shfl_sync(0xffffffffu, fb, i);
          const float a = s.alpha[j], yi = s.y[j];
          const float q = fmaxf(s.kbb[i * kBlock + i], 1e-12f);
          const float a_new = fminf(fmaxf(a + (1.f - yi * fi) / q, 0.f),
                                    s.c[j]);
          const float dy = (a_new - a) * yi;
          if (lane < rows) fb = fb + dy * s.kbb[lane * kBlock + i];
          __syncwarp();
          if (lane == 0) s.alpha[j] = a_new;
          __syncwarp();
        }
      }
      __syncthreads();
    }
  }

  // Final margins f = K' (alpha * y), one more pass over the row blocks.
  const size_t out_off =
      ((static_cast<size_t>(p) * n_gamma + g) * n_lanes + l) * n;
  for (int b = 0; b < n_blocks; ++b) {
    const int j0 = b * kBlock;
    const int rows = min(kBlock, n - j0);
    block_margins(s, j0, rows, n, d, kind, gm, scale, kp);
    if (threadIdx.x < rows) f_out[out_off + j0 + threadIdx.x] = s.fb[threadIdx.x];
  }
  for (int j = threadIdx.x; j < n; j += kThreads) alpha_out[out_off + j] = s.alpha[j];
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K2 on `stream`.  Contiguous f32 device tensors:
//   x (P, n, d), y (P, n), c_box (P, L, n), gamma (P, G)   [tile modes]
//   gram (P, G, n, n) with the bias folded in              [kind == 3]
//   alpha_out, f_out (P, G, L, n).
// Returns cudaGetLastError() after the launch (0 on success).
int k2_solve_lanes(const float* x, const float* y, const float* c_box,
                   const float* gamma, const float* gram, float* alpha_out,
                   float* f_out, int n_pairs, int n_gamma, int n_lanes, int n,
                   int d, int kind, int n_epochs, float gamma0, float v_scale,
                   float nvt, void* stream) {
  using namespace repro_torch;
  if (n_pairs <= 0 || n_gamma <= 0 || n_lanes <= 0 || n <= 0) return 0;
  if (kind < kLinear || kind > kGram || (kind != kGram && d <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t tile_floats = (kind == kGram) ? 0 : static_cast<size_t>(n) * (d + 1);
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(n) + kBlock * kBlock +
                                       kWarps * kBlock + kBlock + tile_floats);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        solver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(n_lanes, n_gamma, n_pairs);
  Sech2Consts c{gamma0, v_scale, nvt};
  solver_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, c_box, gamma, gram, alpha_out, f_out, n_gamma, n_lanes, n, d, kind,
      n_epochs, c);
  return static_cast<int>(cudaGetLastError());
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
