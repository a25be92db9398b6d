// K2: fused dual coordinate ascent over solver lanes.
//
// Replaces the Pallas TPU kernel repro/kernels/solver.py
// dual_ascent_lanes_pallas (body _solver_kernel).  A lane is one (pair p,
// width g, C x fold l) cell of the (P, G, L) grid.  Per coordinate block of
// 16 rows j0..j0+15 a lane
//
//   1. computes the block margins fb_r = sum_j alpha_j y_j K'(x_{j0+r}, x_j)
//      from all n columns, with K' = K + 1;
//   2. runs the 16 Gauss-Seidel updates
//        a_new = clip(a + (1 - y f) / max(K'_ii, 1e-12), 0, c)
//      against the (16, 16) diagonal tile, fb_r += dy * K'_{r,i}.
//
// That is the update order of the oracle, repro/core/trainer.py
// dual_coordinate_ascent_blocked.  A final pass writes the margins
// f = K'(alpha * y).  Rows with c = 0 (padding, held-out folds) clip to
// [0, 0], so their alpha stays exactly 0 and they add exact zeros.
//
// Gram-input mode (KIND == kGram): the hardware measured-curve kernel has no
// tile body, so K' rows are read from a stored (P, G, n, n) Gram (bias
// folded in) instead of being recomputed; the update sequence is the same.
//
// What bounds it: each lane is a serial chain of n_epochs * n dependent
// coordinate updates with a parallel margin pass per block; the lanes, not
// the coordinates, fill the 132 SMs.
//
// Design.  One warp per lane, and the lanes of one (p, g) share a CTA: they
// visit the same coordinate blocks in the same order, so each (16, n) slab
// of K' is computed once per step into shared memory (from x, or read once
// from the stored Gram) and every lane's warp reads it.  The host splits a
// (p, g) cell's L lanes into equal groups so that the CTAs of the whole grid
// fill the SMs once (balance's rbf CV grid: 21 cells x 6 CTAs of 5-6
// lanes); all lanes are resident at once.  A CTA has 32 warps: the warps
// without a lane fill the next slab while the lane warps run this step
// (filled by 8 warps, the slab's latency doubled the step time on the
// card).  A filling thread owns a column and a group of rows: the column's
// inputs sit in registers, the rows' are broadcast reads.  Inside a step a
// lane warp needs no barrier but its own: lane t sums row t % 16 over every
// other group of 4 columns (float4 reads, a 4-float row pad keeps them
// conflict-free), one shuffle joins the two halves, and the 16 serial
// updates run with shuffles, each lane holding its row's fb, alpha, y, c
// and diagonal tile row in registers.  Slabs are double-buffered and
// column-chunked (512 columns): one __syncthreads per chunk hands a slab
// over.  x is kept once per CTA, transposed (d, n) so a warp's column reads
// hit distinct banks; alpha y lives in shared memory per lane, c is read
// from global memory.
#include <cuda_runtime.h>

#include <algorithm>

#include "tiles.cuh"

namespace repro_torch {
namespace {

constexpr int kBlock = 16;       // coordinate block = ref.SOLVER_BLOCK
constexpr int kMaxChunk = 512;   // slab columns per chunk
constexpr int kMaxLanesPerCta = 32;
constexpr int kCtaThreads = 1024;  // warps without a lane compute slabs
constexpr int kMinFillWarps = 8;   // else every warp helps fill them
constexpr int kDimGroup = 8;       // input dimensions held in registers
constexpr unsigned kFull = 0xffffffffu;

// K' for rows j0 + r0 .. j0 + r0 + rows - 1 of column `col` into the slab
// column `dst` (stride ld): the column's inputs are read once, in groups of
// kDimGroup, and each row's are broadcast reads of x transposed in shared
// memory (xt[k * n_pad + j]).  The arithmetic is that of tiles.cuh, in the
// same order over the d inputs.
template <int KIND>
__device__ __forceinline__ void fill_column(
    float* __restrict__ dst, int ld, const float* __restrict__ xt,
    const float* __restrict__ xx, const float* __restrict__ kp, int n,
    int n_pad, int d, int row0, int rows, int col, float gamma, float s) {
  float acc[kBlock];
#pragma unroll
  for (int rr = 0; rr < kBlock; ++rr) acc[rr] = 0.f;
  if constexpr (KIND == kGram) {
#pragma unroll
    for (int rr = 0; rr < kBlock; ++rr)
      if (rr < rows && row0 + rr < n && col < n)
        acc[rr] = kp[static_cast<size_t>(row0 + rr) * n + col];
  } else {
    for (int k0 = 0; k0 < d; k0 += kDimGroup) {
      float xc[kDimGroup];
#pragma unroll
      for (int u = 0; u < kDimGroup; ++u)
        xc[u] = k0 + u < d ? xt[(k0 + u) * n_pad + col] : 0.f;
#pragma unroll
      for (int rr = 0; rr < kBlock; ++rr) {
        if (rr >= rows) break;
#pragma unroll
        for (int u = 0; u < kDimGroup; ++u) {
          if (k0 + u < d) {
            const float xr = xt[(k0 + u) * n_pad + row0 + rr];
            if constexpr (KIND == kSech2) {
              const float log4 = 1.38629436111989061883f;
              const float dv = (xr - xc[u]) * s;
              acc[rr] += log4 - softplus(-dv) - softplus(dv);
            } else {
              acc[rr] = fmaf(xr, xc[u], acc[rr]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kBlock; ++rr) {
    if (rr >= rows) break;
    float v = 0.f;
    if (row0 + rr < n && col < n) {
      if constexpr (KIND == kRbf) {
        const float d2 = fmaxf(xx[row0 + rr] + xx[col] - 2.f * acc[rr], 0.f);
        v = expf(-gamma * d2) + 1.f;
      } else if constexpr (KIND == kSech2) {
        v = expf(acc[rr]) + 1.f;
      } else if constexpr (KIND == kGram) {
        v = acc[rr];   // the stored K', bias folded in
      } else {
        v = acc[rr] + 1.f;
      }
    }
    dst[rr * ld] = v;
  }
}

template <int KIND>
__global__ void __launch_bounds__(kMaxLanesPerCta * 32)
solver_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ c_box,
              const float* __restrict__ gamma,
              const float* __restrict__ gram, float* __restrict__ alpha_out,
              float* __restrict__ f_out, int n_gamma, int n_lanes,
              int lanes_per_cta, int n, int n_pad, int d, int chunk,
              int n_epochs, Sech2Consts consts) {
  constexpr bool kTiles = KIND != kGram;
  const int ld_slab = chunk + 4;
  extern __shared__ __align__(16) float smem[];
  float* slab = smem;                              // 2 x kBlock x ld_slab
  float* y_s = slab + 2 * kBlock * ld_slab;        // n_pad
  float* w_s = y_s + n_pad;                        // lanes_per_cta x n_pad
  float* xt = w_s + lanes_per_cta * n_pad;         // d x n_pad   (tiles)
  float* xx = xt + (kTiles ? d * n_pad : 0);       // n_pad       (rbf)

  const int g = blockIdx.y, p = blockIdx.z;
  const int lane0 = blockIdx.x * lanes_per_cta;
  const int lanes_here = min(lanes_per_cta, n_lanes - lane0);
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, t = tid & 31;
  const int r = t & (kBlock - 1), half = t >> 4;
  const bool active = warp < lanes_here;
  const int l = lane0 + warp;

  const float* yp = y + static_cast<size_t>(p) * n;
  for (int j = tid; j < n_pad; j += nthreads) y_s[j] = j < n ? yp[j] : 0.f;
  for (int e = tid; e < lanes_per_cta * n_pad; e += nthreads) w_s[e] = 0.f;
  if (kTiles) {
    const float* xp = x + static_cast<size_t>(p) * n * d;
    for (int e = tid; e < d * n_pad; e += nthreads) {
      const int k = e / n_pad, j = e - k * n_pad;
      xt[e] = j < n ? xp[static_cast<size_t>(j) * d + k] : 0.f;
    }
  }
  __syncthreads();
  if (KIND == kRbf) {
    for (int j = tid; j < n_pad; j += nthreads) {
      float acc = 0.f;
      for (int k = 0; k < d; ++k) acc = fmaf(xt[k * n_pad + j], xt[k * n_pad + j], acc);
      xx[j] = acc;
    }
  }
  const float gm = kTiles ? gamma[static_cast<size_t>(p) * n_gamma + g] : 0.f;
  const float scale = (KIND == kSech2) ? sech2_scale(gm, consts) : 0.f;
  const float* kp =
      kTiles ? nullptr : gram + (static_cast<size_t>(p) * n_gamma + g) * n * n;
  const float* cp = c_box + (static_cast<size_t>(p) * n_lanes + l) * n;
  __syncthreads();

  const int n_blocks = n_pad / kBlock;
  const int n_chunks = (n_pad + chunk - 1) / chunk;
  const int per_pass = n_blocks * n_chunks;
  const int n_items = (n_epochs + 1) * per_pass;   // + the final margins

  // Slab of item `it` (block b, chunk c): K'[j0 + r, c * chunk + jj],
  // filled by threads `worker` of `workers`.
  auto fill_slab = [&](int it, int worker, int workers) {
    const int b = (it / n_chunks) % n_blocks, c = it % n_chunks;
    const int j0 = b * kBlock, c0 = c * chunk;
    const int cols = min(chunk, n_pad - c0);
    float* dst = slab + (it & 1) * kBlock * ld_slab;
    // Workers take (column, group of rows): as many row groups as fit.
    int groups = kBlock;
    while (groups > 1 && groups * cols > workers) groups >>= 1;
    const int rows = kBlock / groups;
    for (int wk = worker; wk < groups * cols; wk += workers) {
      const int rg = wk / cols, jj = wk - rg * cols;
      fill_column<KIND>(dst + rg * rows * ld_slab + jj, ld_slab, xt, xx, kp,
                        n, n_pad, d, j0 + rg * rows, rows, c0 + jj, gm,
                        scale);
    }
  };

  fill_slab(0, tid, nthreads);
  __syncthreads();
  // From here on the warps without a lane fill the next slab while the lane
  // warps run this step's margins and updates, if there are enough of them.
  const bool helpers_fill = (nthreads >> 5) - lanes_here >= kMinFillWarps;
  const int fill_worker = helpers_fill ? tid - 32 * lanes_here : tid;
  const int fill_workers = helpers_fill ? nthreads - 32 * lanes_here : nthreads;

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float kr[kBlock];   // this lane's row of the diagonal tile
#pragma unroll
  for (int i = 0; i < kBlock; ++i) kr[i] = 0.f;
  float q_r = 1.f;
  // The lane's alpha_j y_j: y is +-1 on every row (0 past n), so
  // alpha_j = w_j y_j exactly and the margins read one array, not two.
  float* wl = w_s + warp * n_pad;
  const size_t out_off =
      ((static_cast<size_t>(p) * n_gamma + g) * n_lanes + l) * n;

  for (int it = 0; it < n_items; ++it) {
    if (active) {
      const int b = (it / n_chunks) % n_blocks, c = it % n_chunks;
      const int j0 = b * kBlock, c0 = c * chunk;
      const int cols = min(chunk, n_pad - c0);
      const int rows = min(kBlock, n - j0);
      const bool update = c == n_chunks - 1 && it < n_epochs * per_pass;
      // Issued first, so the load's latency hides behind the margins.
      const float c_r = update && r < rows ? __ldg(cp + j0 + r) : 0.f;
      const float* src = slab + (it & 1) * kBlock * ld_slab + r * ld_slab;
      if (c == 0) acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int k = 4 * half; k < cols; k += 8) {
        const float4 s4 = *reinterpret_cast<const float4*>(src + k);
        const float4 w4 = *reinterpret_cast<const float4*>(wl + c0 + k);
        acc.x = fmaf(w4.x, s4.x, acc.x);
        acc.y = fmaf(w4.y, s4.y, acc.y);
        acc.z = fmaf(w4.z, s4.z, acc.z);
        acc.w = fmaf(w4.w, s4.w, acc.w);
      }
      if (j0 >= c0 && j0 < c0 + cols) {   // the chunk holding the diagonal
#pragma unroll
        for (int i = 0; i < kBlock; ++i) kr[i] = src[j0 - c0 + i];
        q_r = fmaxf(src[j0 - c0 + r], 1e-12f);
      }
      if (c == n_chunks - 1) {
        float fb = (acc.x + acc.y) + (acc.z + acc.w);
        fb += __shfl_xor_sync(kFull, fb, 16);
        if (update) {
          const bool in = r < rows;
          const float y_r = in ? y_s[j0 + r] : 0.f;
          float a_r = in ? wl[j0 + r] * y_r : 0.f;
#pragma unroll
          for (int i = 0; i < kBlock; ++i) {
            if (i < rows) {
              const float fi = __shfl_sync(kFull, fb, i);
              const float ai = __shfl_sync(kFull, a_r, i);
              const float yi = __shfl_sync(kFull, y_r, i);
              const float ci = __shfl_sync(kFull, c_r, i);
              const float qi = __shfl_sync(kFull, q_r, i);
              const float a_new = fminf(fmaxf(ai + (1.f - yi * fi) / qi, 0.f), ci);
              const float dy = (a_new - ai) * yi;
              fb = fb + dy * kr[i];
              if (r == i) a_r = a_new;
            }
          }
          if (in && half == 0) wl[j0 + r] = a_r * y_r;
        } else if (r < rows && half == 0) {
          f_out[out_off + j0 + r] = fb;
        }
      }
    }
    if (it + 1 < n_items && (!helpers_fill || !active)) {
      fill_slab(it + 1, fill_worker, fill_workers);
    }
    __syncthreads();   // slab it + 1 is full; slab it may be overwritten
  }
  if (active) {
    for (int j = t; j < n; j += 32) alpha_out[out_off + j] = wl[j] * y_s[j];
  }
}

int sm_count() {
  static int count = [] {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
  }();
  return count;
}

template <int KIND>
int launch(const float* x, const float* y, const float* c_box,
           const float* gamma, const float* gram, float* alpha_out,
           float* f_out, int n_pairs, int n_gamma, int n_lanes, int n, int d,
           int n_epochs, Sech2Consts consts, cudaStream_t stream) {
  const int n_pad = (n + kBlock - 1) / kBlock * kBlock;
  const int chunk = min(n_pad, kMaxChunk);
  const bool tiles = KIND != kGram;
  const size_t fixed_floats = 2 * kBlock * static_cast<size_t>(chunk + 4) +
                              n_pad + (tiles ? static_cast<size_t>(d + 1) * n_pad : 0);
  int max_smem = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long room = max_smem / 4 - static_cast<long long>(fixed_floats);
  const int lanes_fit = static_cast<int>(
      std::min<long long>(room / n_pad, kMaxLanesPerCta));
  if (lanes_fit < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Split each (p, g) cell's lanes into equal CTAs that fill the SMs once.
  const int cells = n_pairs * n_gamma;
  const int ctas_per_cell = std::max(1, std::min(n_lanes, sm_count() / cells));
  int per_cta = std::min((n_lanes + ctas_per_cell - 1) / ctas_per_cell, lanes_fit);
  const int groups = (n_lanes + per_cta - 1) / per_cta;
  per_cta = (n_lanes + groups - 1) / groups;
  const size_t smem = sizeof(float) * (fixed_floats + static_cast<size_t>(per_cta) * n_pad);
  cudaError_t err = cudaFuncSetAttribute(
      solver_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(groups, n_gamma, n_pairs);
  solver_kernel<KIND><<<grid, kCtaThreads, smem, stream>>>(
      x, y, c_box, gamma, gram, alpha_out, f_out, n_gamma, n_lanes, per_cta,
      n, n_pad, d, chunk, n_epochs, consts);
  return static_cast<int>(cudaGetLastError());
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
  if (kind != kGram && d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Sech2Consts c{gamma0, v_scale, nvt};
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kLinear:
      return launch<kLinear>(x, y, c_box, gamma, gram, alpha_out, f_out,
                             n_pairs, n_gamma, n_lanes, n, d, n_epochs, c, s);
    case kRbf:
      return launch<kRbf>(x, y, c_box, gamma, gram, alpha_out, f_out, n_pairs,
                          n_gamma, n_lanes, n, d, n_epochs, c, s);
    case kSech2:
      return launch<kSech2>(x, y, c_box, gamma, gram, alpha_out, f_out,
                            n_pairs, n_gamma, n_lanes, n, d, n_epochs, c, s);
    case kGram:
      return launch<kGram>(x, y, c_box, gamma, gram, alpha_out, f_out,
                           n_pairs, n_gamma, n_lanes, n, 0, n_epochs, c, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
