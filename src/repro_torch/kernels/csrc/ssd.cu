// K4: the chunked Mamba2 SSD (state-space duality) scan with carried state.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd.py ssd_scan_pallas
// (body _ssd_kernel).  Per chunk of L steps, with cum = cumsum(a):
//
//   G     = C B^T                                         (L, L)
//   decay = exp(min(cum_t - cum_j, 0)) for j <= t, else 0 (selected)
//   y     = (G * decay) x + (C * exp(cum)) S_prev^T
//   S     = exp(cum_L) S_prev + x^T (B * exp(cum_L - cum))
//
// and the last chunk's state is emitted (the prefill -> decode handoff).
//
// Unlike the Pallas kernel, which takes (batch * heads, s, ...) inputs with
// B and C already repeated to every head, this kernel reads the model's
// layout directly: x (b, s, nh, dh), a (b, s, nh), B and C (b, s, g, ds),
// head h reading group h / (nh / g), as repro/kernels/ref.py ssd groups
// them; y is written as (b, s, nh, dh) and the final state as
// (b, nh, dh, ds).  That spares the transposes and the repeat around the
// call.  Everything is IEEE f32; s must be a multiple of the chunk (the model pads
// with zeros upstream: a = 0 decays by 1 and x = 0 adds nothing, so the
// final state is unchanged).
//
// Design: the Pallas grid (bh, chunk) runs its chunk axis in order on one
// core.  Here one block of 256 threads per (batch, head) loops over the
// chunks in order, with the (dh, ds) state in shared memory.  Per chunk,
// x, B, C, cum and the (L, L) matrix G * decay are staged in shared memory
// (about 120 KB at L = 128, dh = 64, ds = 16: above the 48 KB default, so
// the launch raises the limit).  The upper triangle is selected to 0, never
// multiplied: exp(cum_t - cum_j) above the diagonal can overflow to inf.
// Thread (ty, tx) of a 16 x 16 layout owns L/16 consecutive rows and dims
// tx + 16c of y; its j loop stops at its last row (causal half).
//
// What bounds it on this card: ~1.8 MFLOP of f32 work per (chunk, head)
// (the causal half of the two L x L products, the inter-chunk output and
// the state update) against ~0.1 MB of traffic, so the operations over the
// f32 peak bound it.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kMaxRows = kMaxChunk / 16;   // rows of y per thread

size_t smem_floats(int chunk, int dh, int ds) {
  return static_cast<size_t>(chunk) * dh      // x
         + 2 * chunk * (ds + 1)                // B, C
         + chunk * (chunk + 1)                 // G * decay
         + dh * (ds + 1)                       // state
         + 3 * chunk;                          // cum, exp(cum), exp(L - cum)
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ a,
           const float* __restrict__ bm, const float* __restrict__ cm,
           float* __restrict__ y,
           float* __restrict__ sfin, int s, int nh, int g, int ds,
           int chunk) {
  constexpr int kDims = DH / 16;
  const int ldb = ds + 1, ldm = chunk + 1;
  extern __shared__ float smem[];
  float* xs = smem;                       // chunk x DH
  float* bs = xs + chunk * DH;            // chunk x ldb
  float* cs = bs + chunk * ldb;           // chunk x ldb
  float* mat = cs + chunk * ldb;          // chunk x ldm: G * decay
  float* st = mat + chunk * ldm;          // DH x ldb: the carried state
  float* cum = st + DH * ldb;             // chunk
  float* ecum = cum + chunk;              // exp(cum)
  float* w = ecum + chunk;                // exp(cum_L - cum)

  const int bi = blockIdx.x / nh, h = blockIdx.x % nh;
  const int gi = h / (nh / g);
  const int tid = threadIdx.x, lane = tid & 31;
  const int tx = tid & 15, ty = tid >> 4;
  const int rows = chunk / 16;            // <= kMaxRows
  const size_t head_state = static_cast<size_t>(blockIdx.x) * DH * ds;

  for (int e = tid; e < DH * ds; e += kThreads) {
    st[(e / ds) * ldb + e % ds] = 0.f;
  }

  for (int c0 = 0; c0 < s; c0 += chunk) {
    __syncthreads();   // the previous chunk's reads are done
    const size_t row0 = static_cast<size_t>(bi) * s + c0;
    for (int e = tid; e < chunk * DH; e += kThreads) {
      const int t = e / DH, d = e % DH;
      xs[e] = x[((row0 + t) * nh + h) * DH + d];
    }
    for (int e = tid; e < chunk * ds; e += kThreads) {
      const int t = e / ds, k = e % ds;
      const size_t src = ((row0 + t) * g + gi) * ds + k;
      bs[t * ldb + k] = bm[src];
      cs[t * ldb + k] = cm[src];
    }
    for (int t = tid; t < chunk; t += kThreads) {
      cum[t] = a[(row0 + t) * nh + h];
    }
    __syncthreads();

    // Inclusive cumsum of a in one warp: each lane sums chunk/32 consecutive
    // steps, then a shuffle scan over the lanes' totals.
    if (tid < 32) {
      const int per = chunk / 32;
      float loc[kMaxChunk / 32];
      float run = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i) {
        if (i < per) run += cum[lane * per + i];
        loc[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - run;
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i) loc[i] += excl;
      // loc[i] for i >= per repeats the lane's last value.
      const float total =
          __shfl_sync(0xffffffffu, loc[kMaxChunk / 32 - 1], 31);
#pragma unroll
      for (int i = 0; i < kMaxChunk / 32; ++i) {
        if (i < per) {
          const int t = lane * per + i;
          cum[t] = loc[i];
          ecum[t] = expf(loc[i]);
          w[t] = expf(total - loc[i]);
        }
      }
    }
    __syncthreads();

    // G * decay, the upper triangle selected to zero.
    for (int e = tid; e < chunk * chunk; e += kThreads) {
      const int t = e / chunk, j = e % chunk;
      float v = 0.f;
      if (j <= t) {
        float gtj = 0.f;
        for (int k = 0; k < ds; ++k)
          gtj = fmaf(cs[t * ldb + k], bs[j * ldb + k], gtj);
        v = gtj * expf(fminf(cum[t] - cum[j], 0.f));
      }
      mat[t * ldm + j] = v;
    }
    __syncthreads();

    // y = (G * decay) x + (C * exp(cum)) S_prev^T for this thread's rows.
    {
      float acc[kMaxRows][kDims];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
#pragma unroll
        for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;
      const int t0 = ty * rows;
      for (int j = 0; j < t0 + rows; ++j) {
        float xv[kDims];
#pragma unroll
        for (int c = 0; c < kDims; ++c) xv[c] = xs[j * DH + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            const float mv = mat[(t0 + r) * ldm + j];
#pragma unroll
            for (int c = 0; c < kDims; ++c) acc[r][c] = fmaf(mv, xv[c], acc[r][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const int t = t0 + r;
          float inter[kDims];
#pragma unroll
          for (int c = 0; c < kDims; ++c) inter[c] = 0.f;
          for (int k = 0; k < ds; ++k) {
            const float ck = cs[t * ldb + k] * ecum[t];
#pragma unroll
            for (int c = 0; c < kDims; ++c)
              inter[c] = fmaf(ck, st[(tx + 16 * c) * ldb + k], inter[c]);
          }
          float* yp = y + ((row0 + t) * nh + h) * DH;
#pragma unroll
          for (int c = 0; c < kDims; ++c) yp[tx + 16 * c] = acc[r][c] + inter[c];
        }
      }
    }
    __syncthreads();   // every read of S_prev is done

    // S = exp(cum_L) S_prev + x^T (B * exp(cum_L - cum)).
    const float decay_all = expf(cum[chunk - 1]);
    for (int e = tid; e < DH * ds; e += kThreads) {
      const int d = e / ds, k = e % ds;
      float sum = 0.f;
      for (int t = 0; t < chunk; ++t)
        sum = fmaf(xs[t * DH + d], bs[t * ldb + k] * w[t], sum);
      st[d * ldb + k] = decay_all * st[d * ldb + k] + sum;
    }
  }
  __syncthreads();
  for (int e = tid; e < DH * ds; e += kThreads) {
    sfin[head_state + e] = st[(e / ds) * ldb + e % ds];
  }
}

template <int DH>
int launch(const float* x, const float* a, const float* bm, const float* cm,
           float* y, float* sfin, int b, int s, int nh,
           int g, int ds, int chunk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(chunk, DH, ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_kernel<DH><<<b * nh, kThreads, smem, stream>>>(
      x, a, bm, cm, y, sfin, s, nh, g, ds, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K4 on `stream`.  x (b, s, nh, dh), a (b, s, nh), bm and cm
// (b, s, g, ds), y like x and sfin (b, nh, dh, ds): all contiguous f32 on the device.  dh in {16, 64}, 1 <= ds <= 64
// (as far as the shared memory allows), nh % g == 0, chunk a multiple of 32 up to 128 dividing s.  Returns
// cudaGetLastError() after the launch (0 on success).
int k4_ssd_scan(const float* x, const float* a, const float* bm,
                const float* cm, float* y, float* sfin,
                int b, int s, int nh, int g, int dh, int ds, int chunk,
                void* stream) {
  using namespace repro_torch;
  if (b <= 0 || nh <= 0) return 0;
  if (g <= 0 || nh % g != 0 || ds <= 0 || ds > 64 || chunk <= 0 ||
      chunk % 32 != 0 || chunk > kMaxChunk || s <= 0 || s % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 16:
      return launch<16>(x, a, bm, cm, y, sfin, b, s, nh, g, ds, chunk, st);
    case 64:
      return launch<64>(x, a, bm, cm, y, sfin, b, s, nh, g, ds, chunk, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
