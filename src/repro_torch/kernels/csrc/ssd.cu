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
// (b, nh, dh, ds).  Everything is IEEE f32; s must be a multiple of the
// chunk (the model pads with zeros upstream: a = 0 decays by 1 and x = 0
// adds nothing, so the final state is unchanged).
//
// What bounds it on this card: ~1.8 MFLOP of f32 work per (chunk, head)
// (the causal half of the two L x L products, the inter-chunk output and
// the state update) against ~0.1 MB of traffic, so the operations over the
// f32 peak bound it: 0.0885 ms at hymba-1.5b's prefill shape (b, s, nh, dh,
// ds) = (4, 2048, 50, 64, 16), chunk 128, against the H100 SXM's published
// 67 TFLOP/s at its full 700 W (chip_smoke.py, ssd_ops).
//
// Design: only the (dh, ds) state recurrence is sequential across chunks,
// so the scan runs as three launches on one stream, the first and last
// over every (batch, chunk, head) tile at once (3,200 CTAs at the prefill
// shape, against 200 when one CTA walked a head's chunks in order):
//
//   1. ssd_chunk_state_kernel, one CTA per (batch, chunk, head): the
//      chunk's inclusive cumsum of a (every warp scans 32 steps, then the
//      warp totals are added, in f64), written to `cum`, and the chunk's
//      own state dS = x^T (B * exp(cum_L - cum)), written to `states`.
//   2. ssd_state_pass_kernel, one thread per (batch, head, d, k): S_0 = 0,
//      S_{c+1} = exp(cum_L of c) S_c + dS_c, the Pallas kernel's s_new in
//      the same order; S_c (the state before chunk c) replaces dS_c in
//      `states`, and the last S is the final state.  Each thread loads 8
//      chunks' dS and totals before it walks them, so the loads overlap.
//   3. ssd_chunk_scan_kernel, one CTA per (batch, chunk, head): y from
//      (C * exp(cum)) S_prev^T and (G * decay) x.  x arrives by cp.async
//      while G * decay of the first 64-row strip is built; G * decay is
//      staged transposed one strip of 64 rows at a time (~89 KB of shared
//      memory in all at dh 64, ds 16, so two CTAs, 16 warps, share an SM),
//      and each thread owns a 4-row x 4-dim tile of y (dh 64; 1 x 4 at dh
//      16): per step j one float4 of x and one of (G * decay)^T for 16
//      FMAs, a warp's loop ending at its last row (the causal half), y
//      stored as float4.  The upper triangle is selected to 0, never
//      multiplied: exp(cum_t - cum_j) above the diagonal can overflow.
//
// B and C are staged padded with zeros to DS (8, 16, 32, 64 or 128), so
// every ds up to 128 runs on a kernel with its state width fixed at compile
// time.  At DS 128 (mamba2-2.7b's ssm_state) two things change:
//   * pass 3's B, C^T and S_prev^T alone take 2 x 64 + 32 KB of shared
//     memory at dh 64, and x (32 KB) with the strip (34 KB) would pass the
//     227 KB a CTA may have; so x is not staged there but read as float4
//     through L1 (the 8 warps read the same 256 B rows, so all but the
//     first read of a row hit), leaving ~195 KB and one CTA per SM;
//   * the row of C a thread keeps in registers while it builds G is taken
//     in k-tiles of 64 (kCTile), G's partial sums parked in the strip, so
//     the registers stay those of DS 64.
//   Pass 1 keeps its plan: kK = dh * DS / 256 = 32 accumulators at (64,
//   128), x and B * exp(cum_L - cum) staged in ~97 KB.
#include <cuda_runtime.h>

#include <type_traits>

#include "budget.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kStrip = 64;            // rows of (G * decay)^T staged at once
constexpr int kStripLd = kStrip + 4;  // its row stride (16-byte aligned)
constexpr int kPassBatch = 8;         // chunks of dS the state pass loads
                                      // at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The (batch, chunk, head) tile of a CTA of passes 1 and 3: heads vary
// fastest, so neighbouring CTAs read neighbouring 256-byte rows of x and
// the same rows of B and C.
struct Tile {
  int h, gi, c;
  size_t row0;   // first (batch, step) row of the chunk
  size_t bh;     // batch * nh + head
};

__device__ __forceinline__ Tile tile_of(int s, int nh, int g, int chunk) {
  const int nc = s / chunk;
  Tile t;
  t.h = blockIdx.x % nh;
  const int bc = blockIdx.x / nh;
  t.c = bc % nc;
  const int bi = bc / nc;
  t.gi = t.h / (nh / g);
  t.row0 = static_cast<size_t>(bi) * s + static_cast<size_t>(t.c) * chunk;
  t.bh = static_cast<size_t>(bi) * nh + t.h;
  return t;
}

// The chunk's x rows of head h (chunk x DH) into xs, 16 bytes per cp.async.
template <int DH>
__device__ __forceinline__ void load_x_async(float* xs, const float* x,
                                             const Tile& tl, int nh,
                                             int chunk) {
  constexpr int kVec = DH / 4;
  for (int e = threadIdx.x; e < chunk * kVec; e += kThreads) {
    const int t = e / kVec, v = e % kVec;
    cp_async16(xs + t * DH + 4 * v,
               x + ((tl.row0 + t) * nh + tl.h) * DH + 4 * v);
  }
}

// Rows of B (or C) of the chunk, zero-padded from ds to DS: element (t, k)
// goes to dst[t * t_stride + k * k_stride].
template <int DS>
__device__ __forceinline__ void load_bc(float* dst, const float* src,
                                        const Tile& tl, int g, int ds,
                                        int chunk, int t_stride,
                                        int k_stride) {
  for (int e = threadIdx.x; e < chunk * DS; e += kThreads) {
    const int t = e / DS, k = e % DS;
    dst[t * t_stride + k * k_stride] =
        k < ds ? src[((tl.row0 + t) * g + tl.gi) * ds + k] : 0.f;
  }
}

// Inclusive cumsum of the chunk's a (chunk <= 128, a multiple of 32) by
// all the warps that hold steps: a shuffle scan over 32 steps per warp,
// then the totals of the warps before.  Ends with cum complete (synced).
// The sums are taken in f64 and rounded once to f32: with a strong decay
// cum reaches -10^2..-10^3 within a chunk, and exp(cum_t - cum_j) turns
// each ulp of cum into a relative error of y.  A tree of f32 sums put y 1.7x
// farther from an f64 scan than the plain version's cumsum does at mamba2's
// ds 128 (measured on an H100); 128 f64 adds per tile cost nothing here.
__device__ __forceinline__ void chunk_cumsum(float* cum, double* wsum,
                                             const float* a, const Tile& tl,
                                             int nh, int chunk) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double v = t < chunk ? a[(tl.row0 + t) * nh + tl.h] : 0.0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31 && t < chunk) wsum[warp] = v;
  __syncthreads();
  if (t < chunk) {
    for (int w = 0; w < warp; ++w) v += wsum[w];
    cum[t] = static_cast<float>(v);
  }
  __syncthreads();
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 f = *reinterpret_cast<const float4*>(p + q);
      v[q] = f.x; v[q + 1] = f.y; v[q + 2] = f.z; v[q + 3] = f.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const float2 f = *reinterpret_cast<const float2*>(p + q);
      v[q] = f.x; v[q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

// Pass 1.  dS[d][k] = sum_t x[t][d] * B[t][k] exp(cum_L - cum_t); thread
// (d, k-group) owns kK consecutive k of one d.
template <int DH, int DS>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const float* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ bm,
                       float* __restrict__ cum_out,
                       float* __restrict__ states, int s, int nh, int g,
                       int ds, int chunk) {
  constexpr int kK = DH * DS / kThreads > 0 ? DH * DS / kThreads : 1;
  constexpr int kCols = DS / kK;   // threads per d
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // chunk x DH
  float* wb = xs + chunk * DH;       // chunk x DS: B * exp(cum_L - cum)
  float* cum = wb + chunk * DS;      // chunk
  double* wsum = reinterpret_cast<double*>(cum + chunk);  // kMaxChunk / 32
                                     // (chunk is even: 8 B aligned)

  const Tile tl = tile_of(s, nh, g, chunk);
  const int tid = threadIdx.x;
  load_x_async<DH>(xs, x, tl, nh, chunk);
  load_bc<DS>(wb, bm, tl, g, ds, chunk, DS, 1);
  chunk_cumsum(cum, wsum, a, tl, nh, chunk);

  const float total = cum[chunk - 1];
  if (tid < chunk) cum_out[tl.bh * s + tl.c * chunk + tid] = cum[tid];
  for (int e = tid; e < chunk * DS; e += kThreads) {
    wb[e] *= expf(total - cum[e / DS]);
  }
  cp_async_wait_all();
  __syncthreads();

  if (tid < DH * kCols) {
    const int d = tid / kCols, k0 = (tid % kCols) * kK;
    float acc[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) acc[q] = 0.f;
#pragma unroll 4
    for (int t = 0; t < chunk; ++t) {
      const float xv = xs[t * DH + d];
      float w[kK];
      load_vec<kK>(wb + t * DS + k0, w);
#pragma unroll
      for (int q = 0; q < kK; ++q) acc[q] = fmaf(xv, w[q], acc[q]);
    }
    const int nc = s / chunk;
    float* out = states + ((tl.bh * nc + tl.c) * DH + d) * ds;
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      if (k0 + q < ds) out[k0 + q] = acc[q];
    }
  }
}

// Pass 2.  One thread per (batch * head, e = d * ds + k): in place, dS_c
// becomes S_c, the state entering chunk c; the state after the last chunk
// goes to sfin.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const float* __restrict__ cum,
                      float* __restrict__ states, float* __restrict__ sfin,
                      int n_bh, int nc, int s, int chunk, int per) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(n_bh) * per) return;
  const size_t bh = idx / per;
  const int e = static_cast<int>(idx % per);
  const float* total = cum + bh * s + chunk - 1;   // chunk c's at c * chunk
  float* p = states + bh * nc * per + e;           // chunk c's at c * per
  float st = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kPassBatch) {
    float dsv[kPassBatch], dec[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        dsv[i] = p[static_cast<size_t>(c0 + i) * per];
        dec[i] = expf(total[static_cast<size_t>(c0 + i) * chunk]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      if (c0 + i < nc) {
        p[static_cast<size_t>(c0 + i) * per] = st;
        st = dec[i] * st + dsv[i];
      }
    }
  }
  sfin[idx] = st;
}

// Pass 3.  y = (C * exp(cum)) S_prev^T + (G * decay) x for one chunk.
// Warp w owns rows 8w..8w+7 of each 64-row strip and all DH dims: lane =
// (row group, dim group of 4), each thread kR rows x 4 dims.
template <int DH, int DS>
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_scan_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ cum_in,
                      const float* __restrict__ states, float* __restrict__ y,
                      int s, int nh, int g, int ds, int chunk) {
  constexpr int kDG = DH / 4;        // dim groups of 4 (16 or 4)
  constexpr int kRG = 32 / kDG;      // row groups per warp (2 or 8)
  constexpr int kR = 8 / kRG;        // rows per thread (4 or 1)
  // x staged in shared memory up to DS 64, read through L1 at DS 128 (where
  // a staged x does not fit).  Reading it through L1 at DS 16 too made
  // hymba's K4 ~11 % slower on the H100 (0.436-0.439 vs 0.391-0.396 ms).
  constexpr bool kStageX = DS <= 64;
  // Columns of the C row held in registers at once while G is built.
  constexpr int kCTile = DS < 64 ? DS : 64;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // chunk x DH (if kStageX)
  float* mt = xs + (kStageX ? chunk * DH : 0);  // chunk x kStripLd:
                                                // (G * decay)^T
  float* bs = mt + chunk * kStripLd;       // chunk x DS: B
  float* ct = bs + chunk * DS;             // DS x chunk: C^T
  float* st = ct + DS * chunk;             // DS x DH: S_prev^T
  float* cum = st + DS * DH;               // chunk
  float* ecum = cum + chunk;               // chunk: exp(cum)

  const Tile tl = tile_of(s, nh, g, chunk);
  const int nc = s / chunk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if constexpr (kStageX) load_x_async<DH>(xs, x, tl, nh, chunk);
  load_bc<DS>(bs, bm, tl, g, ds, chunk, DS, 1);
  load_bc<DS>(ct, cm, tl, g, ds, chunk, 1, chunk);
  const float* sp = states + (tl.bh * nc + tl.c) * DH * ds;
  for (int e = tid; e < DH * DS; e += kThreads) {
    const int d = e / DS, k = e % DS;
    st[k * DH + d] = k < ds ? sp[d * ds + k] : 0.f;
  }
  for (int t = tid; t < chunk; t += kThreads) {
    const float v = cum_in[tl.bh * s + tl.c * chunk + t];
    cum[t] = v;
    ecum[t] = expf(v);
  }
  __syncthreads();

  const int d0 = (lane % kDG) * 4;
  const int rg = lane / kDG;
  for (int s0 = 0; s0 < chunk; s0 += kStrip) {
    const int rows = min(kStrip, chunk - s0);   // a multiple of 32
    // (G * decay)^T of rows s0..s0+rows-1 against columns j < s0 + rows:
    // thread (row tl, column phase jg) keeps kCTile columns of its row of C
    // in registers at a time; between k-tiles the partial sums of G wait in
    // the strip (the same thread reads back what it wrote).
    {
      const int r = tid % kStrip, jg = tid / kStrip;
      const int t = s0 + r;
      if (r < rows) {
        const float cum_t = cum[t];
#pragma unroll 1
        for (int k0 = 0; k0 < DS; k0 += kCTile) {
          float cr[kCTile];
#pragma unroll
          for (int k = 0; k < kCTile; ++k) cr[k] = ct[(k0 + k) * chunk + t];
          const bool last = k0 + kCTile == DS;
          for (int j = jg; j < s0 + rows; j += kThreads / kStrip) {
            float* mj = mt + j * kStripLd + r;
            if (j <= t) {
              float gtj = k0 == 0 ? 0.f : *mj;
#pragma unroll
              for (int k = 0; k < kCTile; k += 4) {
                const float4 bv =
                    *reinterpret_cast<const float4*>(bs + j * DS + k0 + k);
                gtj = fmaf(cr[k], bv.x, gtj);
                gtj = fmaf(cr[k + 1], bv.y, gtj);
                gtj = fmaf(cr[k + 2], bv.z, gtj);
                gtj = fmaf(cr[k + 3], bv.w, gtj);
              }
              *mj = last ? gtj * expf(fminf(cum_t - cum[j], 0.f)) : gtj;
            } else if (k0 == 0) {
              *mj = 0.f;
            }
          }
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    if (warp * 8 < rows) {
      const int r0 = warp * 8 + rg * kR;   // first row within the strip
      const int t0 = s0 + r0;
      float acc[kR][4];
      float ec[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        ec[r] = ecum[t0 + r];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
      }
#pragma unroll 4
      for (int k = 0; k < DS; ++k) {
        const float4 sv = *reinterpret_cast<const float4*>(st + k * DH + d0);
        float cv[kR];
        load_vec<kR>(ct + k * chunk + t0, cv);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float ck = cv[r] * ec[r];
          acc[r][0] = fmaf(ck, sv.x, acc[r][0]);
          acc[r][1] = fmaf(ck, sv.y, acc[r][1]);
          acc[r][2] = fmaf(ck, sv.z, acc[r][2]);
          acc[r][3] = fmaf(ck, sv.w, acc[r][3]);
        }
      }
      const int jend = s0 + warp * 8 + 8;   // past the warp's last row
#pragma unroll 4
      for (int j = 0; j < jend; ++j) {
        const float4 xv =
            kStageX ? *reinterpret_cast<const float4*>(xs + j * DH + d0)
                    : __ldg(reinterpret_cast<const float4*>(
                          x + ((tl.row0 + j) * nh + tl.h) * DH + d0));
        float mv[kR];
        load_vec<kR>(mt + j * kStripLd + r0, mv);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          acc[r][0] = fmaf(mv[r], xv.x, acc[r][0]);
          acc[r][1] = fmaf(mv[r], xv.y, acc[r][1]);
          acc[r][2] = fmaf(mv[r], xv.z, acc[r][2]);
          acc[r][3] = fmaf(mv[r], xv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        *reinterpret_cast<float4*>(
            y + ((tl.row0 + t0 + r) * nh + tl.h) * DH + d0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();   // every read of this strip is done
  }
}

size_t state_smem(int dh, int ds, int chunk) {
  return sizeof(float) * static_cast<size_t>(chunk) * (dh + ds + 1) +
         sizeof(double) * (kMaxChunk / 32);
}

size_t scan_smem(int dh, int ds, int chunk) {
  const int x_cols = ds <= 64 ? dh : 0;   // kStageX
  return sizeof(float) * (static_cast<size_t>(chunk) *
                              (x_cols + kStripLd + 2 * ds + 2) +
                          static_cast<size_t>(ds) * dh);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Instances: pass 1 (chunk states) then pass 3 (chunk scan), each at dh
// 16 then 64 and ds 8, 16, 32, 64, 128; last the state pass.
constexpr int kDsWidths = 5;
#define K4_INSTANCE(KERNEL, DH, DS)                                         \
  {reinterpret_cast<const void*>(KERNEL<DH, DS>),                           \
   #KERNEL "<" #DH ", " #DS ">"}
#define K4_WIDTHS(KERNEL, DH)                                               \
  K4_INSTANCE(KERNEL, DH, 8), K4_INSTANCE(KERNEL, DH, 16),                  \
      K4_INSTANCE(KERNEL, DH, 32), K4_INSTANCE(KERNEL, DH, 64),             \
      K4_INSTANCE(KERNEL, DH, 128)
const KernelInstance kK4Instances[] = {
    K4_WIDTHS(ssd_chunk_state_kernel, 16),
    K4_WIDTHS(ssd_chunk_state_kernel, 64),
    K4_WIDTHS(ssd_chunk_scan_kernel, 16),
    K4_WIDTHS(ssd_chunk_scan_kernel, 64),
    {reinterpret_cast<const void*>(ssd_state_pass_kernel),
     "ssd_state_pass_kernel"},
};
#undef K4_WIDTHS
#undef K4_INSTANCE

template <int DH, int DS>
constexpr int width_index() {
  return (DH == 16 ? 0 : kDsWidths) +
         (DS == 8 ? 0 : DS == 16 ? 1 : DS == 32 ? 2 : DS == 64 ? 3 : 4);
}

// The three launches of a call (the first alone with chunk_states_only):
// chunk states, state pass, chunk scan.
template <int DH, int DS>
int plan(int b, int s, int nh, int ds, int chunk, bool chunk_states_only,
         LaunchPlan* out) {
  const int tiles = b * (s / chunk) * nh;
  out[0] = LaunchPlan{width_index<DH, DS>(), dim3(tiles), dim3(kThreads),
                      state_smem(DH, DS, chunk)};
  if (chunk_states_only) return 1;
  const long long n_state = static_cast<long long>(b) * nh * DH * ds;
  out[1] = LaunchPlan{4 * kDsWidths,
                      dim3(static_cast<int>((n_state + kThreads - 1) /
                                            kThreads)),
                      dim3(kThreads), 0};
  out[2] = LaunchPlan{2 * kDsWidths + width_index<DH, DS>(), dim3(tiles),
                      dim3(kThreads), scan_smem(DH, DS, chunk)};
  return 3;
}

template <int DH, int DS>
int launch(const float* x, const float* a, const float* bm, const float* cm,
           float* y, float* sfin, float* cum, float* states, int b, int s,
           int nh, int g, int ds, int chunk, bool chunk_states_only,
           cudaStream_t stream) {
  const int nc = s / chunk;
  LaunchPlan p[3];
  plan<DH, DS>(b, s, nh, ds, chunk, chunk_states_only, p);
  cudaError_t err = allow_smem(ssd_chunk_state_kernel<DH, DS>, p[0].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_state_kernel<DH, DS><<<p[0].grid, p[0].block, p[0].smem, stream>>>(
      x, a, bm, cum, states, s, nh, g, ds, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || chunk_states_only) return static_cast<int>(err);

  const int per = DH * ds;
  ssd_state_pass_kernel<<<p[1].grid, p[1].block, p[1].smem, stream>>>(
      cum, states, sfin, b * nh, nc, s, chunk, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(ssd_chunk_scan_kernel<DH, DS>, p[2].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_scan_kernel<DH, DS><<<p[2].grid, p[2].block, p[2].smem, stream>>>(
      x, bm, cm, cum, states, y, s, nh, g, ds, chunk);
  return static_cast<int>(cudaGetLastError());
}

// f(DH, DS) at the instance a call with (dh, ds) takes, DH and DS as
// std::integral_constant: ds is padded to 8, 16, 32, 64 or 128 columns;
// cudaErrorInvalidValue for a dh with no instance.  The launch and the
// plan query both go through it.
template <typename F>
int with_shape(int dh, int ds, F&& f) {
  auto widths = [&](auto d) {
    if (ds <= 8) return f(d, std::integral_constant<int, 8>{});
    if (ds <= 16) return f(d, std::integral_constant<int, 16>{});
    if (ds <= 32) return f(d, std::integral_constant<int, 32>{});
    if (ds <= 64) return f(d, std::integral_constant<int, 64>{});
    return f(d, std::integral_constant<int, 128>{});
  };
  if (dh == 16) return widths(std::integral_constant<int, 16>{});
  if (dh == 64) return widths(std::integral_constant<int, 64>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K4 on `stream`: three kernels (chunk states, state pass, chunk
// scan); a nonzero `chunk_states_only` stops after pass 1 (to check it
// alone: pass 2 rewrites its output in place).
// x (b, s, nh, dh), a (b, s, nh), bm and cm (b, s, g, ds), y like x, sfin
// (b, nh, dh, ds), and the scratch cum (b, nh, s) and states (b, nh,
// s / chunk, dh, ds): all contiguous f32 on the device, x and y 16-byte
// aligned.  dh in {16, 64}, 1 <= ds <= 128, nh % g == 0, chunk a multiple
// of 32 up to 128 dividing s.  After the call, cum holds each chunk's
// inclusive cumsum of a and states each chunk's dS (with
// chunk_states_only) or else the state entering it.  Returns the first
// launch error (0 on success).
int k4_ssd_scan(const float* x, const float* a, const float* bm,
                const float* cm, float* y, float* sfin, float* cum,
                float* states, int b, int s, int nh, int g, int dh, int ds,
                int chunk, int chunk_states_only, void* stream) {
  using namespace repro_torch;
  if (b <= 0 || nh <= 0) return 0;
  if (g <= 0 || nh % g != 0 || ds <= 0 || ds > 128 || chunk <= 0 ||
      chunk % 32 != 0 || chunk > kMaxChunk || s <= 0 || s % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  return with_shape(dh, ds, [&](auto d, auto w) {
    return launch<decltype(d)::value, decltype(w)::value>(
        x, a, bm, cm, y, sfin, cum, states, b, s, nh, g, ds, chunk,
        chunk_states_only != 0, st);
  });
}

// The launches k4_ssd_scan makes for these shapes (none, one or three),
// as kPlanInts ints each; budget.cuh says what they hold.
int k4_plan(int b, int s, int nh, int g, int dh, int ds, int chunk,
            int chunk_states_only, int* out, int* n_launches) {
  using namespace repro_torch;
  *n_launches = 0;
  if (b <= 0 || nh <= 0) return 0;
  if (g <= 0 || nh % g != 0 || ds <= 0 || ds > 128 || chunk <= 0 ||
      chunk % 32 != 0 || chunk > kMaxChunk || s <= 0 || s % chunk != 0 ||
      (dh != 16 && dh != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchPlan p[3];
  const int n = with_shape(dh, ds, [&](auto d, auto w) {
    return plan<decltype(d)::value, decltype(w)::value>(
        b, s, nh, ds, chunk, chunk_states_only != 0, p);
  });
  for (int i = 0; i < n; ++i) write_plan(p[i], out + i * kPlanInts);
  *n_launches = n;
  return 0;
}

const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

REPRO_INSTANCE_QUERIES(k4, kK4Instances)
