// K4-bwd: the gradient of the chunked Mamba2 SSD scan (K4, ssd.cu) in x,
// a, B and C.
//
// Replaces no TPU kernel: the reference trains through its jnp
// ssd_chunked (repro/models/ssm.py) and differentiates that; its Pallas
// scan has no custom_vjp.  The port's training path runs K4 on the card,
// and a kernel launched through ctypes has no gradient of its own, so
// ops.SSDScan calls this from its backward.
//
// Per chunk of L steps and head, with the forward's cum = cumsum(a), T =
// cum_L, S / S' the states entering / leaving the chunk and dS' the
// gradient into S':
//
//   G = C B^T,  P_tj = dy_t . x_j,  D_tj = exp(min(cum_t - cum_j, 0)), j <= t
//   dx_j = sum_t G_tj D_tj dy_t + e^{T - cum_j} dS' B_j
//   dB_j = sum_t D_tj P_tj C_t  + e^{T - cum_j} dS'^T x_j
//   dC_t = sum_j D_tj P_tj B_j  + e^{cum_t} S^T dy_t
//   dcum = rowsum(M) - colsum(M) + C . (e^{cum} S^T dy) - B . (e^{T-cum}
//          dS'^T x) (+ <dS', S'> at the last step),  M = G D P
//   da   = the reverse cumsum of dcum within the chunk
//   dS   = sum_t e^{cum_t} dy_t C_t^T + e^T dS'  (dS' of the chunk before)
//
// M passes no gradient where cum_t - cum_j > 0 (the clamp's), and every
// exponent is written as a difference that is <= 0 for a <= 0: D is
// never factored into e^{cum_t} e^{-cum_j}.  dB and dC are summed over
// each group's heads.  Inputs as K4's, plus the forward's scratch (each
// chunk's cum and entering state), its final state, dy (b, s, nh, dh) and
// the final state's gradient (b, nh, dh, ds) or none; all IEEE f32.
//
// What bounds it on this card: the f32 operations of the causal (t, j)
// pairs, 3 ds + 2 dh multiply-adds each (G, P, dx, dB, dC), beside 4 L dh
// ds per chunk and head for the state terms, against the f32 peak
// (chip_smoke.py, ssd_bwd_ops).
//
// Design: the forward's three passes run in reverse, then a sum over each
// group's heads; four launches on one stream, no atomics, so two calls
// agree bit for bit:
//
//   1. ssd_bwd_chunk_state_kernel, one CTA per (batch, chunk, head): U =
//      sum_t e^{cum_t} dy_t C_t^T into `dstates` (pass 1 of K4 with dy for
//      x and C e^{cum} for B e^{T - cum}), the entering state's part of dC
//      into the per-head dC, and its dcum term into `dcum`.
//   2. ssd_bwd_state_pass_kernel, one thread per (batch, head, d, k): from
//      dfinal (or 0), dS' of chunk c is written over U_c, then dS' <- U_c
//      + e^{T_c} dS' for chunk c - 1; 8 chunks' loads at a time.
//   3. ssd_bwd_chunk_kernel, one CTA per (batch, chunk, head): the chunk
//      in 32 x 32 blocks of (t, j).  For each j block: x_j and B_j staged,
//      dx_j and dB_j started from dS' in registers (dS' and its transpose
//      staged once), then for each t block at or below it: dy_t and C_t
//      staged, G, P and D of the 32 x 32 pairs (thread: one t, four j; float4
//      dot products), G D, P D and M parked in shared memory, dx_j and dB_j
//      accumulated in registers and dC_t in a shared (L, ds) accumulator;
//      M's row and column sums go to dcum.  Then dC is stored, and da as
//      the reverse cumsum of dcum, summed in f64 as the forward's cumsum.
//      ~201 KB of shared memory at mamba2's (dh 64, ds 128, L 128): one
//      CTA per SM; ~56 KB at hymba's ds 16.  No (L, L) matrix is staged.
//   4. ssd_bwd_group_sum_kernel, one thread per (batch, step, group, k):
//      the per-head dB and dC added in head order.
//
// B and C are staged padded with zeros to DS (8, 16, 32, 64 or 128), as in
// K4.
#include <cuda_runtime.h>

#include <type_traits>

#include "budget.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 128;
constexpr int kBlock = 32;            // rows of a (t, j) block of the chunk
constexpr int kPad = 4;               // row padding of the staged operands
constexpr int kBlockLd = kBlock + 1;  // row stride of the G D / P D / M blocks
constexpr int kPassBatch = 8;         // chunks the state pass loads at once

// Planted faults, for the checks that must catch them (chip_smoke.py):
// in the third pass every j block skips its last t block (the last j
// block its diagonal one).
constexpr int kFaultDropLastTBlock = 1;

// The (batch, chunk, head) tile of a CTA of passes 1 and 3, as K4's.
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

// The columns of a W-wide row that thread group gq (of 8) owns: kP runs of
// kV consecutive columns, p * 8 kV + gq kV + q, so the 8 threads of a
// quarter warp read 8 kV consecutive floats.
template <int W>
struct Seg {
  static constexpr int kN = W / 8;
  static constexpr int kV = kN < 4 ? kN : 4;
  static constexpr int kP = kN / kV;
  __device__ static int col(int p, int gq) { return (p * 8 + gq) * kV; }
};

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else if constexpr (V == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x; v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// acc += s * row[the thread's columns].
template <int W>
__device__ __forceinline__ void axpy_seg(float (&acc)[Seg<W>::kN], float s,
                                         const float* row, int gq) {
  using S = Seg<W>;
#pragma unroll
  for (int p = 0; p < S::kP; ++p) {
    float v[S::kV];
    load_v<S::kV>(row + S::col(p, gq), v);
#pragma unroll
    for (int q = 0; q < S::kV; ++q) {
      acc[p * S::kV + q] = fmaf(s, v[q], acc[p * S::kV + q]);
    }
  }
}

// sum over the thread's columns of acc * row, then over its 8 threads
// (consecutive lanes), in a fixed order.
template <int W>
__device__ __forceinline__ float dot_seg(const float (&acc)[Seg<W>::kN],
                                         const float* row, int gq) {
  using S = Seg<W>;
  float dot = 0.f;
#pragma unroll
  for (int p = 0; p < S::kP; ++p) {
    float v[S::kV];
    load_v<S::kV>(row + S::col(p, gq), v);
#pragma unroll
    for (int q = 0; q < S::kV; ++q) dot = fmaf(acc[p * S::kV + q], v[q], dot);
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  }
  return dot;
}

// Four dot products of length W (a multiple of 4): row a against rows
// b + i * 8 ld, i < 4.
template <int W>
__device__ __forceinline__ void dot4(const float* a, const float* b, int ld,
                                     float (&out)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = 0.f;
#pragma unroll 4
  for (int k = 0; k < W; k += 4) {
    const float4 av = *reinterpret_cast<const float4*>(a + k);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 bv = *reinterpret_cast<const float4*>(b + i * 8 * ld + k);
      out[i] = fmaf(av.x, bv.x, out[i]);
      out[i] = fmaf(av.y, bv.y, out[i]);
      out[i] = fmaf(av.z, bv.z, out[i]);
      out[i] = fmaf(av.w, bv.w, out[i]);
    }
  }
}

// Rows r0 .. r0 + n - 1 of the chunk of x or dy (head h, DH wide) into dst
// (row stride ld), 16 bytes per load.
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          const Tile& tl, int nh, int r0,
                                          int n) {
  constexpr int kVec = DH / 4;
  for (int e = threadIdx.x; e < n * kVec; e += kThreads) {
    const int t = e / kVec, v = e % kVec;
    *reinterpret_cast<float4*>(dst + t * ld + 4 * v) =
        __ldg(reinterpret_cast<const float4*>(
            src + ((tl.row0 + r0 + t) * nh + tl.h) * DH + 4 * v));
  }
}

// Rows r0 .. r0 + n - 1 of the chunk of B (or C), zero-padded from ds to
// DS, times scale[t] when a scale is given.
template <int DS>
__device__ __forceinline__ void load_bc_rows(float* dst, int ld,
                                             const float* src, const Tile& tl,
                                             int g, int ds, int r0, int n,
                                             const float* scale = nullptr) {
  for (int e = threadIdx.x; e < n * DS; e += kThreads) {
    const int t = e / DS, k = e % DS;
    float v = k < ds ? src[((tl.row0 + r0 + t) * g + tl.gi) * ds + k] : 0.f;
    if (scale != nullptr) v *= scale[t];
    dst[t * ld + k] = v;
  }
}

// The sum of v over the CTA, in a fixed order (warps, then warp 0's sums
// in warp order); the result in thread 0.  red holds kThreads / 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) out += red[w];
  }
  return out;
}

// Pass 1.  U[d][k] = sum_t dy_t[d] C_t[k] e^{cum_t} (thread (d, k-group)
// owns kK consecutive k of one d, as K4's pass 1), then per row t the
// entering state's part of dC, e^{cum_t} S^T dy_t, and C_t . that.
template <int DH, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_state_kernel(const float* __restrict__ dy,
                           const float* __restrict__ cm,
                           const float* __restrict__ cum_in,
                           const float* __restrict__ states,
                           float* __restrict__ dstates,
                           float* __restrict__ dch, float* __restrict__ dcum,
                           int s, int nh, int g, int ds, int chunk) {
  constexpr int kK = DH * DS / kThreads > 0 ? DH * DS / kThreads : 1;
  constexpr int kCols = DS / kK;   // threads per d
  constexpr int kLdY = DH + kPad, kLdS = DS + kPad;
  using SB = Seg<DS>;
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                 // chunk x kLdY: dy
  float* wc = dys + chunk * kLdY;    // chunk x DS: C * exp(cum)
  float* ss = wc + chunk * DS;       // DH x kLdS: the entering state S
  float* ecum = ss + DH * kLdS;      // chunk: exp(cum)

  const Tile tl = tile_of(s, nh, g, chunk);
  const int nc = s / chunk, tid = threadIdx.x;
  const size_t cbase = tl.bh * s + static_cast<size_t>(tl.c) * chunk;
  load_rows<DH>(dys, kLdY, dy, tl, nh, 0, chunk);
  for (int t = tid; t < chunk; t += kThreads) {
    ecum[t] = expf(cum_in[cbase + t]);
  }
  const float* sp = states + (tl.bh * nc + tl.c) * DH * ds;
  for (int e = tid; e < DH * DS; e += kThreads) {
    const int d = e / DS, k = e % DS;
    ss[d * kLdS + k] = k < ds ? sp[d * ds + k] : 0.f;
  }
  __syncthreads();
  load_bc_rows<DS>(wc, DS, cm, tl, g, ds, 0, chunk, ecum);
  __syncthreads();

  if (tid < DH * kCols) {
    const int d = tid / kCols, k0 = (tid % kCols) * kK;
    float acc[kK];
#pragma unroll
    for (int q = 0; q < kK; ++q) acc[q] = 0.f;
#pragma unroll 4
    for (int t = 0; t < chunk; ++t) {
      const float v = dys[t * kLdY + d];
#pragma unroll
      for (int q = 0; q < kK; ++q) {
        acc[q] = fmaf(v, wc[t * DS + k0 + q], acc[q]);
      }
    }
    float* out = dstates + ((tl.bh * nc + tl.c) * DH + d) * ds;
#pragma unroll
    for (int q = 0; q < kK; ++q) {
      if (k0 + q < ds) out[k0 + q] = acc[q];
    }
  }

  const int r = tid >> 3, gq = tid & 7;
  for (int t0 = 0; t0 < chunk; t0 += kBlock) {
    const int t = t0 + r;
    float acc[SB::kN];
#pragma unroll
    for (int i = 0; i < SB::kN; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      axpy_seg<DS>(acc, dys[t * kLdY + d], ss + d * kLdS, gq);
    }
    // C_t . dC_t = sum_k (C_t[k] e^{cum_t}) (S^T dy_t)[k]
    const float dot = dot_seg<DS>(acc, wc + t * DS, gq);
    if (gq == 0) dcum[cbase + t] = dot;
    const float e = ecum[t];
    float* out = dch + ((tl.row0 + t) * nh + tl.h) * ds;
#pragma unroll
    for (int p = 0; p < SB::kP; ++p) {
#pragma unroll
      for (int q = 0; q < SB::kV; ++q) {
        const int k = SB::col(p, gq) + q;
        if (k < ds) out[k] = e * acc[p * SB::kV + q];
      }
    }
  }
}

// Pass 2.  One thread per (batch * head, e = d * ds + k): from the last
// chunk, U_c is replaced in place by dS' of chunk c, and dS' <- U_c + e^{T_c}
// dS' is carried to the chunk before.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass_kernel(const float* __restrict__ cum,
                          float* __restrict__ dstates,
                          const float* __restrict__ dfinal, int n_bh, int nc,
                          int s, int chunk, int per) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(n_bh) * per) return;
  const size_t bh = idx / per;
  const int e = static_cast<int>(idx % per);
  const float* total = cum + bh * s + chunk - 1;   // chunk c's at c * chunk
  float* p = dstates + bh * nc * per + e;          // chunk c's at c * per
  float r = dfinal != nullptr ? dfinal[idx] : 0.f;
  for (int c1 = nc; c1 > 0; c1 -= kPassBatch) {
    float u[kPassBatch], dec[kPassBatch];
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      const int c = c1 - 1 - i;
      if (c >= 0) {
        u[i] = p[static_cast<size_t>(c) * per];
        dec[i] = expf(total[static_cast<size_t>(c) * chunk]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPassBatch; ++i) {
      const int c = c1 - 1 - i;
      if (c >= 0) {
        p[static_cast<size_t>(c) * per] = r;
        r = u[i] + dec[i] * r;
      }
    }
  }
}

// Pass 3.  dx, da and the per-head dB, dC of one chunk in 32 x 32 blocks of
// (t, j); see the header.  Thread (r, gq) = (tid / 8, tid % 8): row r of a
// block and its column group.
// Launch bounds of one CTA per SM: with no minimum, ptxas kept 64-80
// registers and spilled 4-16 B at some state widths (with two, 4 B at
// hymba's DS 16); with one it takes 126-180 and spills nothing, and
// hymba's call takes 1.97 ms where the spilling 80-register build (three
// CTAs per SM) took 1.46 and the two-CTA one 1.53 (H100; PERF.md).
template <int DH, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ cum_in,
                     const float* __restrict__ states,
                     const float* __restrict__ sfin,
                     const float* __restrict__ dstates,
                     const float* __restrict__ dcum_in,
                     float* __restrict__ dx, float* __restrict__ da,
                     float* __restrict__ dbh, float* __restrict__ dch, int s,
                     int nh, int g, int ds, int chunk, int fault) {
  constexpr int kLdX = DH + kPad, kLdB = DS + kPad;
  using SX = Seg<DH>;
  using SB = Seg<DS>;
  extern __shared__ __align__(16) float smem[];
  double* wsum = reinterpret_cast<double*>(smem);   // kMaxChunk / 32
  float* dsn = reinterpret_cast<float*>(wsum + kMaxChunk / 32);
                                          // DH x kLdB: dS'
  float* dsnt = dsn + DH * kLdB;          // DS x kLdX: dS'^T
  float* xs = dsnt + DS * kLdX;           // kBlock x kLdX: x of the j block
  float* bs = xs + kBlock * kLdX;         // kBlock x kLdB: B of the j block
  float* ys = bs + kBlock * kLdB;         // kBlock x kLdX: dy of the t block
  float* cs = ys + kBlock * kLdX;         // kBlock x kLdB: C of the t block
  float* qs = cs + kBlock * kLdB;         // kBlock x kBlockLd: (G D)[t][j]
  float* rs = qs + kBlock * kBlockLd;     // (P D)[t][j]
  float* ms = rs + kBlock * kBlockLd;     // M[t][j]
  float* dca = ms + kBlock * kBlockLd;    // chunk x kLdB: dC of the chunk
  float* cum = dca + chunk * kLdB;        // chunk
  float* dcum = cum + chunk;              // chunk
  float* red = dcum + chunk;              // kThreads / 32

  const Tile tl = tile_of(s, nh, g, chunk);
  const int nc = s / chunk, tid = threadIdx.x;
  const int r = tid >> 3, gq = tid & 7;
  const size_t cbase = tl.bh * s + static_cast<size_t>(tl.c) * chunk;
  for (int t = tid; t < chunk; t += kThreads) {
    cum[t] = cum_in[cbase + t];
    dcum[t] = dcum_in[cbase + t];
  }
  // dS', its transpose, and <dS', S'>.
  const float* dp = dstates + (tl.bh * nc + tl.c) * DH * ds;
  const float* sn = tl.c + 1 < nc ? states + (tl.bh * nc + tl.c + 1) * DH * ds
                                  : sfin + tl.bh * DH * ds;
  float part = 0.f;
  for (int e = tid; e < DH * DS; e += kThreads) {
    const int d = e / DS, k = e % DS;
    const float v = k < ds ? dp[d * ds + k] : 0.f;
    dsn[d * kLdB + k] = v;
    dsnt[k * kLdX + d] = v;
    if (k < ds) part = fmaf(v, sn[d * ds + k], part);
  }
  // dC starts from pass 1's e^{cum_t} S^T dy_t.
  for (int e = tid; e < chunk * DS; e += kThreads) {
    const int t = e / DS, k = e % DS;
    dca[t * kLdB + k] =
        k < ds ? dch[((tl.row0 + t) * nh + tl.h) * ds + k] : 0.f;
  }
  part = block_sum(part, red);
  if (tid == 0) dcum[chunk - 1] += part;
  __syncthreads();

  const float total = cum[chunk - 1];
  const int nb = chunk / kBlock;
  const int tb_end = (fault & kFaultDropLastTBlock) != 0 ? nb - 1 : nb;
  for (int jb = 0; jb < nb; ++jb) {
    const int j0 = jb * kBlock, j = j0 + r;
    load_rows<DH>(xs, kLdX, x, tl, nh, j0, kBlock);
    load_bc_rows<DS>(bs, kLdB, bm, tl, g, ds, j0, kBlock);
    __syncthreads();
    // The leaving state's terms: e^{T - cum_j} (dS' B_j, dS'^T x_j), and
    // -B_j . dS'^T x_j e^{T - cum_j} of dcum.
    const float w = expf(total - cum[j]);
    float adx[SX::kN], adb[SB::kN];
#pragma unroll
    for (int i = 0; i < SX::kN; ++i) adx[i] = 0.f;
#pragma unroll
    for (int i = 0; i < SB::kN; ++i) adb[i] = 0.f;
#pragma unroll 4
    for (int k = 0; k < DS; ++k) {
      axpy_seg<DH>(adx, bs[r * kLdB + k], dsnt + k * kLdX, gq);
    }
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      axpy_seg<DS>(adb, xs[r * kLdX + d], dsn + d * kLdB, gq);
    }
#pragma unroll
    for (int i = 0; i < SX::kN; ++i) adx[i] *= w;
#pragma unroll
    for (int i = 0; i < SB::kN; ++i) adb[i] *= w;
    const float bdot = dot_seg<DS>(adb, bs + r * kLdB, gq);
    if (gq == 0) dcum[j] -= bdot;

    for (int tb = jb; tb < tb_end; ++tb) {
      const int t0 = tb * kBlock, t = t0 + r;
      load_rows<DH>(ys, kLdX, dy, tl, nh, t0, kBlock);
      load_bc_rows<DS>(cs, kLdB, cm, tl, g, ds, t0, kBlock);
      __syncthreads();
      {
        // Pairs (t, j0 + gq + 8i): G, P, D.  Above the diagonal D is
        // selected to 0, never computed.
        float gv[4], pv[4];
        dot4<DS>(cs + r * kLdB, bs + gq * kLdB, kLdB, gv);
        dot4<DH>(ys + r * kLdX, xs + gq * kLdX, kLdX, pv);
        const float cum_t = cum[t];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int jl = gq + 8 * i;
          const float z = cum_t - cum[j0 + jl];
          const float dec = j0 + jl <= t ? expf(fminf(z, 0.f)) : 0.f;
          const float rv = pv[i] * dec;
          qs[r * kBlockLd + jl] = gv[i] * dec;
          rs[r * kBlockLd + jl] = rv;
          ms[r * kBlockLd + jl] = z > 0.f ? 0.f : gv[i] * rv;
        }
      }
      __syncthreads();
      // dx_j += sum_t (G D)[t][j] dy_t, dB_j += sum_t (P D)[t][j] C_t.
#pragma unroll 4
      for (int i = 0; i < kBlock; ++i) {
        axpy_seg<DH>(adx, qs[i * kBlockLd + r], ys + i * kLdX, gq);
        axpy_seg<DS>(adb, rs[i * kBlockLd + r], cs + i * kLdB, gq);
      }
      {
        // dC_t += sum_j (P D)[t][j] B_j.
        float acc[SB::kN];
#pragma unroll
        for (int i = 0; i < SB::kN; ++i) acc[i] = 0.f;
#pragma unroll 4
        for (int i = 0; i < kBlock; ++i) {
          axpy_seg<DS>(acc, rs[r * kBlockLd + i], bs + i * kLdB, gq);
        }
        float* row = dca + t * kLdB;
#pragma unroll
        for (int p = 0; p < SB::kP; ++p) {
#pragma unroll
          for (int q = 0; q < SB::kV; ++q) {
            row[SB::col(p, gq) + q] += acc[p * SB::kV + q];
          }
        }
      }
      if (tid < kBlock) {
        // rowsum(M) into dcum_t, -colsum(M) into dcum_j (one thread per
        // index, so a diagonal block's two updates do not race).
        float rsum = 0.f, csum = 0.f;
        for (int i = 0; i < kBlock; ++i) {
          rsum += ms[tid * kBlockLd + i];
          csum += ms[i * kBlockLd + tid];
        }
        dcum[t0 + tid] += rsum;
        dcum[j0 + tid] -= csum;
      }
      __syncthreads();
    }
    float* ox = dx + ((tl.row0 + j) * nh + tl.h) * DH;
#pragma unroll
    for (int p = 0; p < SX::kP; ++p) {
#pragma unroll
      for (int q = 0; q < SX::kV; ++q) {
        ox[SX::col(p, gq) + q] = adx[p * SX::kV + q];
      }
    }
    float* ob = dbh + ((tl.row0 + j) * nh + tl.h) * ds;
#pragma unroll
    for (int p = 0; p < SB::kP; ++p) {
#pragma unroll
      for (int q = 0; q < SB::kV; ++q) {
        const int k = SB::col(p, gq) + q;
        if (k < ds) ob[k] = adb[p * SB::kV + q];
      }
    }
  }
  for (int e = tid; e < chunk * DS; e += kThreads) {
    const int t = e / DS, k = e % DS;
    if (k < ds) dch[((tl.row0 + t) * nh + tl.h) * ds + k] = dca[t * kLdB + k];
  }

  // da_t = sum_{t' >= t} dcum_t': an inclusive scan of the reversed steps,
  // a shuffle scan over 32 per warp, then the warps before, in f64.
  const int lane = tid & 31, warp = tid >> 5;
  const int t = chunk - 1 - tid;
  double v = tid < chunk ? static_cast<double>(dcum[t]) : 0.0;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += o;
  }
  if (lane == 31 && tid < chunk) wsum[warp] = v;
  __syncthreads();
  if (tid < chunk) {
    for (int w2 = 0; w2 < warp; ++w2) v += wsum[w2];
    da[(tl.row0 + t) * nh + tl.h] = static_cast<float>(v);
  }
}

// Pass 4.  One thread per (batch, step, group, k): the per-head dB and dC
// summed over the group's heads in head order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_group_sum_kernel(const float* __restrict__ dbh,
                         const float* __restrict__ dch, float* __restrict__ db,
                         float* __restrict__ dc, long long n, int nh, int g,
                         int ds) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n) return;
  const int k = static_cast<int>(idx % ds);
  const long long rest = idx / ds;
  const int gi = static_cast<int>(rest % g);
  const long long row = rest / g;   // batch * s + step
  const int rep = nh / g;
  const size_t base = (static_cast<size_t>(row) * nh + gi * rep) * ds + k;
  float sb = dbh[base], sc = dch[base];
  for (int i = 1; i < rep; ++i) {
    sb += dbh[base + static_cast<size_t>(i) * ds];
    sc += dch[base + static_cast<size_t>(i) * ds];
  }
  db[idx] = sb;
  dc[idx] = sc;
}

size_t state_smem(int dh, int ds, int chunk) {
  return sizeof(float) * (static_cast<size_t>(chunk) * (dh + kPad + ds + 1) +
                          static_cast<size_t>(dh) * (ds + kPad));
}

size_t chunk_smem(int dh, int ds, int chunk) {
  const size_t ld_x = dh + kPad, ld_b = ds + kPad;
  return sizeof(double) * (kMaxChunk / 32) +
         sizeof(float) * (dh * ld_b + ds * ld_x + kBlock * 2 * (ld_x + ld_b) +
                          3 * kBlock * kBlockLd + chunk * (ld_b + 2) +
                          kThreads / 32);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Instances: pass 1 then pass 3, each at dh 16 then 64 and ds 8, 16, 32,
// 64, 128; then the state pass and the group sum.
constexpr int kDsWidths = 5;
#define K4B_INSTANCE(KERNEL, DH, DS)                                        \
  {reinterpret_cast<const void*>(KERNEL<DH, DS>),                           \
   #KERNEL "<" #DH ", " #DS ">"}
#define K4B_WIDTHS(KERNEL, DH)                                              \
  K4B_INSTANCE(KERNEL, DH, 8), K4B_INSTANCE(KERNEL, DH, 16),                \
      K4B_INSTANCE(KERNEL, DH, 32), K4B_INSTANCE(KERNEL, DH, 64),           \
      K4B_INSTANCE(KERNEL, DH, 128)
const KernelInstance kK4bInstances[] = {
    K4B_WIDTHS(ssd_bwd_chunk_state_kernel, 16),
    K4B_WIDTHS(ssd_bwd_chunk_state_kernel, 64),
    K4B_WIDTHS(ssd_bwd_chunk_kernel, 16),
    K4B_WIDTHS(ssd_bwd_chunk_kernel, 64),
    {reinterpret_cast<const void*>(ssd_bwd_state_pass_kernel),
     "ssd_bwd_state_pass_kernel"},
    {reinterpret_cast<const void*>(ssd_bwd_group_sum_kernel),
     "ssd_bwd_group_sum_kernel"},
};
#undef K4B_WIDTHS
#undef K4B_INSTANCE

template <int DH, int DS>
constexpr int width_index() {
  return (DH == 16 ? 0 : kDsWidths) +
         (DS == 8 ? 0 : DS == 16 ? 1 : DS == 32 ? 2 : DS == 64 ? 3 : 4);
}

// The four launches of a call (the first alone with chunk_states_only):
// chunk states, state pass, chunk, group sum.
template <int DH, int DS>
int plan(int b, int s, int nh, int g, int ds, int chunk,
         bool chunk_states_only, LaunchPlan* out) {
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
                      dim3(kThreads), chunk_smem(DH, DS, chunk)};
  const long long n_sum = static_cast<long long>(b) * s * g * ds;
  out[3] = LaunchPlan{4 * kDsWidths + 1,
                      dim3(static_cast<int>((n_sum + kThreads - 1) /
                                            kThreads)),
                      dim3(kThreads), 0};
  return 4;
}

struct Args {
  const float *x, *bm, *cm, *dy, *cum, *states, *sfin, *dfinal;
  float *dx, *da, *db, *dc, *dstates, *dbh, *dch, *dcum;
  int b, s, nh, g, ds, chunk, fault;
  bool chunk_states_only;
};

template <int DH, int DS>
int launch(const Args& a, cudaStream_t stream) {
  const int nc = a.s / a.chunk;
  LaunchPlan p[4];
  plan<DH, DS>(a.b, a.s, a.nh, a.g, a.ds, a.chunk, a.chunk_states_only, p);
  cudaError_t err = allow_smem(ssd_bwd_chunk_state_kernel<DH, DS>, p[0].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_state_kernel<DH, DS>
      <<<p[0].grid, p[0].block, p[0].smem, stream>>>(
          a.dy, a.cm, a.cum, a.states, a.dstates, a.dch, a.dcum, a.s, a.nh,
          a.g, a.ds, a.chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.chunk_states_only) return static_cast<int>(err);

  ssd_bwd_state_pass_kernel<<<p[1].grid, p[1].block, p[1].smem, stream>>>(
      a.cum, a.dstates, a.dfinal, a.b * a.nh, nc, a.s, a.chunk, DH * a.ds);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(ssd_bwd_chunk_kernel<DH, DS>, p[2].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<DH, DS><<<p[2].grid, p[2].block, p[2].smem, stream>>>(
      a.x, a.bm, a.cm, a.dy, a.cum, a.states, a.sfin, a.dstates, a.dcum,
      a.dx, a.da, a.dbh, a.dch, a.s, a.nh, a.g, a.ds, a.chunk, a.fault);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_bwd_group_sum_kernel<<<p[3].grid, p[3].block, p[3].smem, stream>>>(
      a.dbh, a.dch, a.db, a.dc, static_cast<long long>(a.b) * a.s * a.g * a.ds,
      a.nh, a.g, a.ds);
  return static_cast<int>(cudaGetLastError());
}

// f(DH, DS) at the instance a call with (dh, ds) takes, as K4's.
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

bool bad_shape(int g, int nh, int ds, int chunk, int s) {
  return g <= 0 || nh % g != 0 || ds <= 0 || ds > 128 || chunk <= 0 ||
         chunk % kBlock != 0 || chunk > kMaxChunk || s <= 0 ||
         s % chunk != 0;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K4-bwd on `stream`: four kernels (chunk states, state pass,
// chunk, group sum); a nonzero `chunk_states_only` stops after pass 1 (to
// check it alone: pass 2 rewrites `dstates` and pass 3 `dch` in place).
// x and dy (b, s, nh, dh), bm and cm (b, s, g, ds), the forward's cum (b,
// nh, s), states (b, nh, s / chunk, dh, ds: the state entering each chunk)
// and sfin (b, nh, dh, ds), dfinal like sfin or null (zero); out: dx like
// x, da (b, s, nh), db and dc like bm; scratch: dstates like states, dbh
// and dch (b, s, nh, ds), dcum (b, nh, s).  All contiguous f32 on the
// device, x and dy 16-byte aligned.  dh in {16, 64}, 1 <= ds <= 128, nh % g
// == 0, chunk a multiple of 32 up to 128 dividing s.  After the call,
// dstates holds each chunk's U (with chunk_states_only) or else the
// gradient into the state leaving it; dbh and dch the per-head dB and dC
// (dch the entering states' part alone with chunk_states_only) and dcum
// pass 1's terms.  `fault` plants a fault for the checks that must catch
// it (kFaultDropLastTBlock); 0 otherwise.  Returns the first launch error
// (0 on success).
int k4b_ssd_scan_bwd(const float* x, const float* bm, const float* cm,
                     const float* dy, const float* cum, const float* states,
                     const float* sfin, const float* dfinal, float* dx,
                     float* da, float* db, float* dc, float* dstates,
                     float* dbh, float* dch, float* dcum, int b, int s,
                     int nh, int g, int dh, int ds, int chunk,
                     int chunk_states_only, int fault, void* stream) {
  using namespace repro_torch;
  if (b <= 0 || nh <= 0) return 0;
  if (bad_shape(g, nh, ds, chunk, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{x,  bm, cm, dy,      cum, states, sfin, dfinal,
                  dx, da, db, dc,      dstates, dbh, dch, dcum,
                  b,  s,  nh, g,       ds,  chunk, fault,
                  chunk_states_only != 0};
  auto st = static_cast<cudaStream_t>(stream);
  return with_shape(dh, ds, [&](auto d, auto w) {
    return launch<decltype(d)::value, decltype(w)::value>(args, st);
  });
}

// The launches k4b_ssd_scan_bwd makes for these shapes (none, one or
// four), as kPlanInts ints each; budget.cuh says what they hold.
int k4b_plan(int b, int s, int nh, int g, int dh, int ds, int chunk,
             int chunk_states_only, int* out, int* n_launches) {
  using namespace repro_torch;
  *n_launches = 0;
  if (b <= 0 || nh <= 0) return 0;
  if (bad_shape(g, nh, ds, chunk, s) || (dh != 16 && dh != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchPlan p[4];
  const int n = with_shape(dh, ds, [&](auto d, auto w) {
    return plan<decltype(d)::value, decltype(w)::value>(
        b, s, nh, g, ds, chunk, chunk_states_only != 0, p);
  });
  for (int i = 0; i < n; ++i) write_plan(p[i], out + i * kPlanInts);
  *n_launches = n;
  return 0;
}

const char* k4b_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

REPRO_INSTANCE_QUERIES(k4b, kK4bInstances)
