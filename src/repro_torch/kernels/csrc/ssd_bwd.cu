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
//   dcum = rowsum(M) - colsum(M) + C . (e^{cum} S^T dy) - x . (e^{T-cum}
//          dS' B) (+ <dS', S'> at the last step),  M = G D P
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
// What bounds it on this card: the products, 3 TF32 tensor-core products
// each (below), over the causal (t, j) pairs: per chunk and head 2 dh
// multiply-adds a pair (P, dx), per chunk and group 3 ds (G, dB, dC: this
// design computes them once per slice of heads, the bound once per
// group), beside 4 L dh ds per chunk and head for the state terms
// (chip_smoke.py, ssd_bwd_ops); its bytes are the inputs and outputs once.
//
// Products: split TF32 on the tensor cores, mma.sync.m16n8k8 for every
// one of them.  Each f32 operand a is a_hi + a_lo, a_hi = cvt.rna.tf32(a)
// and a_lo = a - a_hi (exact in f32; the tensor core reads its top 19
// bits), and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
// first, accumulated in f32 registers: near f32 accuracy at three TF32
// products each.  This is the kernel's own split, not PyTorch's TF32
// switch (torch.backends.cuda.matmul.allow_tf32 stays False).  Why
// mma.sync and not wgmma: wgmma takes .tf32 operands from shared memory
// only K-major, and dx, dB, dC and U reduce over the chunk's steps, so
// their staged operands (dy, C, B) are MN-major and would need transposed
// copies; wgmma would also need the hi and lo halves staged (twice the
// shared memory of operands that already fill it at ds 128).  With
// mma.sync each thread loads its fragment from padded shared memory,
// splits it in registers, and a product's result (G D, P D) feeds the
// next product as its A fragment without leaving registers (dx from G D).
// G and P would suit wgmma; they are a third of the products and stay on
// mma.sync so that one fragment layout serves all.  The dots of dcum (C .
// dC_t, x . dx_t, <dS', S'>) and D, R, M are CUDA-core f32.
//
// Design: five launches on one stream, no atomics, fixed-order sums, so
// two calls agree bit for bit.  The per-tile passes run one CTA per
// (batch, chunk, slice of at most kMaxSlice heads of one group): B and C
// are staged once per slice, and dB / dC are summed over the slice's heads
// in registers or shared memory, so no per-head (b, s, nh, ds) scratch
// exists; each slice writes one partial dB / dC (b, s, g, slices, ds).
// Each head's operands (x, dy, S, dS', cum) arrive by cp.async into a ring
// of two stages: the next head's load overlaps this head's products.
//
//   1. ssd_bwd_chunk_state_kernel: per head U = (e^{cum} dy)^T C into
//      `dstates` and the entering state's dC, e^{cum} (dy S), with its
//      dcum term C . dC into `dcum`; the slice's sum of that dC stays in
//      registers and is written to the partial dC.
//   2. ssd_bwd_state_pass_kernel, one thread per (batch, head, d, k): from
//      dfinal (or 0), dS' of chunk c is written over U_c, then dS' <- U_c
//      + e^{T_c} dS' for chunk c - 1; 32 chunks' loads at a time.
//   3. ssd_bwd_chunk_kernel, the intra-chunk terms: G = C B^T once for the
//      slice (lower triangle, in shared memory); per head, 16 x 16 (j, t)
//      units at or below the diagonal (units above it are skipped), P^T,
//      D, R = P D, G D and M in registers, dx_j += (G D)^T dy from
//      registers, R summed over the slice's heads into the upper triangle
//      of G's array, M's row and column sums into per-warp dcum rows.
//      Then the slice's dB = R_s^T C and dC += R_s B.  Warps own pairs of
//      j tiles (i, nt - 1 - i), two warps a pair, so each warp has the same
//      number of units at L = 128; the long tile's dx is shared by the two
//      and summed through shared memory in a fixed order.
//   4. ssd_bwd_state_terms_kernel: per head dx += e^{T - cum} (B dS'^T),
//      the slice's dB += (e^{T - cum} x) dS' in registers, dcum's state
//      terms, then da as the reverse cumsum of dcum, summed in f64 as the
//      forward's cumsum.
//   5. ssd_bwd_slice_sum_kernel, one thread per (batch, step, group, k):
//      the slices' partial dB and dC added in slice order.
//
// B, C and the states are staged padded with zeros to DS (8, 16, 32, 64 or
// 128), as in K4.  Shared memory at mamba2's (dh 64, ds 128, L 128):
// 203-208 KB a CTA, one CTA per SM.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "budget.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kTile = 16;       // rows of an mma tile; chunks in 16-row tiles
constexpr int kPad = 4;         // row padding of the staged operands
constexpr int kMaxSlice = 8;    // heads of a CTA's slice, at most
constexpr int kPassBatch = 32;  // chunks the state pass loads at once

// Planted faults, for the checks that must catch them (chip_smoke.py):
// in the third pass every j tile skips its last t tile (the last j tile
// its diagonal one).
constexpr int kFaultDropLastTBlock = 1;

// ---------------------------------------------------------------------------
// Split-TF32 products on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in split TF32, the small terms first.
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma8(d, al, bh[0], bh[1]);
  mma8(d, ah, bl[0], bl[1]);
  mma8(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_q() { return threadIdx.x & 3; }

// The A fragment (16 x 8, rows r, columns k0 ..) of a(r, k), split.
template <typename FA>
__device__ __forceinline__ void load_a(uint32_t (&h)[4], uint32_t (&l)[4],
                                       const FA& a, int k0) {
  const int g = lane_g(), q = lane_q();
  split(a(g, k0 + q), h[0], l[0]);
  split(a(g + 8, k0 + q), h[1], l[1]);
  split(a(g, k0 + q + 4), h[2], l[2]);
  split(a(g + 8, k0 + q + 4), h[3], l[3]);
}

// The B fragment (8 x 8, rows k0 .., columns n0 ..) of b(k, n), split.
template <typename FB>
__device__ __forceinline__ void load_b(uint32_t (&h)[2], uint32_t (&l)[2],
                                       const FB& b, int k0, int n0) {
  const int g = lane_g(), q = lane_q();
  split(b(k0 + q, n0 + g), h[0], l[0]);
  split(b(k0 + q + 4, n0 + g), h[1], l[1]);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
}

// One warp: acc[i] (a 16 x 8 tile at columns n0 + 8 i, i < nn <= NT) +=
// sum over k in [k_begin, k_end) of a(r, k) b(k, n).  Tile i holds (row g,
// column 2q, 2q + 1) in acc[i][0..1] and row g + 8 in acc[i][2..3].
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int k_begin,
                                         int k_end, int n0, int nn,
                                         const FA& a, const FB& b) {
  for (int k0 = k_begin; k0 < k_end; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(ah, al, a, k0);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      if (i < nn) {
        uint32_t bh[2], bl[2];
        load_b(bh, bl, b, k0, n0 + 8 * i);
        mma3(acc[i], ah, al, bh, bl);
      }
    }
  }
}

// As warp_mma over [0, K) into acc = (its 8 columns' tiles at 0 and 8), the
// small terms and a_hi b_hi summed in two accumulators, so each tile has
// two dependent chains in flight, then added: the split's products of a
// short product (two tiles) hide each other's latency.
template <typename FA, typename FB>
__device__ __forceinline__ void warp_mma_2chain(float (&acc)[2][4], int K,
                                                const FA& a, const FB& b) {
  float small[2][4];
  zero(small);
  zero(acc);
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[4], al[4];
    load_a(ah, al, a, k0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t bh[2], bl[2];
      load_b(bh, bl, b, k0, 8 * i);
      mma8(small[i], al, bh[0], bh[1]);
      mma8(small[i], ah, bl[0], bl[1]);
      mma8(acc[i], ah, bh[0], bh[1]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] += small[i][e];
  }
}

// A warp's share of an M x N output (M = 16 nt rows, N = 8 n_tiles
// columns): an m tile and a run of n tiles, warps per m tile as many as
// the warps and the n tiles allow.  Inactive warps take no part.
struct RowSplit {
  bool active;
  int mi, np, n0, ntw, wpm;
};

__device__ __forceinline__ RowSplit row_split(int m_rows, int n_tiles) {
  const int nt = m_rows / kTile, w = threadIdx.x >> 5;
  RowSplit r;
  r.wpm = min(kWarps / nt, n_tiles);
  r.ntw = n_tiles / r.wpm;
  r.active = w < nt * r.wpm;
  r.mi = w / r.wpm;
  r.np = w % r.wpm;
  r.n0 = 8 * r.np * r.ntw;
  return r;
}

// ---------------------------------------------------------------------------
// Staging by cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x W floats into dst (row stride ld): row r is the first `cols`
// floats at src + r * gs, zero from `cols` to W.  16-byte copies where
// the rows allow them, else 4-byte ones.
template <int W>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      size_t gs, int rows, int cols) {
  const bool vec = ((cols | static_cast<int>(gs & 3)) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  if (vec) {
    constexpr int kV = W / 4;
    for (int e = threadIdx.x; e < rows * kV; e += kThreads) {
      const int r = e / kV, k = 4 * (e % kV);
      float* d = dst + r * ld + k;
      if (k < cols) {
        cp_async16(d, src + r * gs + k);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * W; e += kThreads) {
      const int r = e / W, k = e % W;
      float* d = dst + r * ld + k;
      if (k < cols) {
        cp_async4(d, src + r * gs + k);
      } else {
        *d = 0.f;
      }
    }
  }
}

// n floats (n <= kThreads) by 4-byte cp.async.
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int n) {
  if (static_cast<int>(threadIdx.x) < n) cp_async4(dst + threadIdx.x,
                                                   src + threadIdx.x);
}

// ---------------------------------------------------------------------------
// Tiles and reductions
// ---------------------------------------------------------------------------

// The (batch, chunk, group, slice) of a CTA of passes 1, 3 and 4: slices
// innermost, so the CTAs that read one chunk's B and C run together.
struct Slice {
  int bi, c, gi, si, h0, nhs;
  size_t row0;   // first (batch, step) row of the chunk
};

__device__ __forceinline__ Slice slice_of(int s, int nh, int g, int chunk,
                                          int per, int nsl) {
  int idx = blockIdx.x;
  Slice t;
  t.si = idx % nsl;
  idx /= nsl;
  t.gi = idx % g;
  idx /= g;
  const int nc = s / chunk;
  t.c = idx % nc;
  t.bi = idx / nc;
  const int rep = nh / g;
  t.h0 = t.gi * rep + t.si * per;
  t.nhs = min(per, rep - t.si * per);
  t.row0 = static_cast<size_t>(t.bi) * s + static_cast<size_t>(t.c) * chunk;
  return t;
}

// The slice's partial dB / dC row `row` of the chunk: (b, s, g, slices, ds).
__device__ __forceinline__ size_t part_at(const Slice& sl, int row, int g,
                                          int nsl, int ds) {
  return (((sl.row0 + row) * g + sl.gi) * nsl + sl.si) * ds;
}

// Sum of v over the lanes q of a quad group's row (lanes 4g .. 4g + 3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// The sum of v over the CTA, in a fixed order (warps, then warp 0's sums
// in warp order); the result in thread 0.  red holds kWarps floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) out += red[w];
  }
  return out;
}

// ---------------------------------------------------------------------------
// Pass 1: U, the entering state's dC and its dcum term
// ---------------------------------------------------------------------------

template <int DH, int DS>
struct StateLayout {
  static constexpr int kLdY = DH + kPad, kLdS = DS + kPad;
  // One ring stage: dy (L x kLdY), S (DH x kLdS), cum then e^{cum} (L).
  __host__ __device__ static int stage_floats(int L) {
    return L * kLdY + DH * kLdS + L;
  }
  // C (L x kLdS), the row dots (4 x L), the ring.
  __host__ __device__ static size_t floats(int L) {
    return static_cast<size_t>(L) * kLdS + 4 * L + 2 * stage_floats(L);
  }
};

template <int DH, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_state_kernel(const float* __restrict__ dy,
                           const float* __restrict__ cm,
                           const float* __restrict__ cum_in,
                           const float* __restrict__ states,
                           float* __restrict__ dstates,
                           float* __restrict__ dcp, float* __restrict__ dcum,
                           int s, int nh, int g, int ds, int chunk, int per,
                           int nsl) {
  using Lay = StateLayout<DH, DS>;
  constexpr int kLdY = Lay::kLdY, kLdS = Lay::kLdS;
  constexpr int kNt = DS / 8;                       // n tiles of a ds row
  constexpr int kNu = DS / 8 / (kWarps / (DH / kTile) < DS / 8
                                    ? kWarps / (DH / kTile)
                                    : DS / 8);      // U's n tiles a warp
  constexpr int kCh = kNt < 4 ? kNt : 4;            // dC's n tiles at once
  extern __shared__ __align__(16) float smem[];
  const int L = chunk, nc = s / chunk;
  const Slice sl = slice_of(s, nh, g, chunk, per, nsl);
  float* cs = smem;                                 // L x kLdS: C
  float* rowdot = cs + L * kLdS;                    // 4 x L
  float* ring = rowdot + 4 * L;
  const int sf = Lay::stage_floats(L);
  const int g_ = lane_g(), q_ = lane_q();

  auto issue = [&](int i) {
    float* st = ring + (i & 1) * sf;
    const int hh = sl.h0 + i;
    const size_t bh = static_cast<size_t>(sl.bi) * nh + hh;
    stage<DH>(st, kLdY, dy + (sl.row0 * nh + hh) * DH,
              static_cast<size_t>(nh) * DH, L, DH);
    stage<DS>(st + L * kLdY, kLdS,
              states + (bh * nc + sl.c) * DH * ds, ds, DH, ds);
    stage_vec(st + L * kLdY + DH * kLdS,
              cum_in + bh * s + static_cast<size_t>(sl.c) * L, L);
  };
  stage<DS>(cs, kLdS, cm + (sl.row0 * g + sl.gi) * ds,
            static_cast<size_t>(g) * ds, L, ds);
  issue(0);
  cp_async_commit();

  const RowSplit dcs = row_split(L, kNt);           // dC: L x DS
  float acc[kNt][4];
  zero(acc);
  for (int i = 0; i < sl.nhs; ++i) {
    if (i + 1 < sl.nhs) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* ys = ring + (i & 1) * sf;
    const float* ss = ys + L * kLdY;
    float* ec = const_cast<float*>(ss + DH * kLdS);
    if (static_cast<int>(threadIdx.x) < L) ec[threadIdx.x] =
        expf(ec[threadIdx.x]);
    __syncthreads();
    const int hh = sl.h0 + i;
    const size_t bh = static_cast<size_t>(sl.bi) * nh + hh;

    // U (DH x DS) = sum_t (e^{cum_t} dy_t) C_t^T.
    {
      const RowSplit us = row_split(DH, kNt);
      if (us.active) {
        float u[kNu][4];
        zero(u);
        const int m0 = kTile * us.mi;
        warp_mma(u, 0, L, us.n0, us.ntw,
                 [&](int r, int k) { return ys[k * kLdY + m0 + r] * ec[k]; },
                 [&](int k, int n) { return cs[k * kLdS + n]; });
        float* out = dstates + (bh * nc + sl.c) * DH * ds;
#pragma unroll
        for (int t = 0; t < kNu; ++t) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int d = m0 + g_ + 8 * (e >> 1);
            const int k = us.n0 + 8 * t + 2 * q_ + (e & 1);
            if (t < us.ntw && k < ds) out[d * ds + k] = u[t][e];
          }
        }
      }
    }
    // dC_t = e^{cum_t} S^T dy_t into the slice's sum, C_t . dC_t per row.
    if (dcs.active) {
      const int m0 = kTile * dcs.mi;
      float p0 = 0.f, p1 = 0.f;
      const float e0 = ec[m0 + g_], e1 = ec[m0 + g_ + 8];
#pragma unroll
      for (int c0 = 0; c0 < kNt; c0 += kCh) {
        if (c0 < dcs.ntw) {
          const int nn = min(kCh, dcs.ntw - c0);
          float tmp[kCh][4];
          zero(tmp);
          warp_mma(tmp, 0, DH, dcs.n0 + 8 * c0, nn,
                   [&](int r, int k) { return ys[(m0 + r) * kLdY + k]; },
                   [&](int k, int n) { return ss[k * kLdS + n]; });
#pragma unroll
          for (int t = 0; t < kCh; ++t) {
            if (t >= nn) continue;
            const int k = dcs.n0 + 8 * (c0 + t) + 2 * q_;
            const float* c_0 = cs + (m0 + g_) * kLdS + k;
            const float* c_1 = c_0 + 8 * kLdS;
            tmp[t][0] *= e0;
            tmp[t][1] *= e0;
            tmp[t][2] *= e1;
            tmp[t][3] *= e1;
            p0 = fmaf(tmp[t][0], c_0[0], fmaf(tmp[t][1], c_0[1], p0));
            p1 = fmaf(tmp[t][2], c_1[0], fmaf(tmp[t][3], c_1[1], p1));
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c0 + t][e] += tmp[t][e];
          }
        }
      }
      p0 = quad_sum(p0);
      p1 = quad_sum(p1);
      if (q_ == 0) {
        rowdot[dcs.np * L + m0 + g_] = p0;
        rowdot[dcs.np * L + m0 + g_ + 8] = p1;
      }
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < L) {
      float v = 0.f;
      for (int np = 0; np < dcs.wpm; ++np) v += rowdot[np * L + threadIdx.x];
      dcum[bh * s + static_cast<size_t>(sl.c) * L + threadIdx.x] = v;
    }
  }
  if (dcs.active) {
    const int m0 = kTile * dcs.mi;
#pragma unroll
    for (int t = 0; t < kNt; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g_ + 8 * (e >> 1);
        const int k = dcs.n0 + 8 * t + 2 * q_ + (e & 1);
        if (t < dcs.ntw && k < ds) {
          dcp[part_at(sl, row, g, nsl, ds) + k] = acc[t][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: the reverse state pass
// ---------------------------------------------------------------------------

// One thread per (batch * head, e = d * ds + k): from the last chunk, U_c
// is replaced in place by dS' of chunk c, and dS' <- U_c + e^{T_c} dS' is
// carried to the chunk before.
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

// ---------------------------------------------------------------------------
// Pass 3: the intra-chunk terms
// ---------------------------------------------------------------------------

template <int DH, int DS>
struct ChunkLayout {
  static constexpr int kLdX = DH + kPad, kLdS = DS + kPad;
  // One ring stage: x, dy (L x kLdX each), cum (L).
  __host__ __device__ static int stage_floats(int L) {
    return 2 * L * kLdX + L;
  }
  // The ring's region, which also holds B and C (for G and at the end).
  __host__ __device__ static int ring_floats(int L) {
    const int heads = 2 * stage_floats(L), bc = 2 * L * kLdS;
    return heads > bc ? heads : bc;
  }
  // G / R_s (L x (L + kPad)), R_s's diagonal (L), per-warp dcum rows
  // (kWarps x L), the ring.
  __host__ __device__ static size_t floats(int L) {
    return static_cast<size_t>(L) * (L + kPad) + L + kWarps * L +
           ring_floats(L);
  }
};

template <int DH, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ dy,
                     const float* __restrict__ cum_in,
                     float* __restrict__ dx, float* __restrict__ dcum,
                     float* __restrict__ dbp, float* __restrict__ dcp, int s,
                     int nh, int g, int ds, int chunk, int per, int nsl,
                     int fault) {
  using Lay = ChunkLayout<DH, DS>;
  constexpr int kLdX = Lay::kLdX, kLdS = Lay::kLdS;
  constexpr int kNd = DH / 8;                  // n tiles of a dh row
  constexpr int kNt = DS / 8;                  // n tiles of a ds row
  constexpr int kNc = kNt < 8 ? kNt : 8;       // dB / dC n tiles at once
  extern __shared__ __align__(16) float smem[];
  const int L = chunk, nt = L / kTile, ldg = L + kPad;
  const Slice sl = slice_of(s, nh, g, chunk, per, nsl);
  // gr[t][j], t >= j: G; gr[j][t], t > j: R summed over the slice's heads
  // (its diagonal in rd).
  float* gr = smem;
  float* rd = gr + L * ldg;
  float* part = rd + L;                        // kWarps x L: dcum terms
  float* ring = part + kWarps * L;
  const int sf = Lay::stage_floats(L);
  const int g_ = lane_g(), q_ = lane_q(), warp = threadIdx.x >> 5;

  // B and C in the ring's region: G's lower triangle, 16 x 8 tiles.
  float* bs = ring;
  float* cs = ring + L * kLdS;
  auto stage_bc = [&]() {
    stage<DS>(bs, kLdS, bm + (sl.row0 * g + sl.gi) * ds,
              static_cast<size_t>(g) * ds, L, ds);
    stage<DS>(cs, kLdS, cm + (sl.row0 * g + sl.gi) * ds,
              static_cast<size_t>(g) * ds, L, ds);
    cp_async_commit();
  };
  stage_bc();
  for (int e = threadIdx.x; e < L * ldg + L; e += kThreads) gr[e] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  for (int f = warp; f < nt * (nt + 1); f += kWarps) {
    int mt = 0;
    while ((mt + 1) * (mt + 2) <= f) ++mt;
    const int nn = f - mt * (mt + 1);
    float acc[1][4];
    zero(acc);
    const int t0 = kTile * mt;
    warp_mma(acc, 0, DS, 8 * nn, 1,
             [&](int r, int k) { return cs[(t0 + r) * kLdS + k]; },
             [&](int k, int n) { return bs[n * kLdS + k]; });
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = t0 + g_ + 8 * (e >> 1), j = 8 * nn + 2 * q_ + (e & 1);
      if (t >= j) gr[t * ldg + j] = acc[0][e];
    }
  }
  __syncthreads();

  auto issue = [&](int i) {
    float* st = ring + (i & 1) * sf;
    const int hh = sl.h0 + i;
    stage<DH>(st, kLdX, x + (sl.row0 * nh + hh) * DH,
              static_cast<size_t>(nh) * DH, L, DH);
    stage<DH>(st + L * kLdX, kLdX, dy + (sl.row0 * nh + hh) * DH,
              static_cast<size_t>(nh) * DH, L, DH);
    stage_vec(st + 2 * L * kLdX,
              cum_in + (static_cast<size_t>(sl.bi) * nh + hh) * s +
                  static_cast<size_t>(sl.c) * L,
              L);
  };
  issue(0);
  cp_async_commit();

  // Warp pair r: j tiles ja = nt - 1 - r (its r + 1 units, warp A) and
  // jb = r (nt - r units: the first kA warp A's, the rest warp B's).
  const int r = warp >> 1, role = warp & 1;
  const bool has_pair = r < nt / 2;
  const int ja = nt - 1 - r, jb = r, ka = nt / 2 - r - 1;
  const int t_end = (fault & kFaultDropLastTBlock) != 0 ? nt - 1 : nt;
  float* prow = part + warp * L;

  for (int i = 0; i < sl.nhs; ++i) {
    if (i + 1 < sl.nhs) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    for (int e = threadIdx.x & 31; e < L; e += 32) prow[e] = 0.f;
    __syncthreads();
    float* xs = ring + (i & 1) * sf;
    const float* ys = xs + L * kLdX;
    const float* cum = ys + L * kLdX;
    const int hh = sl.h0 + i;

    float dxa[kNd][4], dxb[kNd][4];
    zero(dxa);
    zero(dxb);
    // One 16 x 16 (j, t) unit: P^T, D, R, G D, M; dx_j += (G D)^T dy_t.
    auto unit = [&](int jt, int tt, float (&dxacc)[kNd][4]) {
      const int j0 = kTile * jt, t0 = kTile * tt;
      float p[2][4];
      warp_mma_2chain(p, DH,
                      [&](int rr, int k) { return xs[(j0 + rr) * kLdX + k]; },
                      [&](int k, int n) { return ys[(t0 + n) * kLdX + k]; });
      float csum[2] = {0.f, 0.f}, rsum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = j0 + g_ + 8 * (e >> 1);
          const int t = t0 + 8 * u + 2 * q_ + (e & 1);
          const float z = cum[t] - cum[j];
          const bool causal = t >= j;
          const float d = causal ? __expf(fminf(z, 0.f)) : 0.f;
          const float gv = causal ? gr[t * ldg + j] : 0.f;
          const float rv = p[u][e] * d;
          const float m = causal && z <= 0.f ? gv * rv : 0.f;
          p[u][e] = gv * d;
          if (t > j) {
            gr[j * ldg + t] += rv;
          } else if (t == j) {
            rd[j] += rv;
          }
          csum[e >> 1] += m;
          rsum[u][e & 1] += m;
        }
      }
      // colsum(M) into dcum_j (-), rowsum(M) into dcum_t (+).
      csum[0] = quad_sum(csum[0]);
      csum[1] = quad_sum(csum[1]);
      if (q_ == 0) {
        prow[j0 + g_] -= csum[0];
        prow[j0 + g_ + 8] -= csum[1];
      }
      __syncwarp();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          float v = rsum[u][b];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          rsum[u][b] = v;
        }
      }
      if (g_ == 0) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          prow[t0 + 8 * u + 2 * q_] += rsum[u][0];
          prow[t0 + 8 * u + 2 * q_ + 1] += rsum[u][1];
        }
      }
      __syncwarp();
      // (G D)^T as the A fragment, straight from the C fragments: k slot
      // q is step 2q of the 8, slot q + 4 step 2q + 1, and dy's rows are
      // read in the same order.
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t ah[4], al[4];
        split(p[u][0], ah[0], al[0]);
        split(p[u][2], ah[1], al[1]);
        split(p[u][1], ah[2], al[2]);
        split(p[u][3], ah[3], al[3]);
        const float* y0 = ys + (t0 + 8 * u + 2 * q_) * kLdX + g_;
#pragma unroll
        for (int nd = 0; nd < kNd; ++nd) {
          uint32_t bh[2], bl[2];
          split(y0[8 * nd], bh[0], bl[0]);
          split(y0[kLdX + 8 * nd], bh[1], bl[1]);
          mma3(dxacc[nd], ah, al, bh, bl);
        }
      }
    };
    if (has_pair) {
      if (role == 0) {
        for (int tt = ja; tt < t_end; ++tt) unit(ja, tt, dxa);
      }
      const int tb0 = role == 0 ? jb : jb + ka;
      const int tb1 = role == 0 ? jb + ka : nt;
      for (int tt = tb0; tt < min(tb1, t_end); ++tt) unit(jb, tt, dxb);
    }
    __syncthreads();

    // dx: warp A's tile ja whole, its part of jb through the dead stage.
    auto store_dx = [&](int jt, const float (&acc)[kNd][4], const float* add) {
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = g_ + 8 * hr, col = 8 * nd + 2 * q_;
          float2 v = make_float2(acc[nd][2 * hr], acc[nd][2 * hr + 1]);
          if (add != nullptr) {
            v.x = add[row * DH + col] + v.x;
            v.y = add[row * DH + col + 1] + v.y;
          }
          *reinterpret_cast<float2*>(
              dx + ((sl.row0 + kTile * jt + row) * nh + hh) * DH + col) = v;
        }
      }
    };
    float* slot = xs + r * kTile * DH;
    if (has_pair && role == 0) {
      store_dx(ja, dxa, nullptr);
      if (ka > 0) {
#pragma unroll
        for (int nd = 0; nd < kNd; ++nd) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            slot[(g_ + 8 * (e >> 1)) * DH + 8 * nd + 2 * q_ + (e & 1)] =
                dxb[nd][e];
          }
        }
      }
    }
    if (static_cast<int>(threadIdx.x) < L) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += part[w * L + threadIdx.x];
      dcum[(static_cast<size_t>(sl.bi) * nh + hh) * s +
           static_cast<size_t>(sl.c) * L + threadIdx.x] += v;
    }
    __syncthreads();
    if (has_pair && role == 1) store_dx(jb, dxb, ka > 0 ? slot : nullptr);
    __syncthreads();
  }

  // The slice's dB = R_s^T C and dC += R_s B: unit (row tile i, n run)
  // holds dB's tile i (K over t >= its rows) and dC's tile i (K over j <=
  // its rows), nt + 1 k tiles together.
  stage_bc();
  cp_async_wait<0>();
  __syncthreads();
  auto rsv = [&](int j, int t) {
    return t > j ? gr[j * ldg + t] : t == j ? rd[j] : 0.f;
  };
  const int runs = kNt / kNc;
  for (int un = warp; un < nt * runs; un += kWarps) {
    const int it = un / runs, n0 = 8 * kNc * (un % runs), m0 = kTile * it;
    float acc[kNc][4];
    zero(acc);
    warp_mma(acc, m0, L, n0, kNc,
             [&](int rr, int k) { return rsv(m0 + rr, k); },
             [&](int k, int n) { return cs[k * kLdS + n]; });
#pragma unroll
    for (int t = 0; t < kNc; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g_ + 8 * (e >> 1);
        const int k = n0 + 8 * t + 2 * q_ + (e & 1);
        if (k < ds) dbp[part_at(sl, row, g, nsl, ds) + k] = acc[t][e];
      }
    }
    zero(acc);
    warp_mma(acc, 0, m0 + kTile, n0, kNc,
             [&](int rr, int k) { return rsv(k, m0 + rr); },
             [&](int k, int n) { return bs[k * kLdS + n]; });
#pragma unroll
    for (int t = 0; t < kNc; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g_ + 8 * (e >> 1);
        const int k = n0 + 8 * t + 2 * q_ + (e & 1);
        if (k < ds) dcp[part_at(sl, row, g, nsl, ds) + k] += acc[t][e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 4: the leaving state's terms and da
// ---------------------------------------------------------------------------

template <int DH, int DS>
struct TermsLayout {
  static constexpr int kLdX = DH + kPad, kLdS = DS + kPad;
  // One ring stage: x (L x kLdX), dS' (DH x kLdS), cum (L).
  __host__ __device__ static int stage_floats(int L) {
    return L * kLdX + DH * kLdS + L;
  }
  // f64 warp sums (kMaxChunk / 32, as floats), B (L x kLdS), the row dots
  // (4 x L), e^{T - cum} (L), dcum (L), the reduction (kWarps), the ring.
  __host__ __device__ static size_t floats(int L) {
    return 2 * (kMaxChunk / 32) + static_cast<size_t>(L) * kLdS + 4 * L +
           2 * L + kWarps + 2 * stage_floats(L);
  }
};

template <int DH, int DS>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_state_terms_kernel(const float* __restrict__ x,
                           const float* __restrict__ bm,
                           const float* __restrict__ cum_in,
                           const float* __restrict__ states,
                           const float* __restrict__ sfin,
                           const float* __restrict__ dstates,
                           const float* __restrict__ dcum_in,
                           float* __restrict__ dx, float* __restrict__ da,
                           float* __restrict__ dbp, int s, int nh, int g,
                           int ds, int chunk, int per, int nsl) {
  using Lay = TermsLayout<DH, DS>;
  constexpr int kLdX = Lay::kLdX, kLdS = Lay::kLdS;
  constexpr int kNd = DH / 8, kNt = DS / 8;
  extern __shared__ __align__(16) float smem[];
  const int L = chunk, nc = s / chunk;
  const Slice sl = slice_of(s, nh, g, chunk, per, nsl);
  double* wsum = reinterpret_cast<double*>(smem);   // kMaxChunk / 32
  float* bs = smem + 2 * (kMaxChunk / 32);          // L x kLdS: B
  float* rowdot = bs + L * kLdS;                    // 4 x L
  float* ws = rowdot + 4 * L;                       // L: e^{T - cum}
  float* dcs = ws + L;                              // L: dcum
  float* red = dcs + L;                             // kWarps
  float* ring = red + kWarps;
  const int sf = Lay::stage_floats(L);
  const int g_ = lane_g(), q_ = lane_q(), tid = threadIdx.x;

  auto issue = [&](int i) {
    float* st = ring + (i & 1) * sf;
    const int hh = sl.h0 + i;
    const size_t bh = static_cast<size_t>(sl.bi) * nh + hh;
    stage<DH>(st, kLdX, x + (sl.row0 * nh + hh) * DH,
              static_cast<size_t>(nh) * DH, L, DH);
    stage<DS>(st + L * kLdX, kLdS, dstates + (bh * nc + sl.c) * DH * ds, ds,
              DH, ds);
    stage_vec(st + L * kLdX + DH * kLdS,
              cum_in + bh * s + static_cast<size_t>(sl.c) * L, L);
  };
  stage<DS>(bs, kLdS, bm + (sl.row0 * g + sl.gi) * ds,
            static_cast<size_t>(g) * ds, L, ds);
  issue(0);
  cp_async_commit();

  const RowSplit xsp = row_split(L, kNd);           // dx's state term
  const RowSplit bsp = row_split(L, kNt);           // dB's
  float dbacc[kNt][4];
  zero(dbacc);
  for (int i = 0; i < sl.nhs; ++i) {
    if (i + 1 < sl.nhs) issue(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = ring + (i & 1) * sf;
    const float* dsn = xs + L * kLdX;
    const float* cum = dsn + DH * kLdS;
    const int hh = sl.h0 + i;
    const size_t bh = static_cast<size_t>(sl.bi) * nh + hh;
    const size_t cbase = bh * s + static_cast<size_t>(sl.c) * L;
    if (tid < L) {
      ws[tid] = expf(cum[L - 1] - cum[tid]);
      dcs[tid] = dcum_in[cbase + tid];
    }
    // <dS', S'>, S' the state leaving the chunk.
    const float* sn = sl.c + 1 < nc ? states + (bh * nc + sl.c + 1) * DH * ds
                                    : sfin + bh * DH * ds;
    float part = 0.f;
    for (int e = tid; e < DH * DS; e += kThreads) {
      const int d = e / DS, k = e % DS;
      if (k < ds) part = fmaf(dsn[d * kLdS + k], sn[d * ds + k], part);
    }
    part = block_sum(part, red);   // syncs: ws and dcs are complete after
    if (tid == 0) dcs[L - 1] += part;

    // dx += e^{T - cum_j} dS' B_j, and x_j . that for dcum.
    if (xsp.active) {
      const int m0 = kTile * xsp.mi;
      // dx's values so far, loaded before the product hides their latency.
      float2 old[kNd][2];
#pragma unroll
      for (int t = 0; t < kNd; ++t) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (t < xsp.ntw) {
            old[t][hr] = *reinterpret_cast<const float2*>(
                dx + ((sl.row0 + m0 + g_ + 8 * hr) * nh + hh) * DH +
                xsp.n0 + 8 * t + 2 * q_);
          }
        }
      }
      float acc[kNd][4];
      zero(acc);
      warp_mma(acc, 0, DS, xsp.n0, xsp.ntw,
               [&](int r, int k) { return bs[(m0 + r) * kLdS + k]; },
               [&](int k, int n) { return dsn[n * kLdS + k]; });
      const float w0 = ws[m0 + g_], w1 = ws[m0 + g_ + 8];
      float p0 = 0.f, p1 = 0.f;
#pragma unroll
      for (int t = 0; t < kNd; ++t) {
        if (t < xsp.ntw) {
#pragma unroll
          for (int hr = 0; hr < 2; ++hr) {
            const int row = m0 + g_ + 8 * hr;
            const int col = xsp.n0 + 8 * t + 2 * q_;
            const float w = hr == 0 ? w0 : w1;
            const float v0 = acc[t][2 * hr] * w, v1 = acc[t][2 * hr + 1] * w;
            const float* xr = xs + row * kLdX + col;
            const float dot = fmaf(v0, xr[0], v1 * xr[1]);
            if (hr == 0) {
              p0 += dot;
            } else {
              p1 += dot;
            }
            *reinterpret_cast<float2*>(
                dx + ((sl.row0 + row) * nh + hh) * DH + col) =
                make_float2(old[t][hr].x + v0, old[t][hr].y + v1);
          }
        }
      }
      p0 = quad_sum(p0);
      p1 = quad_sum(p1);
      if (q_ == 0) {
        rowdot[xsp.np * L + m0 + g_] = p0;
        rowdot[xsp.np * L + m0 + g_ + 8] = p1;
      }
    }
    // The slice's dB += (e^{T - cum_j} x_j) dS'.
    if (bsp.active) {
      const int m0 = kTile * bsp.mi;
      warp_mma(dbacc, 0, DH, bsp.n0, bsp.ntw,
               [&](int r, int k) {
                 return xs[(m0 + r) * kLdX + k] * ws[m0 + r];
               },
               [&](int k, int n) { return dsn[k * kLdS + n]; });
    }
    __syncthreads();

    // da_t = sum_{t' >= t} dcum_t': an inclusive scan of the reversed
    // steps, a shuffle scan over 32 per warp, then the warps before, in
    // f64.
    const int lane = tid & 31, warp = tid >> 5;
    const int t = L - 1 - tid;
    double v = 0.0;
    if (tid < L) {
      float dc = dcs[t];
      for (int np = 0; np < xsp.wpm; ++np) dc -= rowdot[np * L + t];
      v = static_cast<double>(dc);
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += o;
    }
    if (lane == 31 && tid < L) wsum[warp] = v;
    __syncthreads();
    if (tid < L) {
      for (int w2 = 0; w2 < warp; ++w2) v += wsum[w2];
      da[(sl.row0 + t) * nh + hh] = static_cast<float>(v);
    }
    __syncthreads();
  }
  if (bsp.active) {
    const int m0 = kTile * bsp.mi;
#pragma unroll
    for (int t = 0; t < kNt; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + g_ + 8 * (e >> 1);
        const int k = bsp.n0 + 8 * t + 2 * q_ + (e & 1);
        if (t < bsp.ntw && k < ds) {
          dbp[part_at(sl, row, g, nsl, ds) + k] += dbacc[t][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 5: the slices' partial dB and dC summed
// ---------------------------------------------------------------------------

// One thread per (batch, step, group, k), slices added in slice order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_slice_sum_kernel(const float* __restrict__ dbp,
                         const float* __restrict__ dcp, float* __restrict__ db,
                         float* __restrict__ dc, long long n, int nsl, int ds) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                        threadIdx.x;
  if (idx >= n) return;
  const long long k = idx % ds, rest = idx / ds;   // rest: row * g + group
  const size_t base = static_cast<size_t>(rest) * nsl * ds + k;
  float sb = dbp[base], sc = dcp[base];
  for (int i = 1; i < nsl; ++i) {
    sb += dbp[base + static_cast<size_t>(i) * ds];
    sc += dcp[base + static_cast<size_t>(i) * ds];
  }
  db[idx] = sb;
  dc[idx] = sc;
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Instances: passes 1, 3 and 4, each at dh 16 then 64 and ds 8, 16, 32,
// 64, 128; then the state pass and the slice sum.
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
    K4B_WIDTHS(ssd_bwd_state_terms_kernel, 16),
    K4B_WIDTHS(ssd_bwd_state_terms_kernel, 64),
    {reinterpret_cast<const void*>(ssd_bwd_state_pass_kernel),
     "ssd_bwd_state_pass_kernel"},
    {reinterpret_cast<const void*>(ssd_bwd_slice_sum_kernel),
     "ssd_bwd_slice_sum_kernel"},
};
#undef K4B_WIDTHS
#undef K4B_INSTANCE

template <int DH, int DS>
constexpr int width_index() {
  return (DH == 16 ? 0 : kDsWidths) +
         (DS == 8 ? 0 : DS == 16 ? 1 : DS == 32 ? 2 : DS == 64 ? 3 : 4);
}

// A group of `rep` heads in slices: the fewest of at most kMaxSlice heads,
// every one full but the last (ref.ssd_bwd_slices).
void slices(int rep, int* per, int* nsl) {
  const int n = (rep + kMaxSlice - 1) / kMaxSlice;
  *per = (rep + n - 1) / n;
  *nsl = (rep + *per - 1) / *per;
}

constexpr int kLaunches = 5;

// The launches of a call (the first `stop` of them when 0 < stop < 5):
// chunk states, state pass, chunk, state terms, slice sum.
template <int DH, int DS>
int plan(int b, int s, int nh, int g, int ds, int chunk, int stop,
         LaunchPlan* out) {
  int per = 0, nsl = 0;
  slices(nh / g, &per, &nsl);
  const int ctas = b * (s / chunk) * g * nsl;
  const long long n_state = static_cast<long long>(b) * nh * DH * ds;
  const long long n_sum = static_cast<long long>(b) * s * g * ds;
  const dim3 blk(kThreads);
  out[0] = LaunchPlan{width_index<DH, DS>(), dim3(ctas), blk,
                      sizeof(float) * StateLayout<DH, DS>::floats(chunk)};
  out[1] = LaunchPlan{6 * kDsWidths,
                      dim3(static_cast<int>((n_state + kThreads - 1) /
                                            kThreads)),
                      blk, 0};
  out[2] = LaunchPlan{2 * kDsWidths + width_index<DH, DS>(), dim3(ctas), blk,
                      sizeof(float) * ChunkLayout<DH, DS>::floats(chunk)};
  out[3] = LaunchPlan{4 * kDsWidths + width_index<DH, DS>(), dim3(ctas), blk,
                      sizeof(float) * TermsLayout<DH, DS>::floats(chunk)};
  out[4] = LaunchPlan{6 * kDsWidths + 1,
                      dim3(static_cast<int>((n_sum + kThreads - 1) /
                                            kThreads)),
                      blk, 0};
  return stop > 0 && stop < kLaunches ? stop : kLaunches;
}

struct Args {
  const float *x, *bm, *cm, *dy, *cum, *states, *sfin, *dfinal;
  float *dx, *da, *db, *dc, *dstates, *dbp, *dcp, *dcum;
  int b, s, nh, g, ds, chunk, stop, fault;
};

template <int DH, int DS>
int launch(const Args& a, cudaStream_t stream) {
  const int nc = a.s / a.chunk;
  int per = 0, nsl = 0;
  slices(a.nh / a.g, &per, &nsl);
  LaunchPlan p[kLaunches];
  const int n = plan<DH, DS>(a.b, a.s, a.nh, a.g, a.ds, a.chunk, a.stop, p);
  cudaError_t err = allow_smem(ssd_bwd_chunk_state_kernel<DH, DS>, p[0].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_state_kernel<DH, DS>
      <<<p[0].grid, p[0].block, p[0].smem, stream>>>(
          a.dy, a.cm, a.cum, a.states, a.dstates, a.dcp, a.dcum, a.s, a.nh,
          a.g, a.ds, a.chunk, per, nsl);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 1) return static_cast<int>(err);

  ssd_bwd_state_pass_kernel<<<p[1].grid, p[1].block, p[1].smem, stream>>>(
      a.cum, a.dstates, a.dfinal, a.b * a.nh, nc, a.s, a.chunk, DH * a.ds);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 2) return static_cast<int>(err);

  err = allow_smem(ssd_bwd_chunk_kernel<DH, DS>, p[2].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk_kernel<DH, DS><<<p[2].grid, p[2].block, p[2].smem, stream>>>(
      a.x, a.bm, a.cm, a.dy, a.cum, a.dx, a.dcum, a.dbp, a.dcp, a.s, a.nh,
      a.g, a.ds, a.chunk, per, nsl, a.fault);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 3) return static_cast<int>(err);

  err = allow_smem(ssd_bwd_state_terms_kernel<DH, DS>, p[3].smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state_terms_kernel<DH, DS>
      <<<p[3].grid, p[3].block, p[3].smem, stream>>>(
          a.x, a.bm, a.cum, a.states, a.sfin, a.dstates, a.dcum, a.dx, a.da,
          a.dbp, a.s, a.nh, a.g, a.ds, a.chunk, per, nsl);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 4) return static_cast<int>(err);

  ssd_bwd_slice_sum_kernel<<<p[4].grid, p[4].block, p[4].smem, stream>>>(
      a.dbp, a.dcp, a.db, a.dc,
      static_cast<long long>(a.b) * a.s * a.g * a.ds, nsl, a.ds);
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
         chunk % 32 != 0 || chunk > kMaxChunk || s <= 0 || s % chunk != 0;
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K4-bwd on `stream`: five kernels (chunk states, state pass,
// chunk, state terms, slice sum); 0 < `stop` < 5 stops after that many
// (to check each pass alone: later passes update the scratch in place).
// x and dy (b, s, nh, dh), bm and cm (b, s, g, ds), the forward's cum (b,
// nh, s), states (b, nh, s / chunk, dh, ds: the state entering each chunk)
// and sfin (b, nh, dh, ds), dfinal like sfin or null (zero); out: dx like
// x, da (b, s, nh), db and dc like bm; scratch: dstates like states, dbp
// and dcp (b, s, g, slices, ds: k4b_slices), dcum (b, nh, s).  All
// contiguous f32 on the device, x and dy 16-byte aligned.  dh in {16,
// 64}, 1 <= ds <= 128, nh % g == 0, chunk a multiple of 32 up to 128
// dividing s.  After the call, dstates holds each chunk's U (stop 1) or
// else the gradient into the state leaving it, dcp and dbp the slices'
// partial dC and dB, dcum each pass's terms so far.  `fault` plants a
// fault for the checks that must catch it (kFaultDropLastTBlock); 0
// otherwise.  Returns the first launch error (0 on success).
int k4b_ssd_scan_bwd(const float* x, const float* bm, const float* cm,
                     const float* dy, const float* cum, const float* states,
                     const float* sfin, const float* dfinal, float* dx,
                     float* da, float* db, float* dc, float* dstates,
                     float* dbp, float* dcp, float* dcum, int b, int s,
                     int nh, int g, int dh, int ds, int chunk, int stop,
                     int fault, void* stream) {
  using namespace repro_torch;
  if (b <= 0 || nh <= 0) return 0;
  if (bad_shape(g, nh, ds, chunk, s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args args{x,  bm, cm, dy, cum, states, sfin, dfinal,
                  dx, da, db, dc, dstates, dbp, dcp, dcum,
                  b,  s,  nh, g,  ds,  chunk,  stop, fault};
  auto st = static_cast<cudaStream_t>(stream);
  return with_shape(dh, ds, [&](auto d, auto w) {
    return launch<decltype(d)::value, decltype(w)::value>(args, st);
  });
}

// The launches k4b_ssd_scan_bwd makes for these shapes (none, or `stop`
// or five), as kPlanInts ints each; budget.cuh says what they hold.
int k4b_plan(int b, int s, int nh, int g, int dh, int ds, int chunk,
             int stop, int* out, int* n_launches) {
  using namespace repro_torch;
  *n_launches = 0;
  if (b <= 0 || nh <= 0) return 0;
  if (bad_shape(g, nh, ds, chunk, s) || (dh != 16 && dh != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchPlan p[kLaunches];
  const int n = with_shape(dh, ds, [&](auto d, auto w) {
    return plan<decltype(d)::value, decltype(w)::value>(b, s, nh, g, ds,
                                                        chunk, stop, p);
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
