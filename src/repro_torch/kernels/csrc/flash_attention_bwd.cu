// K3-bwd: the gradient of K3 (online-softmax GQA attention) in q, k and v.
//
// Replaces no TPU kernel: the reference differentiates its jnp attention
// (repro/models/attention.py, attend_scan / attend_full) and has no
// custom_vjp around its Pallas kernel.  It is added because the port's
// training path runs K3 on the card, and a kernel launched through ctypes
// has no gradient of its own (kernels/ops.py FlashAttention calls this
// from its backward).  Its plain twin is kernels/ref.py
// flash_attention_bwd, written out kv block by kv block as here.
//
// For q (b, hq, sq, dh), k, v (b, hkv, skv, dh), the forward's output o
// and row log-sum-exp lse (b, hq, sq, f32), and dO like o, with scale =
// 1/sqrt(dh) and the forward's mask (kpos < skv, causal: kpos <= qpos,
// window: kpos > qpos - window, qpos = row + q_offset):
//
//   D = rowsum(dO * O);  P = exp(scale q k^T - lse) on visible pairs, else 0;
//   dP = dO v^T;  dS = P * (dP - D);
//   dV = sum over the kv head's q heads of P^T dO;
//   dK = scale * sum over the kv head's q heads of dS^T q;
//   dQ = scale * dS k.
//
// What bounds it on this card: 10 dh operations per visible (query, key)
// pair and q head (five products of dh multiply-adds), far above the
// bytes of the eight tensors, so the bound is the operations over the
// tensor-core peak (bf16).  No atomics, so the result is the same bit for
// bit on every run.  Without atomics dQ needs its own pass, which
// recomputes S and dP: the kernels do 14 dh operations per pair, so their
// ceiling is 10/14 of the bound.
//
// bf16, the tensor-core design (TMA + mbarrier ring + wgmma, the helpers
// and atom plan of hopper.cuh), three launches (four with a split group):
//
// 1. bwd_prep_kernel: one warp per query row, f32: D, and lse * log2(e),
//    into a scratch padded to 64-row q blocks, each block's 64 lse values
//    then its 64 D values (512 B, one bulk copy for the kernels below);
//    rows past sq hold zeros.
// 2. bwd_dkv_wgmma_kernel: one CTA of 384 threads per (batch * kv head,
//    128 keys): two consumer warpgroups of 64 keys each and a producer
//    warpgroup whose first thread issues every TMA load.  The producer
//    loads the CTA's k and v tiles once, then streams a ring of kTcStages
//    stages of (q, dO, lse / D) for each q head of the group and each
//    64-row q block that can see the CTA's keys (the forward's block skip
//    rule, live_kv).  A consumer computes S^T = k q^T and dP^T = v dO^T
//    with wgmma m64n64k16 (both operands in shared memory, K-major), P^T =
//    exp2(S^T scale log2(e) - lse log2(e)) and dS^T = P^T (dP^T - D) on the
//    accumulator fragments (masked only in blocks an edge cuts), rounds
//    both to bf16 in registers, where the f32 fragment layout is already
//    the A-operand layout, and accumulates dV += P^T dO and dK += dS^T q
//    with wgmma m64n{dh}k16 (A from registers, dO and q read MN-major, as
//    the forward reads v).  dK and dV stay in f32 registers (dh of them
//    per thread) and are stored once in bf16; the producer warpgroup hands
//    registers to the consumers (setmaxnreg 24 / 240).  At dh 128 that is
//    still short of S^T and dP^T side by side: there the consumer keeps
//    P^T in bf16 only, issues dV's product beside dP^T's and forms dS^T
//    from the rounded P^T (no spill).
//    When b * hkv * (128-key blocks) CTAs would not fill two waves of the
//    card (MQA, small batches), the group's q heads are split over
//    grid.z: each split stores its partial dK / dV in f32 and
//    2b. bwd_dkv_sum_kernel adds them in split order.
// 3. bwd_dq_wgmma_kernel: the forward's shape: one CTA of 288 threads per
//    (batch * q head, 128 query rows), two consumer warpgroups of 64 rows
//    and a producer warp; q and dO load once, k and v stream through the
//    ring.  A consumer computes S = q k^T and dP = dO v^T (shared-memory
//    operands), dS on the fragments, and dQ += dS k (A from registers, k
//    read MN-major).  Heavy (late) causal q blocks run first.
//
// f32 keeps the first design, IEEE f32 on the CUDA cores (no TF32), three
// launches: bwd_dot_kernel (D, a warp per row), bwd_dkv_kernel (a CTA of 256 threads
// per (batch * kv head, 64 keys) over the group's q blocks) and
// bwd_dq_kernel (per (batch * q head, 64 rows)).  Thread (ty, tx) of a
// 16 x 16 layout computes S and dP for 4 rows x 4 columns of a 64 x 64
// tile staged in shared memory (rows padded by one float, so column reads
// hit distinct banks) and accumulates its dims tx + 16c in registers.
//
// Rows past sq and keys past skv are loaded as zeros and masked.  A row
// that sees no key has lse = -inf and every P = 0 (selected, never
// multiplied), so its gradient is 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "budget.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;   // = kernels/ref.py FLASH_BLOCK_K
constexpr int kThreads = 256;
constexpr int kRows = 4;      // rows per thread of a 64 x 64 tile
constexpr int kCols = kBlockK / 16;
constexpr int kLdP = kBlockK + 1;
constexpr int kDotRows = kThreads / 32;   // a warp per row
// The tensor-core kernels.
constexpr int kTcConsumers = 256;                  // two warpgroups
constexpr int kDkvThreads = kTcConsumers + 128;    // + a producer warpgroup
constexpr int kDqThreads = kTcConsumers + 32;      // + a producer warp
constexpr int kTcStages = 2;
constexpr int kLdFloats = 2 * kBlockQ;   // a q block's lse * log2(e), D
// dK / dV CTAs wanted before the group's q heads are split over grid.z:
// two waves of the H100's 132 SMs at one CTA each.
constexpr int kFillCtas = 2 * 132;
// setmaxnreg of the dK / dV kernel: 128 x 24 + 256 x 240 = 64,512, what
// the launch allocates (168 x 384).  Asking for all 65,536 (32 / 240)
// never returns: the consumers' setmaxnreg.inc waits forever.
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

// Planted faults, for the checks that must catch them (chip_smoke.py).
constexpr int kFaultDropLastKvBlock = 1;

constexpr float kLog2e = 1.4426950408889634f;

// The kv blocks [begin, end) that query rows [q_lo, q_hi] (kv positions)
// can see: the forward kernels' skip rule.
struct KvRange {
  int begin, end;
};
__device__ __forceinline__ KvRange live_kv(int q_lo, int q_hi, int skv,
                                           int causal, int window) {
  int end = (skv + kBlockK - 1) / kBlockK;
  if (causal) end = min(end, q_hi < 0 ? 0 : q_hi / kBlockK + 1);
  int begin = 0;
  if (window >= 0) {
    const int t = q_lo - window - (kBlockK - 1);   // need k_lo > t
    begin = t < 0 ? 0 : t / kBlockK + 1;
  }
  return KvRange{begin, end};
}

// live_kv of the 64-row q block qb.
__device__ __forceinline__ KvRange q_block_live(int qb, int sq, int skv,
                                                int causal, int window,
                                                int q_offset) {
  const int q0 = qb * kBlockQ;
  return live_kv(q0 + q_offset, min(q0 + kBlockQ, sq) - 1 + q_offset, skv,
                 causal, window);
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int skv,
                                        int causal, int window) {
  return kpos < skv && (!causal || kpos <= qpos) &&
         (window < 0 || kpos > qpos - window);
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernels
// ---------------------------------------------------------------------------

// Dynamic shared memory in floats: four (64, DH + 1) tiles (k, v, q, dO),
// the (64, 65) tiles of P^T and dS^T (dK / dV) or of dS (dQ), and lse and
// D of 64 rows.
template <int DH>
constexpr size_t dkv_smem_floats() {
  return 4 * kBlockQ * (DH + 1) + 2 * kBlockK * kLdP + 2 * kBlockQ;
}
template <int DH>
constexpr size_t dq_smem_floats() {
  return 4 * kBlockQ * (DH + 1) + kBlockQ * kLdP + 2 * kBlockQ;
}

// D = rowsum(dO * O), a warp per row.
__global__ void __launch_bounds__(kThreads)
bwd_dot_kernel(const float* __restrict__ o, const float* __restrict__ d_o,
               float* __restrict__ dd, int rows, int dh) {
  const int row = blockIdx.x * kDotRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * dh;
  float s = 0.f;
  for (int c = lane; c < dh; c += 32) s = fmaf(d_o[base + c], o[base + c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dd[row] = s;
}

// Stage rows [r0, r0 + 64) of a (rows, DH) slab into a (64, DH + 1) tile,
// zeros past `rows`.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src, int r0,
                                      int rows) {
  constexpr int kLd = DH + 1;
  for (int e = threadIdx.x; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * kLd + c] =
        r0 + r < rows ? src[static_cast<size_t>(r0 + r) * DH + c] : 0.f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ dd, const float* __restrict__ d_o,
               float* __restrict__ dk, float* __restrict__ dv, int group,
               int sq, int skv, int causal, int window, int q_offset,
               float scale, int fault) {
  constexpr int kLd = DH + 1;
  constexpr int kDims = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;                    // kBlockK x kLd
  float* vs = ks + kBlockK * kLd;      // kBlockK x kLd
  float* qs = vs + kBlockK * kLd;      // kBlockQ x kLd
  float* dos = qs + kBlockQ * kLd;     // kBlockQ x kLd
  float* pt = dos + kBlockQ * kLd;     // kBlockK x kLdP, P^T
  float* dst = pt + kBlockK * kLdP;    // kBlockK x kLdP, dS^T
  float* lse_s = dst + kBlockK * kLdP; // kBlockQ
  float* dd_s = lse_s + kBlockQ;       // kBlockQ

  const int kb = blockIdx.x;
  const int bkv = blockIdx.y;          // batch * hkv + kv head
  const int k_lo = kb * kBlockK;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const size_t kv_off = static_cast<size_t>(bkv) * skv * DH;
  stage<DH>(ks, k + kv_off, k_lo, skv);
  stage<DH>(vs, v + kv_off, k_lo, skv);

  float dk_acc[kRows][kDims], dv_acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDims; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;    // batch * hq + q head
    const size_t q_off = static_cast<size_t>(bh) * sq;
    for (int qb = 0; qb < n_qb; ++qb) {
      const int q0 = qb * kBlockQ;
      const KvRange live = q_block_live(qb, sq, skv, causal, window, q_offset);
      if (kb < live.begin || kb >= live.end) continue;
      if ((fault & kFaultDropLastKvBlock) && kb == live.end - 1) continue;

      __syncthreads();   // the previous q block's reads are done
      stage<DH>(qs, q + q_off * DH, q0, sq);
      stage<DH>(dos, d_o + q_off * DH, q0, sq);
      if (tid < kBlockQ) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lse[q_off + q0 + tid] : 0.f;
        dd_s[tid] = in ? dd[q_off + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T for keys 4ty + r, queries tx + 16j.
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float kv_k[kRows], kv_v[kRows], qv[kCols], dov[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          kv_k[r] = ks[(ty * kRows + r) * kLd + d];
          kv_v[r] = vs[(ty * kRows + r) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qv[j] = qs[(tx + 16 * j) * kLd + d];
          dov[j] = dos[(tx + 16 * j) * kLd + d];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[r][j] = fmaf(kv_k[r], qv[j], s[r][j]);
            dp[r][j] = fmaf(kv_v[r], dov[j], dp[r][j]);
          }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = ty * kRows + r;
        const int kpos = k_lo + key;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int qi = tx + 16 * j;
          const bool ok = q0 + qi < sq &&
                          visible(q0 + qi + q_offset, kpos, skv, causal,
                                  window);
          const float p = ok ? expf(s[r][j] * scale - lse_s[qi]) : 0.f;
          pt[key * kLdP + qi] = p;
          dst[key * kLdP + qi] = p * (dp[r][j] - dd_s[qi]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T q for keys 4ty + r, dims tx + 16c.
#pragma unroll 4
      for (int j = 0; j < kBlockQ; ++j) {
        float pv[kRows], sv[kRows], dov[kDims], qv[kDims];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          pv[r] = pt[(ty * kRows + r) * kLdP + j];
          sv[r] = dst[(ty * kRows + r) * kLdP + j];
        }
#pragma unroll
        for (int c = 0; c < kDims; ++c) {
          dov[c] = dos[j * kLd + tx + 16 * c];
          qv[c] = qs[j * kLd + tx + 16 * c];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kDims; ++c) {
            dv_acc[r][c] = fmaf(pv[r], dov[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(sv[r], qv[c], dk_acc[r][c]);
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k_lo + ty * kRows + r;
    if (key >= skv) break;
#pragma unroll
    for (int c = 0; c < kDims; ++c) {
      const size_t at = kv_off + static_cast<size_t>(key) * DH + tx + 16 * c;
      dk[at] = dk_acc[r][c] * scale;
      dv[at] = dv_acc[r][c];
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ lse,
              const float* __restrict__ dd, const float* __restrict__ d_o,
              float* __restrict__ dq, int group, int sq, int skv, int causal,
              int window, int q_offset, float scale, int fault) {
  constexpr int kLd = DH + 1;
  constexpr int kDims = DH / 16;
  extern __shared__ float smem[];
  float* ks = smem;                    // kBlockK x kLd
  float* vs = ks + kBlockK * kLd;      // kBlockK x kLd
  float* qs = vs + kBlockK * kLd;      // kBlockQ x kLd
  float* dos = qs + kBlockQ * kLd;     // kBlockQ x kLd
  float* ds = dos + kBlockQ * kLd;     // kBlockQ x kLdP, dS
  float* lse_s = ds + kBlockQ * kLdP; // kBlockQ
  float* dd_s = lse_s + kBlockQ;       // kBlockQ

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;           // batch * hq + q head
  const int bkv = bh / group;
  const size_t q_off = static_cast<size_t>(bh) * sq;
  const size_t kv_off = static_cast<size_t>(bkv) * skv * DH;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  stage<DH>(qs, q + q_off * DH, q0, sq);
  stage<DH>(dos, d_o + q_off * DH, q0, sq);
  if (tid < kBlockQ) {
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse[q_off + q0 + tid] : 0.f;
    dd_s[tid] = in ? dd[q_off + q0 + tid] : 0.f;
  }

  float acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;

  KvRange live = q_block_live(blockIdx.x, sq, skv, causal, window, q_offset);
  if (fault & kFaultDropLastKvBlock) live.end -= 1;
  for (int kb = live.begin; kb < live.end; ++kb) {
    const int k_lo = kb * kBlockK;
    __syncthreads();   // the previous block's reads of ks / vs / ds are done
    stage<DH>(ks, k + kv_off, k_lo, skv);
    stage<DH>(vs, v + kv_off, k_lo, skv);
    __syncthreads();

    // S and dP for rows 4ty + r, keys tx + 16j.
    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], dov[kRows], kv_k[kCols], kv_v[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = qs[(ty * kRows + r) * kLd + d];
        dov[r] = dos[(ty * kRows + r) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kv_k[j] = ks[(tx + 16 * j) * kLd + d];
        kv_v[j] = vs[(tx + 16 * j) * kLd + d];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[r][j] = fmaf(qv[r], kv_k[j], s[r][j]);
          dp[r][j] = fmaf(dov[r], kv_v[j], dp[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = ty * kRows + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const bool ok = q0 + qi < sq &&
                        visible(q0 + qi + q_offset, k_lo + tx + 16 * j, skv,
                                causal, window);
        const float p = ok ? expf(s[r][j] * scale - lse_s[qi]) : 0.f;
        ds[qi * kLdP + tx + 16 * j] = p * (dp[r][j] - dd_s[qi]);
      }
    }
    __syncthreads();

    // dQ += dS k for rows 4ty + r, dims tx + 16c.
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float sv[kRows], kv_k[kDims];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sv[r] = ds[(ty * kRows + r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kDims; ++c) kv_k[c] = ks[j * kLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kDims; ++c)
          acc[r][c] = fmaf(sv[r], kv_k[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row >= sq) break;
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      dq[(q_off + row) * DH + tx + 16 * c] = acc[r][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

// 1. D and lse * log2(e) per row into the padded scratch `ld`: q block qb
// of head bh at ld + (bh * n_qb + qb) * kLdFloats, its lse values then its
// D values; rows past sq hold zeros.  One warp per padded row.
__global__ void __launch_bounds__(kThreads)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ d_o,
                const float* __restrict__ lse, float* __restrict__ ld,
                int rows_pad, int sq, int n_qb, int dh) {
  const int r = blockIdx.x * kDotRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows_pad) return;
  const int bh = r / (n_qb * kBlockQ);
  const int row = r % (n_qb * kBlockQ);
  float s = 0.f, l = 0.f;
  if (row < sq) {
    const size_t at = static_cast<size_t>(bh) * sq + row;
    const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(o + at * dh);
    const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(d_o + at * dh);
    for (int c = lane; c < dh / 2; c += 32) {
      const float2 a = __bfloat1622float2(d2[c]);
      const float2 b = __bfloat1622float2(o2[c]);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    l = lse[at] * kLog2e;
  }
  if (lane == 0) {
    float* blk = ld + (static_cast<size_t>(bh) * n_qb + row / kBlockQ) *
                          kLdFloats;
    blk[row % kBlockQ] = l;
    blk[kBlockQ + row % kBlockQ] = s;
  }
}

// Shared memory of the tensor-core kernels: 64-row bf16 tiles in the atom
// plan (atom a of a tile at a * 64 * kRowBytes), each 1024 B aligned.
template <int DH>
struct BwdLayout : AtomPlan<DH> {
  static constexpr int kTile = kBlockQ * DH * 2;   // 64 rows x DH bf16
  // k, v (two tiles each), then kTcStages stages of q, dO and lse / D.
  static constexpr int kDkvSmem = 1024 /* alignment slack */ + 4 * kTile +
                                  kTcStages * (2 * kTile + 4 * kLdFloats) +
                                  64 /* barriers */;
  // q, dO (two tiles each), then kTcStages stages of k and v.
  static constexpr int kDqSmem = 1024 + 4 * kTile + kTcStages * 2 * kTile + 64;
};

// Descriptor of k-step kk (16 columns) of a 64-row tile read K-major (rows
// are M or N, dh is K): an A or B operand of S = x y^T.
template <int DH>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int kk) {
  using A = AtomPlan<DH>;
  const int a = (kk * 16) / A::kAtomCols;
  const int cb = ((kk * 16) % A::kAtomCols) * 2;
  return gmma_desc(tile + a * kBlockQ * A::kRowBytes + cb, 16,
                   8 * A::kRowBytes, A::kLayoutType);
}

// Descriptor of k-step kk (16 rows) of a 64-row tile read MN-major (rows
// are K, dh is N): the B operand of x += P y.  8-row groups 8 * kRowBytes
// apart, dh atoms 64 * kRowBytes apart.
template <int DH>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk) {
  using A = AtomPlan<DH>;
  return gmma_desc(tile + kk * 16 * A::kRowBytes, kBlockQ * A::kRowBytes,
                   8 * A::kRowBytes, A::kLayoutType);
}

// d (64 x 64) = x y^T over dh, both 64-row tiles in shared memory.
// kRolled keeps the k-loop rolled, so that its descriptors are computed
// one step at a time rather than all held in registers across the loop
// that calls it.
template <int DH, bool kRolled = false>
__device__ __forceinline__ void mma_xyt(float (&d)[32], const uint8_t* x,
                                        const uint8_t* y) {
  if constexpr (kRolled) {
#pragma unroll 1
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(d, desc_k<DH>(x, kk), desc_k<DH>(y, kk), kk > 0 ? 1 : 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(d, desc_k<DH>(x, kk), desc_k<DH>(y, kk), kk > 0 ? 1 : 0);
  }
}

// acc (64 x DH) += a (64 x 64 keys or queries, bf16 fragments) y (64 x DH
// tile in shared memory).
template <int DH>
__device__ __forceinline__ void mma_ay(float (&acc)[DH / 2],
                                       const uint32_t (&a)[4][4],
                                       const uint8_t* y) {
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk)
    wgmma_rs<DH>(acc, a[kk], desc_mn<DH>(y, kk));
}

// Store a 64 x DH accumulator times `mul` in bf16: rows row_a, row_a + 8
// of each 16-row slab (the fragment layout), those below `rows` only.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           const float (&acc)[DH / 2],
                                           int row_a, int rows, int col0,
                                           float mul) {
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = row_a + (((i / 2) % 2) ? 8 : 0);
    if (row < rows) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<size_t>(row) * DH + 8 * (i / 4) + col0) =
          __floats2bfloat162_rn(acc[i] * mul, acc[i + 1] * mul);
    }
  }
}

// The same rows of a 64 x DH accumulator, unscaled, in f32.
template <int DH>
__device__ __forceinline__ void store_rows_f32(float* out,
                                               const float (&acc)[DH / 2],
                                               int row_a, int rows,
                                               int col0) {
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const int row = row_a + (((i / 2) % 2) ? 8 : 0);
    if (row < rows) {
      *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * DH +
                                 8 * (i / 4) + col0) =
          make_float2(acc[i], acc[i + 1]);
    }
  }
}

// Accumulator fragment of a 64 x N wgmma tile (f32) in thread `t` of the
// warpgroup: register i holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (t % 4) + i % 2.  In this kernel rows are keys
// and columns queries.
template <int DH>
__global__ void __launch_bounds__(kDkvThreads, 1)
bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ ld,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv,
                     float* __restrict__ part, int group, int per_split,
                     int sq, int skv, int causal, int window, int q_offset,
                     float scale, float scale_log2, int fault) {
  using L = BwdLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  // TMA swizzle atoms must start at 1024 B (128 B swizzle) boundaries.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ks = smem;                               // 2 tiles
  uint8_t* vs = ks + 2 * L::kTile;                  // 2 tiles
  uint8_t* qs = vs + 2 * L::kTile;                  // kTcStages tiles
  uint8_t* dos = qs + kTcStages * L::kTile;         // kTcStages tiles
  float* lds = reinterpret_cast<float*>(dos + kTcStages * L::kTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(lds + kTcStages * kLdFloats);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                        // kTcStages
  uint64_t* empty = full + kTcStages;               // kTcStages

  const int bkv = blockIdx.x;                       // batch * hkv + kv head
  const int kb0 = 2 * blockIdx.y;                   // the CTA's 64-key blocks
  const int g0 = blockIdx.z * per_split;            // the CTA's q heads
  const int g1 = min(group, g0 + per_split);
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  // A q block is streamed when either of the CTA's kv blocks is live for it.
  auto cta_live = [&](int qb) {
    const KvRange r = q_block_live(qb, sq, skv, causal, window, q_offset);
    return kb0 + 1 >= r.begin && kb0 < r.end;
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // ---- producer warpgroup: its first thread issues every load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kTcConsumers) {
      mbar_arrive_expect_tx(kv_full, 4 * L::kTile);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          const int off = w * L::kTile + a * kBlockK * L::kRowBytes;
          const int k_lo = (kb0 + w) * kBlockK;
          tma_load_3d(ks + off, &k_map, kv_full, a * L::kAtomCols, k_lo, bkv);
          tma_load_3d(vs + off, &v_map, kv_full, a * L::kAtomCols, k_lo, bkv);
        }
      int it = 0;
      for (int g = g0; g < g1; ++g) {
        const int bh = bkv * group + g;
        for (int qb = 0; qb < n_qb; ++qb) {
          if (!cta_live(qb)) continue;
          const int s = it % kTcStages;
          mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[s], 2 * L::kTile + 4 * kLdFloats);
#pragma unroll
          for (int a = 0; a < L::kAtoms; ++a) {
            const int off = s * L::kTile + a * kBlockQ * L::kRowBytes;
            tma_load_3d(qs + off, &q_map, &full[s], a * L::kAtomCols,
                        qb * kBlockQ, bh);
            tma_load_3d(dos + off, &do_map, &full[s], a * L::kAtomCols,
                        qb * kBlockQ, bh);
          }
          bulk_load(lds + s * kLdFloats,
                    ld + (static_cast<size_t>(bh) * n_qb + qb) * kLdFloats,
                    4 * kLdFloats, &full[s]);
          ++it;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each ----
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int kb = kb0 + wg;                          // this warpgroup's block
  const int k_lo = kb * kBlockK, k_hi = k_lo + kBlockK - 1;
  const int key_a = k_lo + 16 * (t / 32) + (t % 32) / 4;   // + 8: b
  const int col0 = 2 * (t % 4);
  const uint8_t* k_w = ks + wg * L::kTile;
  const uint8_t* v_w = vs + wg * L::kTile;

  float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  // At dh 128 the f32 dK and dV take 128 registers a thread, and S^T and
  // dP^T side by side would spill: P^T is then kept in bf16 alone, dV's
  // product runs beside dP^T's, dS^T is formed from the rounded P^T, and
  // the products' k-loops stay rolled (their descriptors are not all held
  // at once).  Below dh 128, where the registers allow it, both scores
  // are computed in one group, which is faster there.
  constexpr bool kLean = DH == 128;

  mbar_wait(kv_full, 0);
  int it = 0;
  for (int g = g0; g < g1; ++g) {
    for (int qb = 0; qb < n_qb; ++qb) {
      if (!cta_live(qb)) continue;
      const int s = it % kTcStages;
      mbar_wait(&full[s], (it / kTcStages) & 1);
      const KvRange r = q_block_live(qb, sq, skv, causal, window, q_offset);
      const bool skip = kb < r.begin || kb >= r.end ||
                        ((fault & kFaultDropLastKvBlock) && kb == r.end - 1);
      if (!skip) {
        const uint8_t* q_t = qs + s * L::kTile;
        const uint8_t* do_t = dos + s * L::kTile;
        const float* ld_s = lds + s * kLdFloats;
        const int q0 = qb * kBlockQ;
        const int q_lo = q0 + q_offset, q_hi = q0 + kBlockQ - 1 + q_offset;
        // ---- S^T = k q^T (and dP^T = v dO^T), 64 keys x 64 queries ----
        float st[32], dpt[32];
        wgmma_fence();
        mma_xyt<DH, kLean>(st, k_w, q_t);
        if constexpr (!kLean) mma_xyt<DH>(dpt, v_w, do_t);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        if constexpr (!kLean) fence_regs(dpt);

        // ---- P^T on the fragments: f32 in st, bf16 in pa ----
        const bool edge = q0 + kBlockQ > sq || k_hi >= skv ||
                          (causal && k_hi > q_lo) ||
                          (window >= 0 && k_lo <= q_hi - window);
        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = 8 * (i / 4) + col0;         // query column of i
          const float2 l2 = *reinterpret_cast<const float2*>(ld_s + c);
          float p0 = exp2f(st[i] * scale_log2 - l2.x);
          float p1 = exp2f(st[i + 1] * scale_log2 - l2.y);
          if (edge) {
            const int kpos = key_a + (((i / 2) % 2) ? 8 : 0);
            const int qpos = q0 + c + q_offset;
            p0 = q0 + c < sq && visible(qpos, kpos, skv, causal, window)
                     ? p0 : 0.f;
            p1 = q0 + c + 1 < sq &&
                         visible(qpos + 1, kpos, skv, causal, window)
                     ? p1 : 0.f;
          }
          st[i] = p0;
          st[i + 1] = p1;
          const __nv_bfloat162 p2 = __floats2bfloat162_rn(p0, p1);
          pa[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&p2);
        }

        if constexpr (kLean) {
          // ---- dV += P^T dO beside dP^T = v dO^T; dS^T from bf16 P^T ----
          fence_regs(dv_acc);
          fence_regs(pa);
          wgmma_fence();
          mma_ay<DH>(dv_acc, pa, do_t);
          mma_xyt<DH, true>(dpt, v_w, do_t);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv_acc);
          fence_regs(pa);
          fence_regs(dpt);
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int c = 8 * (i / 4) + col0;
            const float2 d2 =
                *reinterpret_cast<const float2*>(ld_s + kBlockQ + c);
            // The packed pair's low half is register i's bf16, the high
            // half register i + 1's: widened exactly by a shift.
            const uint32_t pp = pa[i / 8][(i % 8) / 2];
            const float p0 = __uint_as_float(pp << 16);
            const float p1 = __uint_as_float(pp & 0xffff0000u);
            const __nv_bfloat162 s2 = __floats2bfloat162_rn(
                p0 * (dpt[i] - d2.x), p1 * (dpt[i + 1] - d2.y));
            da[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&s2);
          }
          // ---- dK += dS^T q ----
          fence_regs(dk_acc);
          fence_regs(da);
          wgmma_fence();
          mma_ay<DH>(dk_acc, da, q_t);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dk_acc);
          fence_regs(da);
        } else {
          // ---- dS^T = P^T (dP^T - D); dV += P^T dO, dK += dS^T q ----
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int c = 8 * (i / 4) + col0;
            const float2 d2 =
                *reinterpret_cast<const float2*>(ld_s + kBlockQ + c);
            const __nv_bfloat162 s2 = __floats2bfloat162_rn(
                st[i] * (dpt[i] - d2.x), st[i + 1] * (dpt[i + 1] - d2.y));
            da[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&s2);
          }
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
          wgmma_fence();
          mma_ay<DH>(dv_acc, pa, do_t);
          mma_ay<DH>(dk_acc, da, q_t);
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(dv_acc);
          fence_regs(dk_acc);
          fence_regs(pa);
          fence_regs(da);
        }
      }
      mbar_arrive(&empty[s]);   // this thread is done with stage s
      ++it;
    }
  }

  const size_t kv_off = static_cast<size_t>(bkv) * skv * DH;
  if (part == nullptr) {
    store_rows<DH>(dk + kv_off, dk_acc, key_a, skv, col0, scale);
    store_rows<DH>(dv + kv_off, dv_acc, key_a, skv, col0, 1.f);
  } else {
    // This split's partial sums, f32: dK's at part[z], dV's at
    // part[splits + z], each (b * hkv, skv, DH).
    const size_t n = static_cast<size_t>(gridDim.x) * skv * DH;
    store_rows_f32<DH>(part + blockIdx.z * n + kv_off, dk_acc, key_a, skv,
                       col0);
    store_rows_f32<DH>(part + (gridDim.z + blockIdx.z) * n + kv_off, dv_acc,
                       key_a, skv, col0);
  }
}

// 2b. dK, dV of a split group: the splits' partial sums added in split
// order (so the result is the same on every run), dK times scale, in bf16.
// One thread per pair of values.
__global__ void __launch_bounds__(kThreads)
bwd_dkv_sum_kernel(const float* __restrict__ part,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int64_t pairs, int splits,
                   float scale) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= pairs) return;
  const auto* p2 = reinterpret_cast<const float2*>(part);
  float2 k = p2[e], v = p2[splits * pairs + e];
  for (int z = 1; z < splits; ++z) {
    const float2 a = p2[z * pairs + e], c = p2[(splits + z) * pairs + e];
    k.x += a.x;
    k.y += a.y;
    v.x += c.x;
    v.y += c.y;
  }
  reinterpret_cast<__nv_bfloat162*>(dk)[e] =
      __floats2bfloat162_rn(k.x * scale, k.y * scale);
  reinterpret_cast<__nv_bfloat162*>(dv)[e] = __floats2bfloat162_rn(v.x, v.y);
}

// 3. dQ: rows are queries, columns keys.
template <int DH>
__global__ void __launch_bounds__(kDqThreads, 1)
bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map,
                    const __grid_constant__ CUtensorMap do_map,
                    const float* __restrict__ ld,
                    __nv_bfloat16* __restrict__ dq, int group, int sq,
                    int skv, int causal, int window, int q_offset,
                    float scale, float scale_log2, int fault) {
  using L = BwdLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;                               // 2 tiles
  uint8_t* dos = qs + 2 * L::kTile;                 // 2 tiles
  uint8_t* ks = dos + 2 * L::kTile;                 // kTcStages tiles
  uint8_t* vs = ks + kTcStages * L::kTile;          // kTcStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kTcStages * L::kTile);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                        // kTcStages
  uint64_t* empty = full + kTcStages;               // kTcStages

  const int bh = blockIdx.x;                        // batch * hq + head
  const int kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 2 * kBlockQ;   // heavy first
  const KvRange live = live_kv(q0 + q_offset,
                               min(q0 + 2 * kBlockQ, sq) - 1 + q_offset, skv,
                               causal, window);
  const int n_it = max(live.end - live.begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == kTcConsumers) {
      mbar_arrive_expect_tx(q_full, 4 * L::kTile);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          const int off = w * L::kTile + a * kBlockQ * L::kRowBytes;
          const int r0 = q0 + w * kBlockQ;
          tma_load_3d(qs + off, &q_map, q_full, a * L::kAtomCols, r0, bh);
          tma_load_3d(dos + off, &do_map, q_full, a * L::kAtomCols, r0, bh);
        }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kTcStages;
        mbar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kTile);
        const int k_lo = (live.begin + it) * kBlockK;
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          const int off = s * L::kTile + a * kBlockK * L::kRowBytes;
          tma_load_3d(ks + off, &k_map, &full[s], a * L::kAtomCols, k_lo, kvh);
          tma_load_3d(vs + off, &v_map, &full[s], a * L::kAtomCols, k_lo, kvh);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int w0 = q0 + wg * kBlockQ;                 // this warpgroup's rows
  const int row_a = w0 + 16 * (t / 32) + (t % 32) / 4;   // + 8: b
  const int col0 = 2 * (t % 4);
  const bool wg_empty = w0 >= sq;
  const KvRange own = q_block_live(w0 / kBlockQ, sq, skv, causal, window,
                                   q_offset);
  const int wq_lo = w0 + q_offset;
  const int wq_hi = min(w0 + kBlockQ, sq) - 1 + q_offset;
  const uint8_t* q_w = qs + wg * L::kTile;
  const uint8_t* do_w = dos + wg * L::kTile;

  // lse * log2(e) and D of rows row_a and row_a + 8 (zeros past sq).
  float l_a = 0.f, l_b = 0.f, d_a = 0.f, d_b = 0.f;
  if (!wg_empty) {
    const float* blk = ld + (static_cast<size_t>(bh) * ((sq + kBlockQ - 1) /
                                                        kBlockQ) +
                             w0 / kBlockQ) * kLdFloats;
    const int i = row_a - w0;
    l_a = blk[i];
    l_b = blk[i + 8];
    d_a = blk[kBlockQ + i];
    d_b = blk[kBlockQ + i + 8];
  }

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kTcStages;
    const int kb = live.begin + it;
    const int k_lo = kb * kBlockK, k_hi = k_lo + kBlockK - 1;
    mbar_wait(&full[s], (it / kTcStages) & 1);
    const bool dead = wg_empty || kb < own.begin || kb >= own.end ||
                      ((fault & kFaultDropLastKvBlock) && kb == own.end - 1);
    if (!dead) {
      const uint8_t* k_t = ks + s * L::kTile;
      const uint8_t* v_t = vs + s * L::kTile;
      // ---- S = q k^T, dP = dO v^T (64 rows x 64 keys) ----
      float sc[32], dp[32];
      wgmma_fence();
      mma_xyt<DH>(sc, q_w, k_t);
      mma_xyt<DH>(dp, do_w, v_t);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // ---- dS on the fragments, rounded to bf16 ----
      const bool edge = k_hi >= skv || (causal && k_hi > wq_lo) ||
                        (window >= 0 && k_lo <= wq_hi - window);
      uint32_t da[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool rb = (i / 2) % 2;
        const float l = rb ? l_b : l_a, d = rb ? d_b : d_a;
        float p0 = exp2f(sc[i] * scale_log2 - l);
        float p1 = exp2f(sc[i + 1] * scale_log2 - l);
        if (edge) {
          const int kpos = k_lo + 8 * (i / 4) + col0;
          const int qpos = row_a + (rb ? 8 : 0) + q_offset;
          p0 = visible(qpos, kpos, skv, causal, window) ? p0 : 0.f;
          p1 = visible(qpos, kpos + 1, skv, causal, window) ? p1 : 0.f;
        }
        const __nv_bfloat162 s2 =
            __floats2bfloat162_rn(p0 * (dp[i] - d), p1 * (dp[i + 1] - d));
        da[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&s2);
      }

      // ---- dQ += dS k ----
      fence_regs(acc);
      fence_regs(da);
      wgmma_fence();
      mma_ay<DH>(acc, da, k_t);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(da);
    }
    mbar_arrive(&empty[s]);   // this thread is done with stage s
  }

  store_rows<DH>(dq + static_cast<size_t>(bh) * sq * DH, acc, row_a, sq,
                 col0, scale);
}

// ---------------------------------------------------------------------------
// Host code
// ---------------------------------------------------------------------------

// Instance index of head dim DH within a kernel's five instances.
template <int DH>
constexpr int dh_index() {
  return DH == 32 ? 0 : DH == 64 ? 1 : DH == 96 ? 2 : DH == 112 ? 3 : 4;
}

#define K3B_ONE(KERNEL, DH) \
  {reinterpret_cast<const void*>(KERNEL<DH>), #KERNEL "<" #DH ">"}
#define K3B_INSTANCES(KERNEL)                                     \
  K3B_ONE(KERNEL, 32), K3B_ONE(KERNEL, 64), K3B_ONE(KERNEL, 96),  \
      K3B_ONE(KERNEL, 112), K3B_ONE(KERNEL, 128)
// The f32 D pass, the bf16 prep pass, then each kernel at dh 32, 64, 96,
// 112, 128: f32 dK / dV, f32 dQ, bf16 dK / dV, bf16 dQ; then the bf16
// split groups' sum.
const KernelInstance kK3bInstances[] = {
    {reinterpret_cast<const void*>(bwd_dot_kernel), "bwd_dot_kernel"},
    {reinterpret_cast<const void*>(bwd_prep_kernel), "bwd_prep_kernel"},
    K3B_INSTANCES(bwd_dkv_kernel),
    K3B_INSTANCES(bwd_dq_kernel),
    K3B_INSTANCES(bwd_dkv_wgmma_kernel),
    K3B_INSTANCES(bwd_dq_wgmma_kernel),
    {reinterpret_cast<const void*>(bwd_dkv_sum_kernel), "bwd_dkv_sum_kernel"},
};
#undef K3B_INSTANCES
#undef K3B_ONE

// q heads per grid.z split of the bf16 dK / dV kernel: the whole group
// while b * hkv * (128-key blocks) CTAs fill kFillCtas; else the group is
// cut so that they do (MQA: 2 x 1 kv heads x 32 blocks, 48 q heads).
int dkv_per_split(int b, int hkv, int group, int skv) {
  const int ctas = b * hkv * ((skv + 2 * kBlockK - 1) / (2 * kBlockK));
  const int want =
      ctas >= kFillCtas ? 1 : min(group, (kFillCtas + ctas - 1) / ctas);
  return (group + want - 1) / want;
}

// Floats of the `dd` scratch: f32 D (b * hq * sq), or the bf16 path's
// padded lse / D blocks and, when the group is split, the splits' f32
// partial dK and dV.
int64_t scratch_floats(int dtype, int b, int hq, int hkv, int sq, int skv,
                       int dh) {
  if (dtype == 0) return static_cast<int64_t>(b) * hq * sq;
  const int64_t ld = static_cast<int64_t>(b) * hq *
                     ((sq + kBlockQ - 1) / kBlockQ) * kLdFloats;
  const int group = hq / hkv;
  const int splits = (group + dkv_per_split(b, hkv, group, skv) - 1) /
                     dkv_per_split(b, hkv, group, skv);
  return ld + (splits > 1 ? 2LL * splits * b * hkv * skv * dh : 0);
}

// The launches of a call (3, or 4 with a split bf16 group) into out.
template <int DH>
int plan(int dtype, int b, int hq, int hkv, int sq, int skv,
         LaunchPlan* out) {
  const int i = dh_index<DH>();
  if (dtype == 0) {
    out[0] = LaunchPlan{0, dim3((b * hq * sq + kDotRows - 1) / kDotRows),
                        dim3(kThreads), 0};
    out[1] = LaunchPlan{2 + i, dim3((skv + kBlockK - 1) / kBlockK, b * hkv),
                        dim3(kThreads), sizeof(float) * dkv_smem_floats<DH>()};
    out[2] = LaunchPlan{7 + i, dim3((sq + kBlockQ - 1) / kBlockQ, b * hq),
                        dim3(kThreads), sizeof(float) * dq_smem_floats<DH>()};
    return 3;
  }
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  const int group = hq / hkv;
  const int per_split = dkv_per_split(b, hkv, group, skv);
  const int splits = (group + per_split - 1) / per_split;
  out[0] = LaunchPlan{1, dim3((b * hq * n_qb * kBlockQ + kDotRows - 1) /
                              kDotRows),
                      dim3(kThreads), 0};
  out[1] = LaunchPlan{12 + i,
                      dim3(b * hkv, (skv + 2 * kBlockK - 1) / (2 * kBlockK),
                           splits),
                      dim3(kDkvThreads),
                      static_cast<size_t>(BwdLayout<DH>::kDkvSmem)};
  out[2] = LaunchPlan{17 + i, dim3(b * hq, (sq + 2 * kBlockQ - 1) /
                                               (2 * kBlockQ)),
                      dim3(kDqThreads),
                      static_cast<size_t>(BwdLayout<DH>::kDqSmem)};
  if (splits == 1) return 3;
  const int64_t pairs = static_cast<int64_t>(b) * hkv * skv * DH / 2;
  out[3] = LaunchPlan{22, dim3(static_cast<unsigned>((pairs + kThreads - 1) /
                                                     kThreads)),
                      dim3(kThreads), 0};
  return 4;
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const float* lse, const void* d_o, void* dq, void* dk,
               void* dv, float* dd, int b, int hq, int hkv, int sq, int skv,
               int causal, int window, int q_offset, int fault,
               cudaStream_t stream) {
  LaunchPlan p[4];
  plan<DH>(0, b, hq, hkv, sq, skv, p);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* dot = static_cast<const float*>(d_o);
  bwd_dot_kernel<<<p[0].grid, p[0].block, p[0].smem, stream>>>(
      static_cast<const float*>(o), dot, dd, b * hq * sq, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkv_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p[1].smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<DH><<<p[1].grid, p[1].block, p[1].smem, stream>>>(
      qt, kt, vt, lse, dd, dot, static_cast<float*>(dk),
      static_cast<float*>(dv), hq / hkv, sq, skv, causal, window, q_offset,
      scale, fault);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dq_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p[2].smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<DH><<<p[2].grid, p[2].block, p[2].smem, stream>>>(
      qt, kt, vt, lse, dd, dot, static_cast<float*>(dq), hq / hkv, sq, skv,
      causal, window, q_offset, scale, fault);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const float* lse, const void* d_o, void* dq, void* dk,
                void* dv, float* ld, int b, int hq, int hkv, int sq, int skv,
                int causal, int window, int q_offset, int fault,
                cudaStream_t stream) {
  using L = BwdLayout<DH>;
  LaunchPlan p[4];
  const int n_launch = plan<DH>(1, b, hq, hkv, sq, skv, p);
  const int n_qb = (sq + kBlockQ - 1) / kBlockQ;
  const int per_split = dkv_per_split(b, hkv, hq / hkv, skv);
  // The splits' partial dK / dV follow the lse / D blocks in the scratch.
  float* part = n_launch == 4
                    ? ld + static_cast<int64_t>(b) * hq * n_qb * kLdFloats
                    : nullptr;
  bwd_prep_kernel<<<p[0].grid, p[0].block, p[0].smem, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(d_o), lse, ld, b * hq * n_qb * kBlockQ,
      sq, n_qb, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const CUtensorMapSwizzle sw = L::kSwizzle;
  CUtensorMap q_map, k_map, v_map, do_map;
  int rc = make_map(&q_map, q, b * hq, sq, DH, kBlockQ, L::kAtomCols, sw);
  if (rc == 0)
    rc = make_map(&do_map, d_o, b * hq, sq, DH, kBlockQ, L::kAtomCols, sw);
  if (rc == 0)
    rc = make_map(&k_map, k, b * hkv, skv, DH, kBlockK, L::kAtomCols, sw);
  if (rc == 0)
    rc = make_map(&v_map, v, b * hkv, skv, DH, kBlockK, L::kAtomCols, sw);
  if (rc != 0) return rc;
  const double scale = 1.0 / sqrt(static_cast<double>(DH));
  const float scale_f = static_cast<float>(scale);
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);

  err = cudaFuncSetAttribute(bwd_dkv_wgmma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p[1].smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_wgmma_kernel<DH><<<p[1].grid, p[1].block, p[1].smem, stream>>>(
      q_map, k_map, v_map, do_map, ld, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), part, hq / hkv, per_split, sq, skv,
      causal, window, q_offset, scale_f, scale_log2, fault);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dq_wgmma_kernel<DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p[2].smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_wgmma_kernel<DH><<<p[2].grid, p[2].block, p[2].smem, stream>>>(
      q_map, k_map, v_map, do_map, ld, static_cast<__nv_bfloat16*>(dq),
      hq / hkv, sq, skv, causal, window, q_offset, scale_f, scale_log2,
      fault);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_launch == 3) return static_cast<int>(err);
  bwd_dkv_sum_kernel<<<p[3].grid, p[3].block, p[3].smem, stream>>>(
      part, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<int64_t>(b) * hkv * skv * DH / 2, p[1].grid.z, scale_f);
  return static_cast<int>(cudaGetLastError());
}

// f(DH) at the head dims the kernels are instantiated at, as a
// std::integral_constant; cudaErrorInvalidValue for any other.
template <typename F>
int with_head_dim(int dh, F&& f) {
  switch (dh) {
    case 32:
      return f(std::integral_constant<int, 32>{});
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 96:
      return f(std::integral_constant<int, 96>{});
    case 112:
      return f(std::integral_constant<int, 112>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool bad_shape(int b, int hq, int hkv, int sq, int skv, int dtype) {
  return hkv <= 0 || hq % hkv != 0 || skv <= 0 || b * hq > 65535 ||
         (dtype != 0 && dtype != 1);
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K3-bwd on `stream`: q, o, dO and dq (b, hq, sq, dh), k, v, dk
// and dv (b, hkv, skv, dh), all contiguous on the device in one dtype (0 =
// f32, the CUDA-core kernels; 1 = bf16, the tensor-core kernels, q, k, v
// and dO 16 B aligned for TMA); lse (b, hq, sq) f32 from the forward; dd
// f32 scratch of k3b_scratch_floats(...) floats, 16 B aligned.  dh in {32,
// 64, 96, 112, 128}; window < 0 means none.  `fault` plants a fault for the checks that
// must catch it (1: every q block drops its last visible kv block); 0 on
// every real call.  Returns cudaGetLastError() after the launches (0 on
// success), or a code of the tensor-map step (k3b_error_string names it).
int k3b_flash_attention_bwd(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* d_o,
                            void* dq, void* dk, void* dv, void* dd, int dtype,
                            int b, int hq, int hkv, int sq, int skv, int dh,
                            int causal, int window, int q_offset, int fault,
                            void* stream) {
  using namespace repro_torch;
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, skv, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 &&
      (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(d_o)) %
              16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* lse_f = static_cast<const float*>(lse);
  auto* dd_f = static_cast<float*>(dd);
  return with_head_dim(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    return dtype == 0
               ? launch_f32<DH>(q, k, v, o, lse_f, d_o, dq, dk, dv, dd_f, b,
                                hq, hkv, sq, skv, causal, window, q_offset,
                                fault, s)
               : launch_bf16<DH>(q, k, v, o, lse_f, d_o, dq, dk, dv, dd_f, b,
                                 hq, hkv, sq, skv, causal, window, q_offset,
                                 fault, s);
  });
}

// The launches k3b_flash_attention_bwd makes for these shapes (none,
// three, or four when a bf16 group is split), as kPlanInts ints each;
// budget.cuh says what they hold.
int k3b_plan(int dtype, int b, int hq, int hkv, int sq, int skv, int dh,
             int* out, int* n_launches) {
  using namespace repro_torch;
  *n_launches = 0;
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, skv, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  LaunchPlan p[4];
  int n = 0;
  const int rc = with_head_dim(dh, [&](auto d) {
    n = plan<decltype(d)::value>(dtype, b, hq, hkv, sq, skv, p);
    return 0;
  });
  if (rc != 0) return rc;
  for (int i = 0; i < n; ++i) write_plan(p[i], out + i * kPlanInts);
  *n_launches = n;
  return 0;
}

// Floats of the f32 scratch `dd` that k3b_flash_attention_bwd needs for
// these shapes; -1 for a shape it refuses.
int64_t k3b_scratch_floats(int dtype, int b, int hq, int hkv, int sq,
                           int skv, int dh) {
  using namespace repro_torch;
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, skv, dtype) ||
      with_head_dim(dh, [](auto) { return 0; }) != 0)
    return -1;
  return scratch_floats(dtype, b, hq, hkv, sq, skv, dh);
}

const char* k3b_error_string(int code) {
  return repro_torch::error_string(code);
}

}  // extern "C"

REPRO_INSTANCE_QUERIES(k3b, kK3bInstances)
