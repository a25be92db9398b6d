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
// bytes of the eight tensors.  This first kernel runs them on the CUDA
// cores in f32 (no wgmma, no TMA), so its own bound is the f32 peak; a
// tensor-core redesign is later work.
//
// Three launches per call, no atomics, so the result is the same bit for
// bit on every run:
//
// 1. bwd_dot_kernel: D per query row, one warp per row, f32.
// 2. bwd_dkv_kernel: one CTA of 256 threads per (batch * kv head, kv block
//    of 64 keys).  It stages its k and v tiles once, then walks the q heads
//    of its group and, for each, the 64-row q blocks that can see the kv
//    block (the forward's block skip rule, with q_offset), staging q, dO,
//    lse and D.  Thread (ty, tx) of a 16 x 16 layout computes S^T and dP^T
//    for keys 4ty..4ty+3 and queries tx + 16j, writes P^T and dS^T to
//    shared memory, then accumulates dV and dK for its keys at dims tx +
//    16c in registers.  One store per CTA, in the input dtype.
// 3. bwd_dq_kernel: one CTA per (batch * q head, q block of 64 rows); it
//    stages q, dO, lse and D once and walks the visible kv blocks, with
//    the roles of rows and keys swapped, accumulating dQ in registers.
//
// Shared-memory rows are padded by one float, so the column reads of the
// products hit distinct banks.  Rows past sq and keys past skv are staged
// as zeros and masked.  A row that sees no key has lse = -inf and every
// P = 0, so its gradient is 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "budget.cuh"

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;   // = kernels/ref.py FLASH_BLOCK_K
constexpr int kThreads = 256;
constexpr int kRows = 4;      // rows per thread of a 64 x 64 tile
constexpr int kCols = kBlockK / 16;
constexpr int kLdP = kBlockK + 1;
constexpr int kDotRows = kThreads / 32;   // bwd_dot_kernel: a warp per row

// Planted faults, for the checks that must catch them (chip_smoke.py).
constexpr int kFaultDropLastKvBlock = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// ---- 1. D = rowsum(dO * O) -------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ d_o,
               float* __restrict__ dd, int rows, int dh) {
  const int row = blockIdx.x * kDotRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * dh;
  float s = 0.f;
  for (int c = lane; c < dh; c += 32)
    s = fmaf(to_f32(d_o[base + c]), to_f32(o[base + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) dd[row] = s;
}

// Stage rows [r0, r0 + 64) of a (rows, DH) slab into a (64, DH + 1) f32
// tile, zeros past `rows`.
template <typename T, int DH>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0,
                                      int rows) {
  constexpr int kLd = DH + 1;
  for (int e = threadIdx.x; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * kLd + c] =
        r0 + r < rows ? to_f32(src[static_cast<size_t>(r0 + r) * DH + c])
                      : 0.f;
  }
}

// ---- 2. dK, dV -----------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ dd, const T* __restrict__ d_o,
               T* __restrict__ dk, T* __restrict__ dv, int group, int sq,
               int skv, int causal, int window, int q_offset, float scale,
               int fault) {
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
  stage<T, DH>(ks, k + kv_off, k_lo, skv);
  stage<T, DH>(vs, v + kv_off, k_lo, skv);

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
      const KvRange live = live_kv(q0 + q_offset,
                                   min(q0 + kBlockQ, sq) - 1 + q_offset, skv,
                                   causal, window);
      if (kb < live.begin || kb >= live.end) continue;
      if ((fault & kFaultDropLastKvBlock) && kb == live.end - 1) continue;

      __syncthreads();   // the previous q block's reads are done
      stage<T, DH>(qs, q + q_off * DH, q0, sq);
      stage<T, DH>(dos, d_o + q_off * DH, q0, sq);
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
          const int qpos = q0 + qi + q_offset;
          const bool ok = q0 + qi < sq && kpos < skv &&
                          (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
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
      dk[at] = from_f32<T>(dk_acc[r][c] * scale);
      dv[at] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// ---- 3. dQ ---------------------------------------------------------------

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ lse,
              const float* __restrict__ dd, const T* __restrict__ d_o,
              T* __restrict__ dq, int group, int sq, int skv, int causal,
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

  stage<T, DH>(qs, q + q_off * DH, q0, sq);
  stage<T, DH>(dos, d_o + q_off * DH, q0, sq);
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

  KvRange live = live_kv(q0 + q_offset, min(q0 + kBlockQ, sq) - 1 + q_offset,
                         skv, causal, window);
  if (fault & kFaultDropLastKvBlock) live.end -= 1;
  for (int kb = live.begin; kb < live.end; ++kb) {
    const int k_lo = kb * kBlockK;
    __syncthreads();   // the previous block's reads of ks / vs / ds are done
    stage<T, DH>(ks, k + kv_off, k_lo, skv);
    stage<T, DH>(vs, v + kv_off, k_lo, skv);
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
      const int qpos = q0 + qi + q_offset;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        const bool ok = q0 + qi < sq && kpos < skv &&
                        (!causal || kpos <= qpos) &&
                        (window < 0 || kpos > qpos - window);
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
      dq[(q_off + row) * DH + tx + 16 * c] = from_f32<T>(acc[r][c] * scale);
  }
}

// Instance index of (dtype, DH): dtype 0 = f32, 1 = bf16; DH 32 or 64.
constexpr int dh_index(int dh) { return dh == 32 ? 0 : 1; }

#define K3B_INSTANCE(KERNEL, T, DH)                                      \
  {reinterpret_cast<const void*>(KERNEL<T, DH>), #KERNEL "<" #T ", " #DH ">"}
// bwd_dot_kernel<float>, <bf16>, then bwd_dkv_kernel and bwd_dq_kernel,
// each at (float, 32), (float, 64), (bf16, 32), (bf16, 64).
const KernelInstance kK3bInstances[] = {
    {reinterpret_cast<const void*>(bwd_dot_kernel<float>),
     "bwd_dot_kernel<float>"},
    {reinterpret_cast<const void*>(bwd_dot_kernel<__nv_bfloat16>),
     "bwd_dot_kernel<__nv_bfloat16>"},
    K3B_INSTANCE(bwd_dkv_kernel, float, 32),
    K3B_INSTANCE(bwd_dkv_kernel, float, 64),
    K3B_INSTANCE(bwd_dkv_kernel, __nv_bfloat16, 32),
    K3B_INSTANCE(bwd_dkv_kernel, __nv_bfloat16, 64),
    K3B_INSTANCE(bwd_dq_kernel, float, 32),
    K3B_INSTANCE(bwd_dq_kernel, float, 64),
    K3B_INSTANCE(bwd_dq_kernel, __nv_bfloat16, 32),
    K3B_INSTANCE(bwd_dq_kernel, __nv_bfloat16, 64),
};
#undef K3B_INSTANCE

template <int DH>
void plan(int dtype, int b, int hq, int hkv, int sq, int skv,
          LaunchPlan* out) {
  const int t = 2 * dtype + dh_index(DH);
  out[0] = LaunchPlan{dtype, dim3((b * hq * sq + kDotRows - 1) / kDotRows),
                      dim3(kThreads), 0};
  out[1] = LaunchPlan{2 + t, dim3((skv + kBlockK - 1) / kBlockK, b * hkv),
                      dim3(kThreads), sizeof(float) * dkv_smem_floats<DH>()};
  out[2] = LaunchPlan{6 + t, dim3((sq + kBlockQ - 1) / kBlockQ, b * hq),
                      dim3(kThreads), sizeof(float) * dq_smem_floats<DH>()};
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* d_o, void* dq, void* dk, void* dv,
           float* dd, int b, int hq, int hkv, int sq, int skv, int causal,
           int window, int q_offset, int fault, cudaStream_t stream) {
  LaunchPlan p[3];
  plan<DH>(std::is_same<T, float>::value ? 0 : 1, b, hq, hkv, sq, skv, p);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(d_o);
  bwd_dot_kernel<T><<<p[0].grid, p[0].block, p[0].smem, stream>>>(
      static_cast<const T*>(o), dot, dd, b * hq * sq, DH);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dkv_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p[1].smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkv_kernel<T, DH><<<p[1].grid, p[1].block, p[1].smem, stream>>>(
      qt, kt, vt, lse, dd, dot, static_cast<T*>(dk), static_cast<T*>(dv),
      hq / hkv, sq, skv, causal, window, q_offset, scale, fault);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(bwd_dq_kernel<T, DH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(p[2].smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dq_kernel<T, DH><<<p[2].grid, p[2].block, p[2].smem, stream>>>(
      qt, kt, vt, lse, dd, dot, static_cast<T*>(dq), hq / hkv, sq, skv,
      causal, window, q_offset, scale, fault);
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
// f32, 1 = bf16); lse (b, hq, sq) f32 from the forward; dd scratch of b *
// hq * sq f32 (D).  dh in {32, 64}; window < 0 means none.  `fault` plants
// a fault for the checks that must catch it (1: every q block drops its
// last visible kv block); 0 on every real call.  Returns
// cudaGetLastError() after the launches (0 on success).
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
  auto s = static_cast<cudaStream_t>(stream);
  const auto* lse_f = static_cast<const float*>(lse);
  auto* dd_f = static_cast<float*>(dd);
  return with_head_dim(dh, [&](auto d) {
    constexpr int DH = decltype(d)::value;
    return dtype == 0
               ? launch<float, DH>(q, k, v, o, lse_f, d_o, dq, dk, dv, dd_f, b,
                                   hq, hkv, sq, skv, causal, window, q_offset,
                                   fault, s)
               : launch<__nv_bfloat16, DH>(q, k, v, o, lse_f, d_o, dq, dk, dv,
                                           dd_f, b, hq, hkv, sq, skv, causal,
                                           window, q_offset, fault, s);
  });
}

// The launches k3b_flash_attention_bwd makes for these shapes (none or
// three), as kPlanInts ints each; budget.cuh says what they hold.
int k3b_plan(int dtype, int b, int hq, int hkv, int sq, int skv, int dh,
             int* out, int* n_launches) {
  using namespace repro_torch;
  *n_launches = 0;
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (bad_shape(b, hq, hkv, sq, skv, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  LaunchPlan p[3];
  const int rc = with_head_dim(dh, [&](auto d) {
    plan<decltype(d)::value>(dtype, b, hq, hkv, sq, skv, p);
    return 0;
  });
  if (rc != 0) return rc;
  for (int i = 0; i < 3; ++i) write_plan(p[i], out + i * kPlanInts);
  *n_launches = 3;
  return 0;
}

const char* k3b_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

REPRO_INSTANCE_QUERIES(k3b, kK3bInstances)
