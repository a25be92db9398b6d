// K3: online-softmax GQA attention (causal / sliding window, q_offset).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel).  It computes what that body
// computes, for q (b, hq, sq, dh) and k, v (b, hkv, skv, dh), f32 or bf16:
//
//   for each (batch * q-head, q block): loop over the kv blocks with a
//   running max m, denominator l and accumulator acc in f32;
//   logits = (q * 1/sqrt(dh)) k^T, masked to NEG_INF outside
//   (kpos < skv) & (causal: kpos <= qpos) & (window: kpos > qpos - window);
//   p = exp(logits - m_new) * mask; l = l * corr + sum(p);
//   acc = acc * corr + p v; out = acc / max(l, 1e-30) in q's dtype.
//
// The kv head of q head h is h / group (the Pallas index maps), with any
// group, power of two or not.  A kv block that no query row of the q block
// can see (the Pallas `live` predicate: padding, causal, window) is skipped,
// which makes a sliding-window layer O(S * W).  The ragged edges of sq and
// skv are bounds-checked instead of padded.
//
// Design (a simple CUDA-core kernel; a wgmma / TMA design is later work):
// one block of 256 threads per (batch * q-head, 64 query rows).  q (scaled),
// the current 64-row k and v tiles and the (64, 64) tile of probabilities
// are staged in shared memory as f32 (rows padded by one float, so column
// reads hit distinct banks).  Thread (ty, tx) of a 16 x 16 layout owns query
// rows 4ty..4ty+3: for the logits it computes keys tx + 16j (j < 4), so a
// row's 64 logits sit in the 16 lanes of one half-warp and its max and sum
// are shuffle reductions; for p v it accumulates dims tx + 16c in registers.
// All arithmetic is IEEE f32 FMAs on the CUDA cores (no TF32, no tensor
// cores).
//
// What bounds it on this card: at the prefill shapes the work is
// 4 * dh flops per live (query, key) pair, far above the bytes of q, k, v
// and o, so the bound is the operations over the tensor-core peak; this
// CUDA-core kernel sits well above that bound (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;   // = kernels/ref.py FLASH_BLOCK_K
constexpr int kThreads = 256;
constexpr int kRows = 4;      // query rows per thread
constexpr int kKeys = kBlockK / 16;
constexpr int kLdP = kBlockK + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int DH>
constexpr size_t smem_floats() {
  return 2 * kBlockQ * (DH + 1) + kBlockK * DH + kBlockQ * kLdP;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int group, int sq,
             int skv, int causal, int window, int q_offset, float scale) {
  constexpr int kLd = DH + 1;
  constexpr int kDims = DH / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // kBlockQ x kLd, q * scale
  float* ks = qs + kBlockQ * kLd;     // kBlockK x kLd
  float* vs = ks + kBlockK * kLd;     // kBlockK x DH
  float* ps = vs + kBlockK * DH;      // kBlockQ x kLdP, probabilities

  const int bh = blockIdx.y;          // batch * hq + head
  const int kvh = bh / group;         // batch * hkv + head / group
  const int q0 = blockIdx.x * kBlockQ;
  const T* qp = q + static_cast<size_t>(bh) * sq * DH;
  const T* kp = k + static_cast<size_t>(kvh) * skv * DH;
  const T* vp = v + static_cast<size_t>(kvh) * skv * DH;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    qs[r * kLd + c] =
        (q0 + r < sq) ? to_f32(qp[static_cast<size_t>(q0 + r) * DH + c]) * scale
                      : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kDims; ++c) acc[r][c] = 0.f;
  }

  const int q_lo = q0 + q_offset;
  const int q_hi = q_lo + kBlockQ - 1;
  const int n_kv = (skv + kBlockK - 1) / kBlockK;
  for (int kb = 0; kb < n_kv; ++kb) {
    const int k_lo = kb * kBlockK;
    if (causal && k_lo > q_hi) break;                    // and all after it
    if (window >= 0 && k_lo + kBlockK - 1 <= q_lo - window) continue;

    __syncthreads();   // the previous block's reads of ks / vs / ps are done
    for (int e = tid; e < kBlockK * DH; e += kThreads) {
      const int r = e / DH, c = e % DH;
      const bool in = k_lo + r < skv;
      const size_t src = static_cast<size_t>(k_lo + r) * DH + c;
      ks[r * kLd + c] = in ? to_f32(kp[src]) : 0.f;
      vs[r * DH + c] = in ? to_f32(vp[src]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = qs[(ty * kRows + r) * kLd + d];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = ks[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_lo + ty * kRows + r;
      bool ok[kKeys];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kpos = k_lo + tx + 16 * j;
        ok[j] = kpos < skv && (!causal || kpos <= qpos) &&
                (window < 0 || kpos > qpos - window);
        if (!ok[j]) s[r][j] = kNegInf;
        mx = fmaxf(mx, s[r][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        // Masked lanes are zeroed, not left to exp(NEG_INF - m_new): a row
        // with no live key yet has m_new = NEG_INF, and exp(0) would be 1.
        const float p = ok[j] ? expf(s[r][j] - m_new) : 0.f;
        ps[(ty * kRows + r) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int c = 0; c < kDims; ++c) acc[r][c] *= corr;
      m[r] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows], vv[kDims];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = ps[(ty * kRows + r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < kDims; ++c) vv[c] = vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kDims; ++c)
          acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

  T* op = o + static_cast<size_t>(bh) * sq * DH;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row >= sq) break;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      op[static_cast<size_t>(row) * DH + tx + 16 * c] =
          from_f32<T>(acc[r][c] / den);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int sq, int skv, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  flash_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq / hkv, sq, skv, causal,
      window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dh(int dh, const void* q, const void* k, const void* v, void* o,
                int b, int hq, int hkv, int sq, int skv, int causal,
                int window, int q_offset, cudaStream_t stream) {
  switch (dh) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           q_offset, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                           q_offset, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,
                            q_offset, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K3 on `stream`.  q (b, hq, sq, dh), k and v (b, hkv, skv, dh) and
// o like q, all contiguous on the device; dtype 0 = f32, 1 = bf16;
// dh in {32, 64, 128}; hq % hkv == 0; window < 0 means none.  Returns
// cudaGetLastError() after the launch (0 on success).
int k3_flash_attention(const void* q, const void* k, const void* v, void* o,
                       int dtype, int b, int hq, int hkv, int sq, int skv,
                       int dh, int causal, int window, int q_offset,
                       void* stream) {
  using namespace repro_torch;
  if (b <= 0 || hq <= 0 || sq <= 0) return 0;
  if (hkv <= 0 || hq % hkv != 0 || skv <= 0 || b * hq > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_dh<float>(dh, q, k, v, o, b, hq, hkv, sq, skv, causal,
                              window, q_offset, s);
  }
  if (dtype == 1) {
    return dispatch_dh<__nv_bfloat16>(dh, q, k, v, o, b, hq, hkv, sq, skv,
                                      causal, window, q_offset, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
