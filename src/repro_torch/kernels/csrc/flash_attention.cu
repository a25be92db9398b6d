// K3: online-softmax GQA attention (causal / sliding window, q_offset).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// flash_attention (body _flash_kernel).  It computes what that body
// computes, for q (b, hq, sq, dh) and k, v (b, hkv, skv, dh):
//
//   for each (batch * q-head, q block): loop over the kv blocks with a
//   running max m, denominator l and accumulator acc in f32;
//   logits = (q * 1/sqrt(dh)) k^T, masked outside
//   (kpos < skv) & (causal: kpos <= qpos) & (window: kpos > qpos - window);
//   p = exp(logits - m_new) * mask; l = l * corr + sum(p);
//   acc = acc * corr + p v; out = acc / max(l, 1e-30) in q's dtype.
//
// The kv head of q head h is h / group (the Pallas index maps), with any
// group, power of two or not.  Kv blocks that no query row of the q block
// can see (the Pallas `live` predicate: padding, causal, window) are never
// loaded, which makes a sliding-window layer O(S * W).
//
// What bounds it on this card: at the prefill shapes the work is 4 * dh
// flops per live (query, key) pair, far above the bytes of q, k, v and o,
// so the bound is the operations over the tensor-core peak (bf16).
//
// Two kernels, picked by dtype:
//
// * bf16, flash_wgmma_kernel: the tensor-core design.  One CTA of 288
//   threads per (batch * q-head, 128 query rows): two consumer warpgroups
//   of 64 query rows each and one producer warp.  The producer loads the q
//   tile once and the k / v tiles of 64 keys into a ring of kStages
//   shared-memory stages by TMA (each stage with a full and an empty
//   mbarrier), in the swizzle that wgmma reads: 128 B at dh 64, 64 B at dh
//   32, two 64-column atoms of 128 B at dh 128.  A consumer computes
//   S = q k^T with wgmma m64n64k16 (both operands in shared memory, f32
//   accumulators), the online softmax on the accumulator fragments (the 4
//   threads of a row reduce by shuffles, exp2 with log2(e) folded into the
//   scale), rounds p to bf16 in registers, where the f32 fragment layout of
//   S is already the A-operand layout of the next product, and accumulates
//   o += p v with wgmma m64n{dh}k16 (A from registers, v read MN-major
//   through the descriptor).  The kv loop runs only over live blocks; the
//   masks are applied only in blocks that straddle an edge (diagonal,
//   window, kv end), and a warpgroup skips the products of blocks dead for
//   its own 64 rows.  Masked logits are set to -inf while the running max
//   starts at NEG_INF (finite), so a masked lane adds exp2(-inf) = 0
//   exactly, also in a row with no live key yet.  q is not pre-scaled (the
//   scale multiplies the f32 logits), so the only roundings beyond the
//   reference's are p to bf16 and the tensor cores' f32 summation order.
//   CTAs run heavy (late) causal q blocks first, and the q heads of one kv
//   group sit in neighbouring CTAs so their k / v tiles are shared in L2.
//
// * f32, flash_kernel: IEEE f32 on the CUDA cores (no TF32, no tensor
//   cores), one block of 256 threads per (batch * q-head, 64 query rows).
//   q (scaled), the current 64-row k and v tiles and the (64, 64) tile of
//   probabilities are staged in shared memory (rows padded by one float,
//   so column reads hit distinct banks).  Thread (ty, tx) of a 16 x 16
//   layout owns query rows 4ty..4ty+3: for the logits it computes keys
//   tx + 16j (j < 4), so a row's 64 logits sit in the 16 lanes of one
//   half-warp and its max and sum are shuffle reductions; for p v it
//   accumulates dims tx + 16c in registers.  Masked lanes are selected to
//   p = 0; the ragged edges of sq and skv are bounds-checked.
#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is
                   // looked up at run time (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;   // = kernels/ref.py FLASH_BLOCK_K
constexpr int kThreads = 256;
constexpr int kRows = 4;      // query rows per thread
constexpr int kKeys = kBlockK / 16;
constexpr int kLdP = kBlockK + 1;
constexpr float kNegInf = -1e30f;

template <int DH>
constexpr size_t smem_floats() {
  return 2 * kBlockQ * (DH + 1) + kBlockK * DH + kBlockQ * kLdP;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int group, int sq,
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
  const float* qp = q + static_cast<size_t>(bh) * sq * DH;
  const float* kp = k + static_cast<size_t>(kvh) * skv * DH;
  const float* vp = v + static_cast<size_t>(kvh) * skv * DH;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  for (int e = tid; e < kBlockQ * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    qs[r * kLd + c] =
        (q0 + r < sq) ? qp[static_cast<size_t>(q0 + r) * DH + c] * scale
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
      ks[r * kLd + c] = in ? kp[src] : 0.f;
      vs[r * DH + c] = in ? vp[src] : 0.f;
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

  float* op = o + static_cast<size_t>(bh) * sq * DH;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row >= sq) break;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDims; ++c)
      op[static_cast<size_t>(row) * DH + tx + 16 * c] =
          acc[r][c] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (TMA + mbarrier ring + wgmma)
// ---------------------------------------------------------------------------

constexpr int kTcBlockQ = 128;                 // query rows per CTA
constexpr int kTcConsumers = 256;              // two warpgroups
constexpr int kTcThreads = kTcConsumers + 32;  // + one producer warp
constexpr int kStages = 2;

// Shared-memory tiles of R rows x DH bf16, as TMA writes them: the dh axis
// is cut into atoms of kAtomCols columns (one swizzle span of kRowBytes),
// each atom a region of R rows x kRowBytes.
template <int DH>
struct TcLayout {
  static constexpr int kAtomCols = DH == 32 ? 32 : 64;
  static constexpr int kAtoms = DH / kAtomCols;
  static constexpr int kRowBytes = kAtomCols * 2;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B swizzle.
  static constexpr uint64_t kLayoutType = DH == 32 ? 2 : 1;
  static constexpr int kQBytes = kTcBlockQ * DH * 2;
  static constexpr int kKvBytes = kBlockK * DH * 2;   // one k or v tile
  static constexpr int kSmem = 1024 /* alignment slack */ + kQBytes +
                               kStages * 2 * kKvBytes + 64 /* barriers */;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Block until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box {c0 (dh column), c1 (row), c2 (head)} into shared memory,
// completing `bytes` of transactions on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (bytes, stored >> 4), swizzle layout type in bits 62-63.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads / writes of a register that an
// in-flight wgmma owns across the fence / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 64, f32) (+)= A (64 x 16) * B (64 x 16)^T, both bf16 in shared
// memory, K-major; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 16, bf16 fragments in registers) * B (16 x
// 32, bf16 in shared memory, MN-major: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) * B (16 x
// 64, bf16 in shared memory, MN-major: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) * B (16 x
// 128, bf16 in shared memory, MN-major: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&o)[DH / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  if constexpr (DH == 32) {
    wgmma_rs_n32(o, a, desc);
  } else if constexpr (DH == 64) {
    wgmma_rs_n64(o, a, desc);
  } else {
    wgmma_rs_n128(o, a, desc);
  }
}

// Accumulator fragment of a 64 x N wgmma tile (f32) in thread `t` of the
// warpgroup: register i holds row 16 (t / 32) + (t % 32) / 4 + 8 ((i / 2) % 2)
// and column 8 (i / 4) + 2 (t % 4) + i % 2.
template <int DH>
__global__ void __launch_bounds__(kTcThreads, DH <= 64 ? 2 : 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ o, int group, int sq, int skv,
                   int causal, int window, int q_offset, float scale_log2) {
  using L = TcLayout<DH>;
  extern __shared__ uint8_t smem_raw[];
  // TMA swizzle atoms must start at 1024 B (128 B swizzle) boundaries.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = qs + L::kQBytes;                  // kStages k tiles
  uint8_t* vs = ks + kStages * L::kKvBytes;       // kStages v tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * L::kKvBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                      // kStages
  uint64_t* empty = full + kStages;               // kStages

  const int bh = blockIdx.x;                      // batch * hq + head
  const int kvh = bh / group;                     // batch * hkv + head / group
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBlockQ;  // heavy first
  const int q_lo = q0 + q_offset;
  const int q_hi = min(q0 + kTcBlockQ, sq) - 1 + q_offset;

  // Live kv blocks [kb_begin, kb_end): the Pallas `live` predicate.
  int kb_end = (skv + kBlockK - 1) / kBlockK;
  if (causal) kb_end = min(kb_end, q_hi < 0 ? 0 : q_hi / kBlockK + 1);
  int kb_begin = 0;
  if (window >= 0) {
    const int t = q_lo - window - (kBlockK - 1);  // need k_lo > t
    kb_begin = t < 0 ? 0 : t / kBlockK + 1;
  }
  const int n_it = max(kb_end - kb_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTcConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kTcConsumers) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == kTcConsumers) {
      mbar_arrive_expect_tx(q_full, L::kQBytes);
#pragma unroll
      for (int a = 0; a < L::kAtoms; ++a)
        tma_load_3d(qs + a * kTcBlockQ * L::kRowBytes, &q_map, q_full,
                    a * L::kAtomCols, q0, bh);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * L::kKvBytes);
        const int k_lo = (kb_begin + it) * kBlockK;
#pragma unroll
        for (int a = 0; a < L::kAtoms; ++a) {
          const int off = s * L::kKvBytes + a * kBlockK * L::kRowBytes;
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
  const int row_a = q0 + wg * 64 + 16 * (t / 32) + (t % 32) / 4;  // + 8: b
  const int qpos_a = row_a + q_offset;
  const int col0 = 2 * (t % 4);
  // Rows of this warpgroup, clipped to sq, in kv positions.
  const int wq_lo = q0 + wg * 64 + q_offset;
  const int wq_hi = min(q0 + wg * 64 + 64, sq) - 1 + q_offset;
  const bool wg_empty = q0 + wg * 64 >= sq;

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;

  mbar_wait(q_full, 0);
  // q rows of this warpgroup: K-major, 8-row groups kRowBytes * 8 apart.
  const uint8_t* q_wg = qs + wg * 64 * L::kRowBytes;

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    const int k_lo = (kb_begin + it) * kBlockK;
    const int k_hi = k_lo + kBlockK - 1;
    mbar_wait(&full[s], (it / kStages) & 1);
    const bool dead = wg_empty || (causal && k_lo > wq_hi) ||
                      (window >= 0 && k_hi <= wq_lo - window);
    if (!dead) {
      const uint8_t* k_t = ks + s * L::kKvBytes;
      const uint8_t* v_t = vs + s * L::kKvBytes;
      // ---- S = q k^T (64 x 64 per warpgroup) ----
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int a = (kk * 16) / L::kAtomCols;
        const int cb = ((kk * 16) % L::kAtomCols) * 2;
        const uint64_t da = gmma_desc(
            q_wg + a * kTcBlockQ * L::kRowBytes + cb, 16, 8 * L::kRowBytes,
            L::kLayoutType);
        const uint64_t db = gmma_desc(k_t + a * kBlockK * L::kRowBytes + cb,
                                      16, 8 * L::kRowBytes, L::kLayoutType);
        wgmma_ss_n64(sc, da, db, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // ---- online softmax on the fragments (log2 domain) ----
      const bool edge = (k_hi >= skv) || (causal && k_hi > wq_lo) ||
                        (window >= 0 && k_lo <= wq_hi - window);
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float v = sc[i] * scale_log2;
        if (edge) {
          const int kpos = k_lo + 8 * (i / 4) + col0 + (i % 2);
          const int qpos = qpos_a + 8 * ((i / 2) % 2);
          const bool ok = kpos < skv && (!causal || kpos <= qpos) &&
                          (window < 0 || kpos > qpos - window);
          v = ok ? v : __int_as_float(0xff800000);  // -inf
        }
        sc[i] = v;
        if ((i / 2) % 2 == 0) {
          mx_a = fmaxf(mx_a, v);
        } else {
          mx_b = fmaxf(mx_b, v);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float corr_a = exp2f(m_a - mx_a), corr_b = exp2f(m_b - mx_b);
      m_a = mx_a;
      m_b = mx_b;
      // p rounded to bf16, packed in the A layout of m64nNk16: k-step kk
      // takes accumulator registers 8 kk .. 8 kk + 7.
      uint32_t pa[4][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const bool row_b = (i / 2) % 2;
        const float mrow = row_b ? mx_b : mx_a;
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(
            exp2f(sc[i] - mrow), exp2f(sc[i + 1] - mrow));
        const float2 pr = __bfloat1622float2(p2);
        if (row_b) {
          sum_b += pr.x + pr.y;
        } else {
          sum_a += pr.x + pr.y;
        }
        pa[i / 8][(i % 8) / 2] = *reinterpret_cast<const uint32_t*>(&p2);
      }
      l_a = l_a * corr_a + sum_a;   // per-thread partial sums; reduced at
      l_b = l_b * corr_b + sum_b;   // the end over the 4 threads of a row
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= ((i / 2) % 2) ? corr_b : corr_a;

      // ---- o += p v ----
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        // v tile (keys x dh) read MN-major: 8-key groups 8 * kRowBytes
        // apart, dh atoms kBlockK * kRowBytes apart.
        const uint64_t dv =
            gmma_desc(v_t + kk * 16 * L::kRowBytes, kBlockK * L::kRowBytes,
                      8 * L::kRowBytes, L::kLayoutType);
        wgmma_pv<DH>(acc, pa[kk], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
    }
    mbar_arrive(&empty[s]);   // this thread is done with stage s
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* op = o + static_cast<size_t>(bh) * sq * DH;
#pragma unroll
  for (int i = 0; i < DH / 2; i += 2) {
    const bool rb = (i / 2) % 2;
    const int row = row_a + (rb ? 8 : 0);
    if (row < sq) {
      const float den = rb ? den_b : den_a;
      const int col = 8 * (i / 4) + col0;
      *reinterpret_cast<__nv_bfloat162*>(op + static_cast<size_t>(row) * DH +
                                         col) =
          __floats2bfloat162_rn(acc[i] / den, acc[i + 1] / den);
    }
  }
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int sq, int skv, int causal, int window,
               int q_offset, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  flash_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq / hkv, sq, skv,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

// Error codes of the tensor-map step, above CUDA's own.
constexpr int kErrNoEncode = 100000;   // driver entry point not found
constexpr int kErrEncode = 100001;     // cuTensorMapEncodeTiled refused

using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the CUDA runtime has
// already loaded: found once with dlsym, so the library needs no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiledFn>(
                              dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Tensor map of a (heads, rows, dh) bf16 array, boxes of one swizzle atom
// (atom_cols x box_rows x 1); reads out of bounds are zero-filled.
int make_map(CUtensorMap* map, const void* base, int heads, int rows, int dh,
             int box_rows, int atom_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncode;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(dh) * 2,
                                 static_cast<cuuint64_t>(rows) * dh * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(atom_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int DH>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int b,
                int hq, int hkv, int sq, int skv, int causal, int window,
                int q_offset, cudaStream_t stream) {
  using L = TcLayout<DH>;
  const CUtensorMapSwizzle sw =
      DH == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap q_map, k_map, v_map;
  int rc = make_map(&q_map, q, b * hq, sq, DH, kTcBlockQ, L::kAtomCols, sw);
  if (rc == 0) rc = make_map(&k_map, k, b * hkv, skv, DH, kBlockK, L::kAtomCols, sw);
  if (rc == 0) rc = make_map(&v_map, v, b * hkv, skv, DH, kBlockK, L::kAtomCols, sw);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (sq + kTcBlockQ - 1) / kTcBlockQ);
  const double scale = 1.0 / sqrt(static_cast<double>(DH));
  const float scale_log2 = static_cast<float>(scale * 1.4426950408889634);
  flash_wgmma_kernel<DH><<<grid, kTcThreads, L::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), hq / hkv, sq, skv,
      causal, window, q_offset, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

#define REPRO_K3_DISPATCH(FN)                                                 \
  switch (dh) {                                                               \
    case 32:                                                                  \
      return FN<32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,          \
                    q_offset, s);                                             \
    case 64:                                                                  \
      return FN<64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,          \
                    q_offset, s);                                             \
    case 128:                                                                 \
      return FN<128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window,         \
                     q_offset, s);                                            \
    default:                                                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
  }

}  // namespace
}  // namespace repro_torch

extern "C" {

// Launch K3 on `stream`.  q (b, hq, sq, dh), k and v (b, hkv, skv, dh) and
// o like q, all contiguous on the device; dtype 0 = f32 (the CUDA-core
// kernel), 1 = bf16 (the tensor-core kernel; q, k and v 16 B aligned for
// TMA); dh in {32, 64, 128}; hq % hkv == 0; window < 0 means none.
// Returns cudaGetLastError() after the launch (0 on success), or a code of
// the tensor-map step (k3_error_string names it).
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
    REPRO_K3_DISPATCH(launch_f32)
  }
  if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v)) % 16 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    REPRO_K3_DISPATCH(launch_bf16)
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* k3_error_string(int code) {
  if (code == repro_torch::kErrNoEncode) {
    return "cuTensorMapEncodeTiled not found in libcuda.so.1";
  }
  if (code == repro_torch::kErrEncode) {
    return "cuTensorMapEncodeTiled refused the tensor map";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
