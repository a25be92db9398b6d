// Launch plans and resource queries of the four kernel libraries, for the
// port's static analyzer (repro_torch/analysis/kernel_budget.py).
//
// Each library's host code computes its launches in a plan function and
// launches exactly what the plan says, so the plan query that the analyzer
// calls and the launch cannot drift apart.  Each library exports:
//
//   kN_plan(<the launch's shape arguments>, int* out, int* n_launches)
//       the launches the same call would make, kPlanInts ints each;
//   kN_instances()            the number of kernel template instances;
//   kN_instance_name(i)       instance i's name;
//   kN_attributes(i, threads, smem, int* out)
//       cudaFuncGetAttributes of instance i, its CTAs per SM at `threads`
//       threads and `smem` dynamic bytes, and the card's limits
//       (kAttrInts ints).
//
// None of them launches anything.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace repro_torch {

// One device launch as the host code makes it: the kernel instance (an
// index into the library's instance table), the grid, the block and the
// dynamic shared memory in bytes.
struct LaunchPlan {
  int instance;
  dim3 grid;
  dim3 block;
  size_t smem;
};

struct KernelInstance {
  const void* fn;
  const char* name;
};

constexpr int kPlanInts = 8;
constexpr int kAttrInts = 10;

inline void write_plan(const LaunchPlan& p, int* out) {
  out[0] = p.instance;
  out[1] = static_cast<int>(p.grid.x);
  out[2] = static_cast<int>(p.grid.y);
  out[3] = static_cast<int>(p.grid.z);
  out[4] = static_cast<int>(p.block.x);
  out[5] = static_cast<int>(p.block.y);
  out[6] = static_cast<int>(p.block.z);
  out[7] = static_cast<int>(p.smem);
}

// out: numRegs, sharedSizeBytes (static), localSizeBytes (spills and
// local arrays), maxThreadsPerBlock, CTAs per SM at (threads, smem), then
// the card's registers per SM, opt-in shared memory per block, SM count,
// shared memory per SM and constSizeBytes.  The dynamic shared-memory
// limit is raised for the occupancy query as the launch raises it, and
// restored after, so the query leaves the function as it found it.
inline int query_attributes(const KernelInstance& k, int threads, int smem,
                            int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int prior = a.maxDynamicSharedSizeBytes;
  if (smem > prior) {
    err = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int ctas = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, k.fn, threads, static_cast<size_t>(smem));
  if (smem > prior) {
    const cudaError_t restore = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, prior);
    if (err == cudaSuccess) err = restore;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, regs_sm = 0, optin = 0, sms = 0, smem_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&regs_sm,
                                 cudaDevAttrMaxRegistersPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[kAttrInts] = {a.numRegs,
                               static_cast<int>(a.sharedSizeBytes),
                               static_cast<int>(a.localSizeBytes),
                               a.maxThreadsPerBlock,
                               ctas,
                               regs_sm,
                               optin,
                               sms,
                               smem_sm,
                               static_cast<int>(a.constSizeBytes)};
  for (int i = 0; i < kAttrInts; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace repro_torch

// The three instance queries of a library whose instance table is the
// array `TABLE` (in namespace repro_torch's anonymous namespace).
#define REPRO_INSTANCE_QUERIES(PREFIX, TABLE)                               \
  extern "C" int PREFIX##_instances() {                                     \
    return static_cast<int>(sizeof(repro_torch::TABLE) /                    \
                            sizeof(repro_torch::TABLE[0]));                 \
  }                                                                         \
  extern "C" const char* PREFIX##_instance_name(int i) {                    \
    return i >= 0 && i < PREFIX##_instances() ? repro_torch::TABLE[i].name  \
                                              : nullptr;                    \
  }                                                                         \
  extern "C" int PREFIX##_attributes(int i, int threads, int smem,          \
                                     int* out) {                            \
    if (i < 0 || i >= PREFIX##_instances())                                 \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    return repro_torch::query_attributes(repro_torch::TABLE[i], threads,    \
                                         smem, out);                        \
  }
