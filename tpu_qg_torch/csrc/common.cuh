// Small helpers shared by every kernel source of tpu_qg_torch.
#pragma once

#include <cuda_runtime.h>

namespace {

// Reads one float of a field. kL2 reads through L2 only (ld.global.cg): the
// one-launch kernels (fused_kernels.cu) read fields that other blocks wrote
// earlier in the same launch, which the non-coherent read-only path is not
// guaranteed to see; every other kernel reads only its inputs.
template <bool kL2>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (kL2) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// A read of a field by a kernel body: the read-only path (__ldg) for a
// kernel's own input, or, with kL2, through L2 only, where a one-launch
// kernel (coop_rows.cuh) runs the body on a field written earlier in its
// launch.
template <bool kL2>
__device__ __forceinline__ float ldg(const float* p) {
  if constexpr (kL2) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

inline int set_smem(const void* kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace
