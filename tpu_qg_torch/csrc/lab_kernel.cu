// K18: the stencil lab's step, K1's step with its tendency body swapped per
// variant, for one or two layers.
//
// Replaces tpu_qg/ops/_stencil_lab.py lab_step (:325, _lab_kernel :253 with a
// body from BODIES :243-250), the ablation lab's streamed step; no model
// route runs it (tpu_qg_torch.scripts.stencil_lab times it). The bodies
// (kBody, step_device.cuh) keep the lab's values: base (K1's body; the lab's
// legacy and aligned variants compute the same values and differ only in TPU
// data layout, so they run this instance), norot (every neighbour read as
// the centre), noslice (the x neighbours read as the centre), nojac (no
// Arakawa term). norot and noslice read no neighbour, or no x neighbour,
// from shared memory; nojac skips the Jacobian's arithmetic.
//
// Bound: K1's (step_kernel.cu). Six (L, M, P) fields cross device memory
// once, 201 MB at (2, 2048, 2048). Design: the tile design (step_tile in
// step_device.cuh), one block per 32 x 64 tile with psi (halo 2) and zeta
// (halo 1) in shared memory. Base's two-layer instance runs the tile
// design's code with K1's body; it gives K1's bits, since K1's
// row-streaming kernel forms every point with the same body.

#include <cuda_runtime.h>

#include "step_device.cuh"

namespace {

constexpr int THREADS = 256;

template <int L, int kBody>
__global__ void __launch_bounds__(THREADS)
lab_step_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
                const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ wind, float* __restrict__ zeta_new,
                float* __restrict__ carry, int M, int P, StepConsts c,
                int leapfrog, int step) {
  STATIC_STEP_TILES(false);
  step_tile<L, false, THREADS, false, false, false, kBody>(
      zeta, psi, f1, f2, wind, zeta_new, carry, nullptr, M, P, c,
      ModalConsts{}, leapfrog, step, blockIdx.y * TX, blockIdx.x * TY, tiles);
}

using LabKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, float*, int,
                           int, StepConsts, int, int);

template <int L>
LabKernel lab_kernel_for(int body) {
  switch (body) {
    case kBodyBase: return lab_step_kernel<L, kBodyBase>;
    case kBodyNorot: return lab_step_kernel<L, kBodyNorot>;
    case kBodyNoslice: return lab_step_kernel<L, kBodyNoslice>;
    case kBodyNojac: return lab_step_kernel<L, kBodyNojac>;
    default: return nullptr;
  }
}

}  // namespace

// body: kBodyBase, kBodyNorot, kBodyNoslice or kBodyNojac; L: 1 or 2.
// consts: host array of kNumConsts floats in StepConsts order; wind: a (P,)
// device row, or null when the wind forcing is off.
extern "C" int qg_lab_step_launch(const float* zeta, const float* psi,
                                  const float* f1, const float* f2,
                                  const float* wind, float* zeta_new,
                                  float* carry, int L, int M, int P,
                                  const float* consts, int body, int leapfrog,
                                  int step, void* stream) {
  LabKernel kernel = L == 2 ? lab_kernel_for<2>(body)
                     : L == 1 ? lab_kernel_for<1>(body) : nullptr;
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((P + TY - 1) / TY, (M + TX - 1) / TX);
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      zeta, psi, f1, f2, wind, zeta_new, carry, M, P, step_consts(consts),
      leapfrog, step);
  return static_cast<int>(cudaGetLastError());
}
