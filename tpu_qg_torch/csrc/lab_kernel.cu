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
// once, 201 MB at (2, 2048, 2048), 0.060 ms at 3.35 TB/s.
//
// Design: K1's row-streaming step (lab_rows_kernel: step_rows in
// step_rows.cuh with the body selector, in K1's launched layout for M, so
// the lab ablates the layout that ships; base's two-layer instance is K1's
// code and gives K1's bits). Each body reads its neighbours as step_tile
// does, so every variant gives the tile kernel's bits. The tile design
// (lab_step_kernel: step_tile, one block per 32 x 64 tile with psi (halo 2)
// and zeta (halo 1) in shared memory) keeps the shapes the row kernel does
// not take: P % 4 != 0, or an operand that is not 16-byte aligned.

#include <cuda_runtime.h>

#include <cstdint>

#include "step_device.cuh"
#include "step_rows.cuh"

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

// K18 in the row-streaming design: K1's step_rows with the lab's body.
template <int L, int kBody, int W, int NT, int D>
__global__ void __launch_bounds__(NT)
lab_rows_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
                const float* __restrict__ f1, const float* __restrict__ f2,
                const float* __restrict__ wind, float* __restrict__ zeta_new,
                float* __restrict__ carry, int M, int P, int R, StepConsts c,
                int leapfrog, int step) {
  step_rows<W, NT, D, false, L, kBody>(zeta, psi, f1, f2, wind, zeta_new,
                                       carry, M, P, R, c, leapfrog, step,
                                       Slabs{}, BlockUnit{});
}

template <int L, int kBody, int W, int NT, int D>
struct LabRowsTag {
  static constexpr int kL = L, kB = kBody, kW = W, kNT = NT, kD = D;
};

// Calls f(LabRowsTag<L, kBody, W, NT, D>{}) for an instance the source
// holds: L in {1, 2}, the four bodies, and K1's launched layouts (W = 256,
// NT = 128, D in {4, 8}); cudaErrorInvalidValue for any other.
template <class F>
int lab_rows_dispatch(int L, int body, int W, int NT, int D, F&& f) {
#define QG_LAB_CASE(l, b, d)                                             \
  if (L == l && body == b && W == 256 && NT == 128 && D == d)            \
    return f(LabRowsTag<l, b, 256, 128, d>{});
#define QG_LAB_D(l, b) QG_LAB_CASE(l, b, 4) QG_LAB_CASE(l, b, 8)
#define QG_LAB_BODIES(l)                                                 \
  QG_LAB_D(l, kBodyBase) QG_LAB_D(l, kBodyNorot) QG_LAB_D(l, kBodyNoslice) \
  QG_LAB_D(l, kBodyNojac)
  QG_LAB_BODIES(1) QG_LAB_BODIES(2)
#undef QG_LAB_BODIES
#undef QG_LAB_D
#undef QG_LAB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// K18 in the row-streaming design, in the layout (W, R, D, NT) (K1's: W
// columns a strip, R rows a run, D rows ahead, NT threads). P % 4 == 0 and
// every operand 16-byte aligned; arguments otherwise as qg_lab_step_launch.
extern "C" int qg_lab_rows_launch(const float* zeta, const float* psi,
                                  const float* f1, const float* f2,
                                  const float* wind, float* zeta_new,
                                  float* carry, int L, int M, int P,
                                  const float* consts, int body, int leapfrog,
                                  int step, int W, int R, int D, int NT,
                                  void* stream) {
  const bool ok = M >= 1 && P >= 4 && P % 4 == 0 && R >= 1 &&
                  aligned16(zeta) && aligned16(psi) && aligned16(f1) &&
                  aligned16(f2) && aligned16(wind) && aligned16(zeta_new) &&
                  aligned16(carry);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const StepConsts c = step_consts(consts);
  auto st = static_cast<cudaStream_t>(stream);
  return lab_rows_dispatch(L, body, W, NT, D, [&](auto tag) {
    using T = decltype(tag);
    constexpr int smem = RowsLayout<T::kW, T::kNT, T::kD>::kSmem;
    dim3 grid((P + T::kW - 1) / T::kW, (M + R - 1) / R, T::kL);
    lab_rows_kernel<T::kL, T::kB, T::kW, T::kNT, T::kD>
        <<<grid, T::kNT, smem, st>>>(zeta, psi, f1, f2, wind, zeta_new,
                                     carry, M, P, R, c, leapfrog, step);
    return static_cast<int>(cudaGetLastError());
  });
}

// An instance's compiled kernel: registers a thread, local memory (spills)
// in bytes a thread, dynamic shared memory in bytes a block, and the most
// blocks one SM of the current device holds.
extern "C" int qg_lab_rows_attributes(int L, int body, int W, int D, int NT,
                                      int* regs, int* local_bytes, int* smem,
                                      int* blocks_per_sm) {
  return lab_rows_dispatch(L, body, W, NT, D, [&](auto tag) {
    using T = decltype(tag);
    constexpr int bytes = RowsLayout<T::kW, T::kNT, T::kD>::kSmem;
    const void* fn = reinterpret_cast<const void*>(
        lab_rows_kernel<T::kL, T::kB, T::kW, T::kNT, T::kD>);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem = bytes;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn,
                                                        T::kNT, bytes);
    return static_cast<int>(err);
  });
}
