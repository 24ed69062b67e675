// K1: the fused two-layer step kernel (tendency + time update in one pass),
// K8: the same step for one or two layers with the modal projection as a
// third output, K9: the tendency alone, and K12: K1 on one rank's row block
// of a sharded grid.
//
// K1 replaces tpu_qg/ops/pallas_tendency.py fused_step_streamed (v4,
// _streamed_kernel) and its single-tile form fused_step_pre_fft (v3,
// _step_pre_fft_kernel): one Hopper kernel covers both, since the TPU forms
// differ only in how they pipeline row tiles through VMEM.
//
// Per layer l of the (L, M, P) fields (axis 1 = x, axis 2 = y, y contiguous):
//   tend = visc*lap(lap(psi)) - J(zeta, psi) - beta_l*d(psi)/dx
//          - {U*d(zeta)/dx (l = 0) | r*lap(psi) (l = 1)} (+ F(y) on l = 0)
// (one layer: both U*d(zeta)/dx and r*lap(psi), with beta), then the
// Euler/AB3 update (carry = tend) or the leapfrog/Robert-Asselin update
// (carry = the filtered current level). The term grouping follows
// tpu_qg/ops/stencils.py:92-111 and models/core.py:57-92, as does the plain
// version (tpu_qg_torch.ops.step_kernel.fused_step_plain).
//
// Bound: device-memory bandwidth. Per step the kernel reads zeta, psi, f1, f2
// and writes zeta_new and the carry — six (2, M, P) fields, 6 x 33.5 MB at
// 2048^2 — and does ~60 flops per point. Design (step_tile in
// step_device.cuh): one block per 32 x 64 tile, the layers in turn; psi
// (halo 2) and zeta (halo 1) land in shared memory with the periodic wrap
// done in the load index, lap(psi) is formed once on the tile plus a ring
// of 1, and every stencil neighbour is then a
// shared-memory read. Threads walk the tile with y fastest, so each warp's
// global loads and stores are 128-byte contiguous runs along the contiguous
// axis.

#include <cuda_runtime.h>

#include "step_device.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
step_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
            const float* __restrict__ f1, const float* __restrict__ f2,
            const float* __restrict__ wind, float* __restrict__ zeta_new,
            float* __restrict__ carry, int M, int P, StepConsts c,
            int leapfrog, int step) {
  STATIC_STEP_TILES(false);
  step_tile<2, false, THREADS, false>(zeta, psi, f1, f2, wind, zeta_new, carry,
                                      nullptr, M, P, c, ModalConsts{},
                                      leapfrog, step, blockIdx.y * TX,
                                      blockIdx.x * TY, tiles);
}

// K8: replaces tpu_qg/ops/pallas_tendency.py fused_pre_inversion (v2,
// _pre_inversion_kernel), the step of the single-layer and pin-gauge
// configurations. Same tile, halo and update code as K1 (same bound); for
// L = 2 it also writes modes = P^-1 zeta_new, seven (2, M, P) fields per
// step against K1's six; for L = 1 the modes are zeta_new itself and
// nothing more is written.
template <int L>
__global__ void __launch_bounds__(THREADS)
pre_inversion_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
                     const float* __restrict__ f1, const float* __restrict__ f2,
                     const float* __restrict__ wind, float* __restrict__ zeta_new,
                     float* __restrict__ carry, float* __restrict__ modes, int M,
                     int P, StepConsts c, ModalConsts q, int leapfrog, int step) {
  STATIC_STEP_TILES(L == 2);
  step_tile<L, L == 2, THREADS, false>(zeta, psi, f1, f2, wind, zeta_new,
                                       carry, modes, M, P, c, q, leapfrog, step,
                                       blockIdx.y * TX, blockIdx.x * TY, tiles);
}

// K9: replaces tpu_qg/ops/pallas_tendency.py fused_tendency (:181, v1,
// _tendency_kernel), the tendency alone, a drop-in for models.core's
// _tendencies. K1's tile body with the update cut off (kTendOnly): it reads
// zeta and psi and writes the tendency, three (L, M, P) fields, 101 MB at
// 2048^2 and 1611 MB at 8192^2 for two layers; the same tile and halos as
// K1, so the same bandwidth bound.
template <int L>
__global__ void __launch_bounds__(THREADS)
tendency_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
                const float* __restrict__ wind, float* __restrict__ tend, int M,
                int P, StepConsts c) {
  STATIC_STEP_TILES(false);
  step_tile<L, false, THREADS, false, true>(
      zeta, psi, nullptr, nullptr, wind, tend, nullptr, nullptr, M, P, c,
      ModalConsts{}, 0, 0, blockIdx.y * TX, blockIdx.x * TY, tiles);
}

// K12: replaces tpu_qg/ops/pallas_tendency.py fused_step_streamed_sharded
// (:608, _streamed_kernel with sharded=True): K1 on one rank's (2, M, P) row
// block, the rows above and below the block read from the (2, H, P) slabs
// its x-neighbours sent (the TPU kernel's wrap fetches become slab reads;
// the y wrap stays local). The TPU kernel takes H = 8 rows, its sublane
// alignment; the stencil needs 2 rows of psi and 1 of zeta, and this
// kernel takes any H >= 2. Bound as K1: six (2, M, P) fields, the slabs
// negligible (201 MB at 2048^2 on one rank, 403 MB for a 2048-row block of
// 8192^2). Same tile and design as K1.
__global__ void __launch_bounds__(THREADS)
step_sharded_kernel(const float* __restrict__ zeta,
                    const float* __restrict__ psi, const float* __restrict__ f1,
                    const float* __restrict__ f2,
                    const float* __restrict__ wind, float* __restrict__ zeta_new,
                    float* __restrict__ carry, int M, int P, StepConsts c,
                    int leapfrog, int step, Slabs sl) {
  STATIC_STEP_TILES(false);
  step_tile<2, false, THREADS, false, false, true>(
      zeta, psi, f1, f2, wind, zeta_new, carry, nullptr, M, P, c,
      ModalConsts{}, leapfrog, step, blockIdx.y * TX, blockIdx.x * TY, tiles,
      sl);
}

}  // namespace

extern "C" int qg_step_num_consts() { return kNumConsts; }
extern "C" int qg_modal_num_consts() { return kNumModalConsts; }

// consts: host array of kNumConsts floats in StepConsts order.
// wind: a (P,) device row, or null when the wind forcing is off.
extern "C" int qg_step_launch(const float* zeta, const float* psi,
                              const float* f1, const float* f2,
                              const float* wind, float* zeta_new, float* carry,
                              int M, int P, const float* consts, int leapfrog,
                              int step, void* stream) {
  dim3 grid((P + TY - 1) / TY, (M + TX - 1) / TX);
  step_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      zeta, psi, f1, f2, wind, zeta_new, carry, M, P, step_consts(consts),
      leapfrog, step);
  return static_cast<int>(cudaGetLastError());
}

// modal: host array of kNumModalConsts floats (read for L = 2 only);
// modes: a (2, M, P) device field for L = 2, null for L = 1.
extern "C" int qg_pre_inversion_launch(const float* zeta, const float* psi,
                                       const float* f1, const float* f2,
                                       const float* wind, float* zeta_new,
                                       float* carry, float* modes, int L, int M,
                                       int P, const float* consts,
                                       const float* modal, int leapfrog,
                                       int step, void* stream) {
  if (L != 1 && L != 2) return static_cast<int>(cudaErrorInvalidValue);
  ModalConsts q{};
  if (L == 2) q = ModalConsts{modal[0], modal[1], modal[2], modal[3]};
  dim3 grid((P + TY - 1) / TY, (M + TX - 1) / TX);
  auto kernel = L == 2 ? pre_inversion_kernel<2> : pre_inversion_kernel<1>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      zeta, psi, f1, f2, wind, zeta_new, carry, modes, M, P,
      step_consts(consts), q, leapfrog, step);
  return static_cast<int>(cudaGetLastError());
}

// K9. wind: a (P,) device row, or null when the wind forcing is off; tend:
// an (L, M, P) device field.
extern "C" int qg_tendency_launch(const float* zeta, const float* psi,
                                  const float* wind, float* tend, int L, int M,
                                  int P, const float* consts, void* stream) {
  if (L != 1 && L != 2) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((P + TY - 1) / TY, (M + TX - 1) / TX);
  auto kernel = L == 2 ? tendency_kernel<2> : tendency_kernel<1>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      zeta, psi, wind, tend, M, P, step_consts(consts));
  return static_cast<int>(cudaGetLastError());
}

// K12. zeta_top .. psi_bot: (2, H, P) device slabs, H >= 2.
extern "C" int qg_step_sharded_launch(const float* zeta, const float* psi,
                                      const float* f1, const float* f2,
                                      const float* wind, float* zeta_new,
                                      float* carry, int M, int P,
                                      const float* consts, int leapfrog,
                                      int step, const float* zeta_top,
                                      const float* zeta_bot,
                                      const float* psi_top,
                                      const float* psi_bot, int H,
                                      void* stream) {
  if (H < 2) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((P + TY - 1) / TY, (M + TX - 1) / TX);
  step_sharded_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      zeta, psi, f1, f2, wind, zeta_new, carry, M, P, step_consts(consts),
      leapfrog, step, Slabs{zeta_top, zeta_bot, psi_top, psi_bot, H});
  return static_cast<int>(cudaGetLastError());
}
