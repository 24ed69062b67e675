// K13's and K14's block kernel on the mixed extents M = 128 * N2 (N2 =
// 2^c m, m odd > 1, N2 <= 63, ceil(N2 / 2) >= G):
// pair_cols_cluster_mixed_kernel<kCompanion>, the mixed instance of
// pair_cols_cluster_kernel (dft_kernels.cu, whose notes give the design and
// the TPU functions both replace), in a source of its own so that the
// build compiles it beside dft_kernels.cu. It runs on the 3072^2 mesh's K13
// block (2, 3072, 768) and the 1536 x 2048 mesh's K14 block (2, 1536, 512).
//
// It is K3 mixed's body (pair_x_cluster_mixed_kernel) on the block's tile
// tables, as the power-of-two block kernel is K3's: stage A over the plan
// y_dft_mixed_plan(N2), the pull through rho^-1, K5 mixed's symbol stage
// and sym_inverse_mixed, the loads and stores at row stride W. Its int maps
// follow the Cw global slots in shared memory (K3 mixed's bytes + 4 Cw).
// K13's form inverts and stores only the own tile (sym_inverse_mixed<true>:
// stage B^-1 over the own tile's nr Cw columns, the split cluster barrier's
// arrive in the own tile's pass).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dft_device.cuh"

namespace {

template <bool kCompanion>
__global__ void __launch_bounds__(kClusterThreads, 2)
pair_cols_cluster_mixed_kernel(const float* __restrict__ in,
                               const float* __restrict__ inm,
                               float* __restrict__ out,
                               const int* __restrict__ own_cols,
                               const int* __restrict__ mirror_cols,
                               const int* __restrict__ global_slots, int W,
                               int P, int n2, int logg, int logcw, int n1y,
                               SymConsts c, int plan,
                               const float2* __restrict__ wm) {
  extern __shared__ float smem[];
  pair_cluster_tile<kCompanion ? kPairCompanion : kPairBlock, true>(
      in, inm, out, own_cols, mirror_cols, global_slots, W, P, 0, logg,
      logcw, n1y, c, wm, smem, n2, plan);
}

// The mixed instance's shared memory: K3 mixed's and the tile's Cw global
// slots.
int pair_cols_cluster_mixed_smem(int n2, int logg, int logcw) {
  return pair_x_cluster_mixed_smem(n2, logg, logcw) +
         (1 << logcw) * static_cast<int>(sizeof(int));
}

using PairColsClusterMixedFn = void (*)(const float*, const float*, float*,
                                        const int*, const int*, const int*,
                                        int, int, int, int, int, int,
                                        SymConsts, int, const float2*);

PairColsClusterMixedFn pair_cols_cluster_mixed_fn(int own_only) {
  return own_only ? pair_cols_cluster_mixed_kernel<true>
                  : pair_cols_cluster_mixed_kernel<false>;
}

// The launch: K3 mixed's layouts (N2 not a power of two, 3 <= N2 <= 63, G =
// 2^logg in {4, 8, 16}, U = ceil(N2 / 2) >= G).
int pair_cols_cluster_mixed_config(int n2, int logg, int logcw, int own_only,
                                   int tiles, cudaStream_t stream,
                                   cudaLaunchConfig_t& cfg,
                                   cudaLaunchAttribute& attr) {
  if (logg < 2 || logg > 4 || n2 < 3 || n2 > 63 || (n2 & (n2 - 1)) == 0 ||
      (n2 + 1) / 2 < (1 << logg))
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(pair_cols_cluster_mixed_fn(own_only)),
      pair_cols_cluster_mixed_smem(n2, logg, logcw), logg, tiles, stream, cfg,
      attr);
}

}  // namespace

// The most clusters of the K13 (own_only) or K14 instance of
// pair_cols_cluster_mixed_kernel (M = 128 n2) in a layout that the card
// holds at once: 0 means the layout cannot run.
extern "C" int qg_pair_cols_cluster_mixed_occupancy(int n2, int logg,
                                                    int logcw, int own_only,
                                                    int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_cols_cluster_mixed_config(n2, logg, logcw, own_only, 1,
                                               nullptr, cfg, attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters,
      reinterpret_cast<const void*>(pair_cols_cluster_mixed_fn(own_only)),
      &cfg));
}

// K13 or K14 on a planar (2, 128 n2, W) block by the mixed instance, the
// tables, consts and wm as qg_pair_cols_cluster_launch's; plan: the radices
// of stage A in DIF order, one byte each (dft_kernels.y_dft_mixed_plan),
// whose product must be n2.
extern "C" int qg_pair_cols_cluster_mixed_launch(
    const float* in, const float* inm, float* out, const int* own_cols,
    const int* mirror_cols, const int* global_slots, int tiles, int W, int P,
    int n2, int logg, int logcw, int n1y, int own_only, const float* consts,
    int plan, const void* wm, void* stream) {
  if (!plan_fits(plan, n2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_cols_cluster_mixed_config(
          n2, logg, logcw, own_only, tiles,
          static_cast<cudaStream_t>(stream), cfg, attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, pair_cols_cluster_mixed_fn(own_only), in, inm, out, own_cols,
          mirror_cols, global_slots, W, P, n2, logg, logcw, n1y,
          sym_consts(consts), plan, static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
