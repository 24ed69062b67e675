// K15, K16, K17 and K15's sharded form on the redesigned stages: persistent
// cooperative kernels whose stages are work loops over the units of K1's
// row-streaming kernel (step_rows), K2's factored kernels
// (y_factored_block, y_mixed_group) and K3's cluster kernels
// (pair_cluster_tile), separated by grid-wide barriers.
//
// K17 (coop_fullstep_rows_kernel) replaces tpu_qg/ops/pallas_fullstep.py
// fused_step_full (:308, _fullstep_kernel): the step, then the packed
// inversion of zeta_new (forward-y, the mirror-pair x-stage, inverse-y), in
// one launch. K16 (coop_mono_rows_kernel) replaces tpu_qg/ops/pallas_fft.py
// PlanarFFT2.mono_invert (:1342, _build_mono_kernel): K17's last three
// stages on a packed field z. K15 (coop_yspec_rows_kernel) replaces
// tpu_qg/ops/pallas_tendency.py fused_step_streamed_yspec (:839,
// _yfused_kernel): inverse-y of psi's permuted y-spectrum, the step, and
// forward-y of the packed zeta_new. K15's sharded form
// (coop_yspec_sharded_rows_kernel) replaces its
// fused_step_streamed_yspec_sharded (:913, _yfused_kernel with
// sharded=True): K15 on one rank's (2, m, P) row block, its first stage also
// turning the (2, H, P) psi slabs' y-spectra into natural rows, its step
// reading the slabs as K12 does. Each computes what its first form in
// fused_kernels.cu computes. Which form takes a shape: K15, K17 and K15's
// sharded form run here where K1's row kernel, K2's factored or mixed
// kernel at 256 threads and (K17) K3's cluster or mixed cluster kernel all
// take it and every operand is 16-byte aligned
// (tpu_qg_torch/ops/step_kernel.py coop_rows_takes); K16 where K2's and
// K3's kernels take it and z and out are aligned (dft_kernels.py
// mono_rows_takes: the squares 896 .. 2176 of its route gate); the first
// forms keep the rest (P <= 128; with the x stage also M in {384, 640,
// 768} or M < 256 G; misaligned views).
//
// Bound: device-memory bandwidth, 7 (2, M, P) fields each for the step
// kernels (zeta, psi, f1 and f2 read; zeta_new, the carry and psi_new or
// zeta_ys written): 235 MB at 2048^2, 0.070 ms at 3.35 TB/s; 3758 MB at
// 8192^2, 1.122 ms; K16 2 fields, 67 MB at 2048^2, 0.020 ms. The first
// forms run the first stage bodies (K1's 32 x 64 tile, K2's whole row, K3's
// whole columns) in 512-thread blocks, one an SM, and lose to the separate
// redesigned kernels they fuse (PERF.md).
//
// Design. One launch, every block co-resident, stages separated by
// cg::this_grid().sync(); each stage runs its separate kernel's body on its
// separate kernel's units, in a loop over them, with that kernel's layout,
// so that every stage gives its separate kernel's bits:
//   step   K1's row units (strip, run of R rows, layer) in the layout (W, R,
//          D, NT) = (256, R, 8, 128), R that of K1's launched layout at M
//          (step_rows_launched), or more where the units would not all
//          run at once on the grid (unit_rows: R = 69 for K17 at 2048^2, 683
//          for K15 at 8192^2; a point's bits do not depend on the layout,
//          tests/test_torch_step_rows.py): a 256-thread block runs two units at once,
//          one a 128-thread half, each with its own bulk-copy ring and
//          mbarriers (StepLay::kSmem bytes) and named barrier 1 + half. Before
//          a unit its half meets at its barrier and its thread 0 issues a
//          proxy fence, so that the ring's generic reads by the last unit, and
//          fields written earlier in the launch by other blocks, are ordered
//          before the unit's bulk copies; step_rows then re-arms the
//          mbarriers (every copy of the last unit was waited on).
//   y      K2's factored row groups (Rb rows, 256 threads; the mixed-radix
//          form on P = 128 n, n not a power of two), the layout of K2's
//          launched one (y_dft_factored_launched), its tables built once a
//          stage (the power-of-two form's, as its kernel's, once a group);
//          the field read through L2 (ldg<true>). A group loads all
//          its rows before it stores any, so K17's and K16's inverse-y runs
//          in place. K15's sharded form's first stage runs, after the
//          block's groups, K2's groups over each psi slab as an H-row field
//          (plane stride H P, as K2 on the slab), into two scratch slabs.
//   x      (K17, K16) K3's cluster tile pairs in K3's launched layout (G, Cw)
//          (pair_x_cluster_launched; (8, 16) at 2048^2), the launch itself
//          clustered by G: cluster k runs tile pairs k, k + clusters, ...
//          of K3's table, in place (each block loads all it reads
//          of both tiles before the cluster barrier that precedes its first
//          store, and stores only what it loaded), reading through L2.
// The grid: K17 and K16 as many clusters of G blocks of 256 threads as the
// card holds at once (cudaOccupancyMaxActiveClusters under the cooperative
// attribute), K15 and its sharded form, unclustered, as many blocks as fit;
// all two blocks an SM, at most 128 registers a thread, K3's cluster
// kernel's budget (K15 at three an SM, K2's 80-register budget, spilled
// 0.6-1.1 KB a thread and took 0.237 ms at 2048^2 against 0.209 at two;
// PERF.md). Shared memory is
// one buffer for the largest stage: K3's tile buffers (96.7 KB at 2048^2),
// K2's Rb p-rows, or the two step units' rings (2 x 31.8 KB; K16 has no
// step stage, reserves no ring and arms no mbarrier). A launch that
// the card refuses, or a layout with no resident cluster, is an error,
// never a fallback to the first forms.
//
// Memory order: a grid barrier orders every write of a stage before every
// read of the next; a field written earlier in the launch is read through L2
// (ld.global.cg), never the non-coherent path, and by the step's bulk
// copies only behind the proxy fence above.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dft_device.cuh"
#include "step_rows.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kRowsThreads = kClusterThreads;   // 256
constexpr int kUnitThreads = 128;               // K1's NT
constexpr int kUnitsPerBlock = kRowsThreads / kUnitThreads;
constexpr int kStepW = 256, kStepD = 8;
using StepLay = RowsLayout<kStepW, kUnitThreads, kStepD>;
static_assert(StepLay::kSmem % 16 == 0, "each unit's ring 16-byte aligned");

// The host's plan (tpu_qg_torch/ops/step_kernel.py coop_rows_plan; K16's
// dft_kernels.py mono_rows_plan).
struct RowsPlan {
  int M, P;
  int R;                       // rows a step unit (K16: 0, no step stage)
  int yn2, ylogrb, yplan;      // y: N2 = P / 128, Rb = 2^ylogrb, the mixed
                               // form's packed plan (0: a power of two)
  int xn2, xlogg, xlogcw;      // x (K17, K16): N2 = M / 128, G, Cw
  int xtiles, xplan;           // K3's tile pairs, packed plan (0: 2^a)
  int n1y;                     // the y-spectrum's N1
  int stages;                  // stages run (K17 4, K15, K16 and K15's
                               // sharded form 3; fewer leave the last
                               // one's output, to check it alone)
};
constexpr int kNumRowsPlan = sizeof(RowsPlan) / sizeof(int);

// The step's operands (psi: K17's natural psi; K15's permuted y-spectrum).
struct RowsOperands {
  const float* zeta;
  const float* psi;
  const float* f1;
  const float* f2;
  const float* wind;           // (P,) row or null
  float* zeta_new;
  float* carry;
  int leapfrog, step;
};

__device__ __forceinline__ int log2_exact(int n) { return 31 - __clz(n); }

// Orders this thread's generic-proxy view (shared memory its block read or
// wrote behind a barrier; device memory other blocks wrote behind a grid
// barrier) before the bulk copies it issues next.
__device__ __forceinline__ void fence_proxy_async_all() {
  asm volatile("fence.proxy.async;" ::: "memory");
}

// A step unit of the one-launch kernels: half `half` of the block (128
// threads, named barrier 1 + half) runs K1's unit (strip, run, layer) in
// its own StepLay::kSmem bytes of shared memory.
struct HalfUnit {
  unsigned strip_, run_, layer_, half;
  unsigned char* ring;
  __device__ __forceinline__ unsigned strip() const { return strip_; }
  __device__ __forceinline__ unsigned run() const { return run_; }
  __device__ __forceinline__ unsigned layer() const { return layer_; }
  __device__ __forceinline__ unsigned tid() const {
    return threadIdx.x - half * kUnitThreads;
  }
  __device__ __forceinline__ unsigned char* smem() const { return ring; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;" :: "r"(half + 1), "r"(kUnitThreads)
                 : "memory");
  }
};

// The step stage: every unit of K1's row kernel at (256, p.R, 8, 128), u =
// strip + strips (run + runs layer) as K1's blockIdx, two at a time a block
// (kSharded: K12's, the rows outside the block from the slabs `sl`).
// Each unit arms its ring's mbarriers (step_rows) and, once its half has
// passed every wait, invalidates them, so that the next unit's init and the
// later stages' use of the memory find no live mbarrier there.
template <bool kSharded = false>
__device__ __forceinline__ void rows_step_stage(const RowsOperands& s,
                                                const float* psi,
                                                const StepConsts& c,
                                                const RowsPlan& p,
                                                unsigned char* smem,
                                                const Slabs& sl = Slabs{}) {
  const unsigned half = threadIdx.x / kUnitThreads;
  const int strips = (p.P + kStepW - 1) / kStepW;
  const int runs = (p.M + p.R - 1) / p.R;
  const int units = 2 * strips * runs;
  for (int u = blockIdx.x * kUnitsPerBlock + half; u < units;
       u += gridDim.x * kUnitsPerBlock) {
    const HalfUnit unit{static_cast<unsigned>(u % strips),
                        static_cast<unsigned>((u / strips) % runs),
                        static_cast<unsigned>(u / (strips * runs)), half,
                        smem + half * StepLay::kSmem};
    unit.sync();
    if (unit.tid() == 0) fence_proxy_async_all();
    step_rows<kStepW, kUnitThreads, kStepD, kSharded>(
        s.zeta, psi, s.f1, s.f2, s.wind, s.zeta_new, s.carry, p.M, p.P, p.R,
        c, s.leapfrog, s.step, sl, unit);
    unit.sync();
    if (unit.tid() == 0) {
      auto* bar = reinterpret_cast<unsigned long long*>(unit.ring);
      for (int k = 0; k < StepLay::S; ++k) mbar_inval(&bar[k]);
    }
  }
}

// The y stage: every row group of K2's factored kernel (its mixed-radix form
// for kMixed), in -> out (K17's inverse: in place).
template <bool kMixed, bool kInverse>
__device__ __forceinline__ void rows_y_stage(const float* in, float* out,
                                             const RowsPlan& p,
                                             const float2* __restrict__ wm,
                                             unsigned char* smem) {
  float2* S = reinterpret_cast<float2*>(smem);
  const int n2 = p.yn2;
  if constexpr (kMixed) {
    y_mixed_tables<kRowsThreads>(S, n2, p.ylogrb, p.yplan, wm);
    __syncthreads();
  }
  const int groups = (p.M + (1 << p.ylogrb) - 1) >> p.ylogrb;
  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    if constexpr (kMixed) {
      y_mixed_group<kRowsThreads, kInverse, true>(in, out, p.M, n2, p.ylogrb,
                                                  p.yplan, S, g);
    } else {   // its tables, a block barrier, the group
      y_factored_block<kRowsThreads, kInverse, true>(
          in, out, p.M, log2_exact(n2), p.ylogrb, wm, S, g);
    }
    __syncthreads();   // the next group reuses the p-rows
  }
}

// K15's sharded form's first stage: rows_y_stage's inverse groups over the
// block (psi -> zeta_ys), then over each psi slab of sl as an H-row field
// (psi_top -> top_nat, psi_bot -> bot_nat); group g of that list by block
// g mod gridDim.x, so that the slabs' groups fill the block's last round.
template <bool kMixed>
__device__ __forceinline__ void rows_y_slabs_stage(
    const float* psi, float* zeta_ys, const Slabs& sl, float* top_nat,
    float* bot_nat, const RowsPlan& p, const float2* __restrict__ wm,
    unsigned char* smem) {
  float2* S = reinterpret_cast<float2*>(smem);
  const int n2 = p.yn2;
  if constexpr (kMixed) {
    y_mixed_tables<kRowsThreads>(S, n2, p.ylogrb, p.yplan, wm);
    __syncthreads();
  }
  const int rb = 1 << p.ylogrb;
  const int block_groups = (p.M + rb - 1) >> p.ylogrb;
  const int slab_groups = (sl.H + rb - 1) >> p.ylogrb;
  for (int g = blockIdx.x; g < block_groups + 2 * slab_groups;
       g += gridDim.x) {
    const float* in = psi;
    float* out = zeta_ys;
    int rows = p.M, k = g;
    if (g >= block_groups) {
      const bool top = g < block_groups + slab_groups;
      in = top ? sl.psi_top : sl.psi_bot;
      out = top ? top_nat : bot_nat;
      rows = sl.H;
      k = g - block_groups - (top ? 0 : slab_groups);
    }
    if constexpr (kMixed) {
      y_mixed_group<kRowsThreads, true, true>(in, out, rows, n2, p.ylogrb,
                                              p.yplan, S, k);
    } else {
      y_factored_block<kRowsThreads, true, true>(
          in, out, rows, log2_exact(n2), p.ylogrb, wm, S, k);
    }
    __syncthreads();   // the next group reuses the p-rows
  }
}

// K17's and K16's x stage: every tile pair of K3's cluster kernel (its
// mixed instance for kMixed), in place, cluster k taking pairs k,
// k + clusters, ...
template <bool kMixed>
__device__ __forceinline__ void rows_x_stage(float* field,
                                             const SymConsts& c,
                                             const RowsPlan& p,
                                             const float2* __restrict__ wm,
                                             const int* __restrict__ own,
                                             const int* __restrict__ mir,
                                             float* smem) {
  const int clusters = gridDim.x >> p.xlogg;
  const int logn2 = kMixed ? 0 : log2_exact(p.xn2);
  for (int tile = blockIdx.x >> p.xlogg; tile < p.xtiles; tile += clusters) {
    pair_cluster_tile<kPairWhole, kMixed, true>(
        field, field, field, own, mir, own, p.P, p.P, logn2, p.xlogg,
        p.xlogcw, p.n1y, c, wm, smem, p.xn2, p.xplan, tile);
    __syncthreads();   // the next pair rewrites the slot table and buffers
  }
}

// K15: zeta_new, carry and zeta_ys (forward-y of zeta_new) from psi's
// permuted y-spectrum s.psi; zeta_ys holds natural psi until the step has
// read it.
template <bool kMixedY>
__global__ void __launch_bounds__(kRowsThreads, 2)
coop_yspec_rows_kernel(RowsOperands s, StepConsts sc, float* zeta_ys,
                       RowsPlan p, const float2* __restrict__ wmy) {
  extern __shared__ __align__(16) unsigned char coop_smem[];
  cg::grid_group grid = cg::this_grid();
  rows_y_stage<kMixedY, true>(s.psi, zeta_ys, p, wmy, coop_smem);
  if (p.stages < 2) return;
  grid.sync();
  rows_step_stage(s, zeta_ys, sc, p, coop_smem);
  if (p.stages < 3) return;
  grid.sync();
  rows_y_stage<kMixedY, false>(s.zeta_new, zeta_ys, p, wmy, coop_smem);
}

// K15's sharded form: K15 on a row block with the slabs sl (zeta's natural,
// psi's as rows of its y-spectrum); top_nat and bot_nat, (2, H, P) each,
// take the natural psi slabs for the step stage.
template <bool kMixedY>
__global__ void __launch_bounds__(kRowsThreads, 2)
coop_yspec_sharded_rows_kernel(RowsOperands s, StepConsts sc, float* zeta_ys,
                               RowsPlan p, const float2* __restrict__ wmy,
                               Slabs sl, float* top_nat, float* bot_nat) {
  extern __shared__ __align__(16) unsigned char coop_smem[];
  cg::grid_group grid = cg::this_grid();
  rows_y_slabs_stage<kMixedY>(s.psi, zeta_ys, sl, top_nat, bot_nat, p, wmy,
                              coop_smem);
  if (p.stages < 2) return;
  grid.sync();
  rows_step_stage<true>(s, zeta_ys, sc, p, coop_smem,
                        Slabs{sl.zeta_top, sl.zeta_bot, top_nat, bot_nat,
                              sl.H});
  if (p.stages < 3) return;
  grid.sync();
  rows_y_stage<kMixedY, false>(s.zeta_new, zeta_ys, p, wmy, coop_smem);
}

// K17: zeta_new, carry and psi_new = the packed inversion of zeta_new.
template <bool kMixedY, bool kMixedX>
__global__ void __launch_bounds__(kRowsThreads, 2)
coop_fullstep_rows_kernel(RowsOperands s, StepConsts sc, float* psi_new,
                          SymConsts c, RowsPlan p,
                          const float2* __restrict__ wmy,
                          const float2* __restrict__ wmx,
                          const int* __restrict__ own,
                          const int* __restrict__ mir) {
  extern __shared__ __align__(16) unsigned char coop_smem[];
  cg::grid_group grid = cg::this_grid();
  rows_step_stage(s, s.psi, sc, p, coop_smem);
  if (p.stages < 2) return;
  grid.sync();
  rows_y_stage<kMixedY, false>(s.zeta_new, psi_new, p, wmy, coop_smem);
  if (p.stages < 3) return;
  grid.sync();
  rows_x_stage<kMixedX>(psi_new, c, p, wmx, own, mir,
                        reinterpret_cast<float*>(coop_smem));
  if (p.stages < 4) return;
  grid.sync();
  rows_y_stage<kMixedY, true>(psi_new, psi_new, p, wmy, coop_smem);
}

// K16: out = psi of the packed natural-order field z (K17's stages 2-4).
template <bool kMixedY, bool kMixedX>
__global__ void __launch_bounds__(kRowsThreads, 2)
coop_mono_rows_kernel(const float* z, float* out, SymConsts c, RowsPlan p,
                      const float2* __restrict__ wmy,
                      const float2* __restrict__ wmx,
                      const int* __restrict__ own,
                      const int* __restrict__ mir) {
  extern __shared__ __align__(16) unsigned char coop_smem[];
  cg::grid_group grid = cg::this_grid();
  rows_y_stage<kMixedY, false>(z, out, p, wmy, coop_smem);
  if (p.stages < 2) return;
  grid.sync();
  rows_x_stage<kMixedX>(out, c, p, wmx, own, mir,
                        reinterpret_cast<float*>(coop_smem));
  if (p.stages < 3) return;
  grid.sync();
  rows_y_stage<kMixedY, true>(out, out, p, wmy, coop_smem);
}

RowsPlan rows_plan(const int* v) {
  RowsPlan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int k = 0; k < kNumRowsPlan; ++k) dst[k] = v[k];
  return p;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// True iff the plan is one this source runs: with the step stage its row
// units (R >= 1), K2's factored layouts (2 <= N2 <= 64, a power of two or
// a packed plan), and, with the x stage, K3's cluster layouts (G in {4, 8,
// 16}, Cw in {4, 8, 16}, U = ceil(N2 / 2) >= G); at most one stage a kind
// but two y stages.
bool plan_ok(const RowsPlan& p, bool x_stage, bool step_stage = true) {
  const bool pow2y = (p.yn2 & (p.yn2 - 1)) == 0;
  bool ok = p.M >= 1 && p.P == 128 * p.yn2 && p.yn2 >= 2 && p.yn2 <= 64 &&
            p.R >= (step_stage ? 1 : 0) && p.ylogrb >= 0 &&
            (pow2y == (p.yplan == 0)) && p.stages >= 1 &&
            p.stages <= 2 + x_stage + step_stage;
  if (x_stage) {
    const bool pow2x = (p.xn2 & (p.xn2 - 1)) == 0;
    ok = ok && p.M == 128 * p.xn2 && p.xlogg >= 2 && p.xlogg <= 4 &&
         p.xlogcw >= 2 && p.xlogcw <= 4 && p.xtiles >= 1 &&
         (p.xn2 + 1) / 2 >= (1 << p.xlogg) && (pow2x == (p.xplan == 0));
  }
  return ok;
}

bool operands_ok(const RowsOperands& s) {
  return aligned16(s.zeta) && aligned16(s.psi) && aligned16(s.f1) &&
         aligned16(s.f2) && aligned16(s.wind) && aligned16(s.zeta_new) &&
         aligned16(s.carry);
}

// The launch of `kernel`: cooperative, clustered by 2^logg when logg > 0,
// with as many blocks (clusters) as the card holds at once; info[0] =
// blocks, info[1] = clusters (0 unclustered), info[2] = blocks an SM holds.
// `attr` must outlive the launch.
template <class Kernel>
int rows_config(Kernel kernel, int smem, int logg, void* stream,
                cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[2],
                int* info) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (int err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                       dev))
    return err;
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (int err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev))
    return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (int err = set_smem(fn, smem)) return err;
  if (logg > 3) {
    if (int err = static_cast<int>(cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
      return err;
  }
  if (int err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kRowsThreads, smem))
    return err;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1 << logg;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(kRowsThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = logg > 0 ? 2 : 1;
  int blocks = per_sm * sms, clusters = 0;
  if (logg > 0) {
    cfg.gridDim = dim3(1 << logg);
    if (int err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg))
      return err;
    blocks = clusters << logg;
  }
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(blocks);
  info[0] = blocks;
  info[1] = clusters;
  info[2] = per_sm;
  return 0;
}

// The rows a step unit on `blocks` blocks: K1's launched R, or more, so
// that the units (two a block) all run in one round.
int unit_rows(const RowsPlan& p, int blocks) {
  const int strips = (p.P + kStepW - 1) / kStepW;
  const int runs = max(1, blocks * kUnitsPerBlock / (2 * strips));
  return max(p.R, (p.M + runs - 1) / runs);
}

// K17's launch with the x stage's instance kMixedX (the y stage's by the
// plan): the checks, the grid, the step units' rows and the launch. Each
// kMixedX is instantiated in a source of its own (coop_fullstep.cu,
// coop_fullstep_mixed.cu), so that the kernels build in parallel.
template <bool kMixedX>
int fullstep_rows_launch(const float* zeta, const float* psi, const float* f1,
                         const float* f2, const float* wind, float* zeta_new,
                         float* carry, float* psi_new, const float* step_c,
                         int leapfrog, int step, const int* plan,
                         const float* consts, const void* wmy,
                         const void* wmx, const int* own, const int* mir,
                         int smem, int* info, void* stream) {
  const RowsPlan p = rows_plan(plan);
  const RowsOperands s{zeta, psi, f1, f2, wind, zeta_new, carry, leapfrog,
                       step};
  if (!plan_ok(p, true) || !operands_ok(s) || !aligned16(psi_new) ||
      (p.yplan != 0 && !plan_fits(p.yplan, p.yn2)) ||
      (p.xplan != 0) != kMixedX ||
      (kMixedX && !plan_fits(p.xplan, p.xn2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p.yplan ? coop_fullstep_rows_kernel<true, kMixedX>
                        : coop_fullstep_rows_kernel<false, kMixedX>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  if (int err = rows_config(kernel, smem, p.xlogg, stream, cfg, attr, info))
    return err;
  RowsPlan q = p;
  q.R = info[3] = unit_rows(p, info[0]);
  if (int err = cudaLaunchKernelEx(&cfg, kernel, s, step_consts(step_c),
                                   psi_new, sym_consts(consts), q,
                                   static_cast<const float2*>(wmy),
                                   static_cast<const float2*>(wmx), own, mir))
    return err;
  return static_cast<int>(cudaGetLastError());
}

// K16's launch with the x stage's instance kMixedX (the y stage's by the
// plan), as fullstep_rows_launch's, in coop_mono.cu and coop_mono_mixed.cu.
template <bool kMixedX>
int mono_rows_launch(const float* z, float* out, const int* plan,
                     const float* consts, const void* wmy, const void* wmx,
                     const int* own, const int* mir, int smem, int* info,
                     void* stream) {
  const RowsPlan p = rows_plan(plan);
  if (!plan_ok(p, true, false) || !aligned16(z) || !aligned16(out) ||
      (p.yplan != 0 && !plan_fits(p.yplan, p.yn2)) ||
      (p.xplan != 0) != kMixedX ||
      (kMixedX && !plan_fits(p.xplan, p.xn2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p.yplan ? coop_mono_rows_kernel<true, kMixedX>
                        : coop_mono_rows_kernel<false, kMixedX>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  if (int err = rows_config(kernel, smem, p.xlogg, stream, cfg, attr, info))
    return err;
  if (int err = cudaLaunchKernelEx(&cfg, kernel, z, out, sym_consts(consts),
                                   p, static_cast<const float2*>(wmy),
                                   static_cast<const float2*>(wmx), own, mir))
    return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
