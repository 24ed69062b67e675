// K15, K16, K17 and K15's sharded form: the one-launch forms of tpu_qg's
// opt-in routes, each one cooperative kernel whose stages are separated by
// grid-wide barriers. All four here are their first forms: the persistent
// kernels of coop_rows.cuh, on the redesigned stages, take every shape where
// K1's row kernel (not K16), K2's factored kernels and (K17, K16) K3's
// cluster kernels all take it and the operands are 16-byte aligned
// (tpu_qg_torch/ops/step_kernel.py coop_rows_takes, dft_kernels.py
// mono_rows_takes), and these keep the rest: P <= 128; with the x stage
// also M in {384, 640, 768} or M < 256 G (K16's squares 128 .. 768 of its
// route gate); misaligned operand or slab views.
//
// K16 replaces tpu_qg/ops/pallas_fft.py PlanarFFT2.mono_invert
// (_build_mono_kernel): the packed inversion zeta -> psi of a planar
// (2, M, P) field, forward-y, the mirror-pair x-stage and inverse-y
// (K2 + K3 + K2^-1), in one launch.
// K17 replaces tpu_qg/ops/pallas_fullstep.py fused_step_full
// (_fullstep_kernel): K1's tendency and update over every tile, then K16's
// three stages on the packed zeta_new, in one launch.
// K15 replaces tpu_qg/ops/pallas_tendency.py fused_step_streamed_yspec
// (_yfused_kernel): K1 with psi arriving as the permuted y-spectrum of the
// packed psi_1 + i psi_2 (what K3 or K5 writes) and the packed zeta_new
// leaving also as its permuted y-spectrum (what K2 forward writes): the
// step of the y-fused chain, followed there by K3 or K4 + K5.
//
// The TPU kernels keep the whole 2048^2 field (33.6 MB) resident in VMEM
// across their stages. An SM has 228 KB of shared memory, so on Hopper the
// field stays in device memory (at 2048^2 it fits the 50 MB L2) and each
// stage is a grid-stride loop of tasks over it: rows of a y-transform
// (y_rows, K2's body), mirror pairs of the x-stage (pair_x_task, K3's body),
// 32 x 64 tiles of the step (step_tile, K1's body), each stage in one
// shared-memory buffer sized for the largest. A grid-wide barrier
// (cooperative_groups this_grid().sync(), under cudaLaunchCooperativeKernel
// with as many blocks as the card holds at once) orders every write of one
// stage before every read of the next. Stages work in place on an output
// buffer, as the TPU kernels do on their resident field: a task loads all
// it reads before it writes, and distinct tasks touch disjoint rows (y) or
// columns (x), so no scratch field is needed. Fields written earlier in the
// launch are read through L2 (ld<true>).
//
// K15's sharded form replaces tpu_qg/ops/pallas_tendency.py
// fused_step_streamed_yspec_sharded (:913, _yfused_kernel with
// sharded=True): K15 on one rank's (2, M, P) row block, with the rows above
// and below it from the (2, H, P) slabs its x-neighbours sent, psi's slabs as
// rows of its y-spectrum. The slab rows the stencil reads (2 of each psi
// slab) join the inverse-y stage, into two scratch slabs the wrapper
// allocates; the step stage reads them as K12 reads its slabs. Bound as
// K15: 7 (2, M, P) fields (235 MB at 2048^2 on one rank).
//
// K15's design: the TPU kernel inverse-transforms the psi rows of each row
// tile, halo rows included, in VMEM. A Hopper block that kept the five
// natural psi rows of the del^4 stencil in shared memory would need 320 KB
// at P = 8192, more than an SM has. K15 therefore stages the inverse-y
// through its zeta_ys output (natural psi there until the step has read
// it, then the forward-y of zeta_new), which takes every P the reference
// admits, up to 8192, with one code path, for one more write and read of a
// field.
//
// Bound: device-memory bandwidth, as for the kernels they fuse. K16 must
// read and write one field (67 MB at 2048^2; its ~0.92 GFLOP of transforms
// would take 69% of that time at the card's float32 rate); K17 and K15
// read zeta, psi, f1, f2 and write three fields (14 planes, 235 MB). This
// first form passes the field between stages through L2 and device memory
// (K16 three reads and writes of it, K17 and K15 one or two more than
// their bound), and every stage runs 512-thread blocks capped at 128
// registers, one block an SM: making them fast is later work.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_device.cuh"
#include "step_device.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCoopThreads = 512;

// Shapes and shared-memory layout of a one-launch kernel, built on the host
// (tpu_qg_torch/ops/dft_kernels.py coop_plan).
struct CoopPlan {
  int M, P;
  int logry, my, n1y, yrows;   // y: P = 2^logry * my, rows per y task
  int logrx, mx, C, subx, bstridex, xseq, xtasks;   // x-stage (K16, K17)
  int table;                   // float offset of the radix-2 table, past
                               // every stage's buffers
};
constexpr int kNumPlan = sizeof(CoopPlan) / sizeof(int);

// Device tables: radix-2 and join twiddles per axis, mirror-pair tasks.
struct CoopTables {
  const float2* twy;
  const float2* twny;
  const float2* twx;
  const float2* twnx;
  const int* own;
  const int* mir;
};

// The step's operands (K15, K17).
struct StepOperands {
  const float* zeta;
  const float* psi;            // K17: psi; K15: its permuted y-spectrum
  const float* f1;
  const float* f2;
  const float* wind;           // (P,) row or null
  float* zeta_new;
  float* carry;
  int leapfrog, step;
};

// The y-transform of every row, src -> dst (the same field: in place).
template <bool kMixed>
__device__ void y_stage(const float* src, float* dst, bool inverse,
                        const CoopPlan& p, const CoopTables& t, float* smem) {
  float2* stw = reinterpret_cast<float2*>(smem + p.table);
  for (int k = threadIdx.x; k < (1 << p.logry) / 2; k += blockDim.x)
    stw[k] = t.twy[k];
  __syncthreads();
  const size_t plane = (size_t)p.M * p.P;
  for (int row0 = blockIdx.x * p.yrows; row0 < p.M;
       row0 += gridDim.x * p.yrows)
    y_rows<kMixed, true>(src, dst, plane, row0, min(p.yrows, p.M - row0), p.P,
                         p.logry, p.my, p.n1y, inverse, stw, t.twny, smem);
}

// The mirror-pair x-stage on a y-spectral field, in place.
template <bool kMixed>
__device__ void x_stage(float* field, const SymConsts& c, const CoopPlan& p,
                        const CoopTables& t, float* smem) {
  float2* stw = reinterpret_cast<float2*>(smem + p.table);
  for (int k = threadIdx.x; k < (1 << p.logrx) / 2; k += blockDim.x)
    stw[k] = t.twx[k];
  __syncthreads();
  for (int k = blockIdx.x; k < p.xtasks; k += gridDim.x)
    pair_x_task<kMixed, true>(field, field, t.own + k * p.C, t.mir + k * p.C,
                              p.M, p.P, p.logrx, p.mx, p.n1y, p.C, p.subx,
                              p.bstridex, p.xseq != 0, c, stw, t.twnx, smem);
}

// K1's tendency and update on every tile, psi read (natural) from `psi`;
// the tiles' shared memory is the start of the stages' common buffer.
// kSharded: the rows outside the block come from the slabs `sl`.
template <bool kSharded = false>
__device__ void step_stage(const StepOperands& s, const float* psi,
                           const StepConsts& c, const CoopPlan& p,
                           float* smem, Slabs sl = Slabs{}) {
  const StepTiles tiles = step_tiles(smem);
  const int nty = (p.P + TY - 1) / TY;
  const int ntiles = ((p.M + TX - 1) / TX) * nty;
  for (int k = blockIdx.x; k < ntiles; k += gridDim.x)
    step_tile<2, false, kCoopThreads, true, false, kSharded>(
        s.zeta, psi, s.f1, s.f2, s.wind, s.zeta_new, s.carry, nullptr, p.M,
        p.P, c, ModalConsts{}, s.leapfrog, s.step, (k / nty) * TX,
        (k % nty) * TY, tiles, sl);
}

// The inverse-y of the psi slab rows the stencil reads (the last 2 rows of
// the top slab, the first 2 of the bottom one) into the same rows of
// top_nat and bot_nat, in tasks of at most p.yrows rows. Runs after
// y_stage, whose radix-2 table it reuses.
template <bool kMixed>
__device__ void slab_y_stage(const Slabs& sl, float* top_nat, float* bot_nat,
                             const CoopPlan& p, const CoopTables& t,
                             float* smem) {
  const float2* stw = reinterpret_cast<const float2*>(smem + p.table);
  const size_t plane = (size_t)sl.H * p.P;
  const int per = (2 + p.yrows - 1) / p.yrows;      // tasks per slab
  for (int k = blockIdx.x; k < 2 * per; k += gridDim.x) {
    const bool top = k < per;
    const int r0 = (k % per) * p.yrows;
    y_rows<kMixed, true>(top ? sl.psi_top : sl.psi_bot, top ? top_nat : bot_nat,
                         plane, (top ? sl.H - 2 : 0) + r0,
                         min(p.yrows, 2 - r0), p.P, p.logry, p.my, p.n1y, true,
                         stw, t.twny, smem);
  }
}

// K16: out = psi of the packed field z.
template <bool kMixedY, bool kMixedX>
__global__ void __launch_bounds__(kCoopThreads, 1)
coop_mono_kernel(const float* z, float* out, SymConsts c, CoopPlan p,
                 CoopTables t) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  y_stage<kMixedY>(z, out, false, p, t, smem);
  grid.sync();
  x_stage<kMixedX>(out, c, p, t, smem);
  grid.sync();
  y_stage<kMixedY>(out, out, true, p, t, smem);
}

// K17: zeta_new, carry, and psi_new = the packed inversion of zeta_new.
template <bool kMixedY, bool kMixedX>
__global__ void __launch_bounds__(kCoopThreads, 1)
coop_fullstep_kernel(StepOperands s, StepConsts sc, float* psi_new,
                     SymConsts c, CoopPlan p, CoopTables t) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  step_stage(s, s.psi, sc, p, smem);
  grid.sync();
  y_stage<kMixedY>(s.zeta_new, psi_new, false, p, t, smem);
  grid.sync();
  x_stage<kMixedX>(psi_new, c, p, t, smem);
  grid.sync();
  y_stage<kMixedY>(psi_new, psi_new, true, p, t, smem);
}

// K15: zeta_new, carry and zeta_ys from psi's y-spectrum s.psi.
template <bool kMixedY>
__global__ void __launch_bounds__(kCoopThreads, 1)
coop_yspec_kernel(StepOperands s, StepConsts sc, float* zeta_ys, CoopPlan p,
                  CoopTables t) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  y_stage<kMixedY>(s.psi, zeta_ys, true, p, t, smem);   // natural psi
  grid.sync();
  step_stage(s, zeta_ys, sc, p, smem);
  grid.sync();
  y_stage<kMixedY>(s.zeta_new, zeta_ys, false, p, t, smem);
}

// K15's sharded form: as K15, with the slabs `sl` (psi's as y-spectra);
// the natural psi slab rows go to top_nat and bot_nat, (2, H, P) each.
template <bool kMixedY>
__global__ void __launch_bounds__(kCoopThreads, 1)
coop_yspec_sharded_kernel(StepOperands s, StepConsts sc, float* zeta_ys,
                          CoopPlan p, CoopTables t, Slabs sl, float* top_nat,
                          float* bot_nat) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  y_stage<kMixedY>(s.psi, zeta_ys, true, p, t, smem);   // natural psi
  slab_y_stage<kMixedY>(sl, top_nat, bot_nat, p, t, smem);
  grid.sync();
  step_stage<true>(s, zeta_ys, sc, p, smem,
                   Slabs{sl.zeta_top, sl.zeta_bot, top_nat, bot_nat, sl.H});
  grid.sync();
  y_stage<kMixedY>(s.zeta_new, zeta_ys, false, p, t, smem);
}

CoopPlan coop_plan(const int* v) {
  CoopPlan p;
  int* dst = reinterpret_cast<int*>(&p);
  for (int k = 0; k < kNumPlan; ++k) dst[k] = v[k];
  return p;
}

CoopTables coop_tables(const void* twy, const void* twny, const void* twx,
                       const void* twnx, const int* own, const int* mir) {
  return CoopTables{static_cast<const float2*>(twy),
                    static_cast<const float2*>(twny),
                    static_cast<const float2*>(twx),
                    static_cast<const float2*>(twnx), own, mir};
}

// Launches `kernel` cooperatively with as many blocks as the card holds at
// once (blocks per SM at `smem` bytes of dynamic shared memory, times the
// SMs); info[0], info[1] = blocks, blocks per SM. A card without
// cooperative launch, or a kernel that does not fit one block an SM, is an
// error, never a fallback.
template <class... Params, class... Args>
int coop_launch(void (*kernel)(Params...), int smem, int* info, void* stream,
                Args... args) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if (int err = cudaGetDevice(&dev)) return err;
  if (int err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))
    return err;
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  if (int err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))
    return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  if (int err = set_smem(fn, smem)) return err;
  if (int err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kCoopThreads, smem))
    return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  info[0] = per_sm * sms;
  info[1] = per_sm;
  // Each argument converted to the kernel's parameter type.
  auto call = [&](Params... typed) -> int {
    void* argv[] = {static_cast<void*>(&typed)...};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        fn, dim3(per_sm * sms), dim3(kCoopThreads), argv, smem,
        static_cast<cudaStream_t>(stream)));
  };
  if (int err = call(args...)) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int qg_coop_plan_size() { return kNumPlan; }

// K16. plan: kNumPlan ints (CoopPlan); consts: kNumSymConsts floats.
extern "C" int qg_mono_launch(const float* z, float* out, const int* plan,
                              const float* consts, const void* twy,
                              const void* twny, const void* twx,
                              const void* twnx, const int* own, const int* mir,
                              int smem, int* info, void* stream) {
  const CoopPlan p = coop_plan(plan);
  const bool my = p.my > 1, mx = p.mx > 1;
  auto kernel = my ? (mx ? coop_mono_kernel<true, true>
                         : coop_mono_kernel<true, false>)
                   : (mx ? coop_mono_kernel<false, true>
                         : coop_mono_kernel<false, false>);
  return coop_launch(kernel, smem, info, stream, z, out, sym_consts(consts), p,
                     coop_tables(twy, twny, twx, twnx, own, mir));
}

// K17. step_c: kNumConsts floats (StepConsts); wind: a (P,) row or null.
extern "C" int qg_fullstep_launch(const float* zeta, const float* psi,
                                  const float* f1, const float* f2,
                                  const float* wind, float* zeta_new,
                                  float* carry, float* psi_new,
                                  const float* step_c, int leapfrog, int step,
                                  const int* plan, const float* consts,
                                  const void* twy, const void* twny,
                                  const void* twx, const void* twnx,
                                  const int* own, const int* mir, int smem,
                                  int* info, void* stream) {
  const CoopPlan p = coop_plan(plan);
  const bool my = p.my > 1, mx = p.mx > 1;
  auto kernel = my ? (mx ? coop_fullstep_kernel<true, true>
                         : coop_fullstep_kernel<true, false>)
                   : (mx ? coop_fullstep_kernel<false, true>
                         : coop_fullstep_kernel<false, false>);
  const StepOperands s{zeta, psi, f1, f2, wind, zeta_new, carry, leapfrog, step};
  return coop_launch(kernel, smem, info, stream, s, step_consts(step_c),
                     psi_new, sym_consts(consts), p,
                     coop_tables(twy, twny, twx, twnx, own, mir));
}

// K15. psi_ys: psi's permuted y-spectrum; step_c and wind as for K17.
extern "C" int qg_yspec_launch(const float* zeta, const float* psi_ys,
                               const float* f1, const float* f2,
                               const float* wind, float* zeta_new, float* carry,
                               float* zeta_ys, const float* step_c,
                               int leapfrog, int step, const int* plan,
                               const void* twy, const void* twny, int smem,
                               int* info, void* stream) {
  const CoopPlan p = coop_plan(plan);
  auto kernel = p.my > 1 ? coop_yspec_kernel<true> : coop_yspec_kernel<false>;
  const StepOperands s{zeta, psi_ys, f1, f2, wind, zeta_new, carry, leapfrog,
                       step};
  return coop_launch(kernel, smem, info, stream, s, step_consts(step_c),
                     zeta_ys, p,
                     coop_tables(twy, twny, nullptr, nullptr, nullptr, nullptr));
}

// K15's sharded form. zeta_top, zeta_bot: natural (2, H, P) slabs; psi_top,
// psi_bot: y-spectral (2, H, P) slabs; top_nat, bot_nat: (2, H, P) scratch.
extern "C" int qg_yspec_sharded_launch(
    const float* zeta, const float* psi_ys, const float* f1, const float* f2,
    const float* wind, float* zeta_new, float* carry, float* zeta_ys,
    const float* step_c, int leapfrog, int step, const int* plan,
    const void* twy, const void* twny, const float* zeta_top,
    const float* zeta_bot, const float* psi_top, const float* psi_bot, int H,
    float* top_nat, float* bot_nat, int smem, int* info, void* stream) {
  if (H < 2) return static_cast<int>(cudaErrorInvalidValue);
  const CoopPlan p = coop_plan(plan);
  auto kernel = p.my > 1 ? coop_yspec_sharded_kernel<true>
                         : coop_yspec_sharded_kernel<false>;
  const StepOperands s{zeta, psi_ys, f1, f2, wind, zeta_new, carry, leapfrog,
                       step};
  return coop_launch(kernel, smem, info, stream, s, step_consts(step_c),
                     zeta_ys, p,
                     coop_tables(twy, twny, nullptr, nullptr, nullptr, nullptr),
                     Slabs{zeta_top, zeta_bot, psi_top, psi_bot, H}, top_nat,
                     bot_nat);
}
