// K1: the fused two-layer step kernel (tendency + time update in one pass),
// K8: the same step for one or two layers with the modal projection as a
// third output, K9: the tendency alone, and K12: K1 on one rank's row block
// of a sharded grid.
//
// Per layer l of the (L, M, P) fields (axis 1 = x, axis 2 = y, y contiguous):
//   tend = visc*lap(lap(psi)) - J(zeta, psi) - beta_l*d(psi)/dx
//          - {U*d(zeta)/dx (l = 0) | r*lap(psi) (l = 1)} (+ F(y) on l = 0)
// (one layer: both U*d(zeta)/dx and r*lap(psi), with beta), then the
// Euler/AB3 update (carry = tend) or the leapfrog/Robert-Asselin update
// (carry = the filtered current level). The term grouping follows
// tpu_qg/ops/stencils.py:92-111 and models/core.py:57-92, as does the plain
// version (tpu_qg_torch.ops.step_kernel.fused_step_plain). Every kernel here
// forms a point with the same three functions (step_lap, step_tendency,
// step_update in step_device.cuh), so all of them give the same bits.
//
// K1 and K12: the row-streaming step (step_rows_kernel and
// step_rows_sharded_kernel; K9 runs it too, tendency_rows_kernel, with the
// f1/f2 loads, the update and the carry cut). K1 replaces tpu_qg/ops/pallas_tendency.py:555
// fused_step_streamed (v4, _streamed_kernel) and :997 fused_step_pre_fft
// (v3, its single-tile form); K12 replaces :608
// fused_step_streamed_sharded. The TPU kernel is itself a double-buffered
// pipeline of row tiles through VMEM; this is that idea at the size of one
// SM, not a block-by-block copy of it.
//
// Bound: device-memory bandwidth. A step reads zeta, psi, f1 and f2 and
// writes zeta_new and the carry: six (2, M, P) fields, 201 MB at 2048^2 and
// 3216 MB at 8192^2 (0.060 and 0.960 ms at 3.35 TB/s), ~63 float32
// operations a point, far below the float32 rate. A block also reads the
// halo of its strip and run again: (W + 8)/W x (R + 4)/R of a field on psi
// and (W + 8)/W x (R + 2)/R on zeta (1.13 and 1.09 at W = 128, R = 64),
// most of it from L2, where the neighbouring blocks of the launch order
// (strips fastest) read the same rows.
//
// Design. A block takes one layer, one strip of W contiguous y columns and
// one run of R consecutive x rows, and walks its run G = 4 NT / W rows at
// a time, each of its NT threads owning 4 consecutive columns of one row.
// Shared memory holds three rings of rows of W + 8 floats (4 halo columns
// a side, so every piece is 16-byte aligned): psi and zeta (S = G + 3 + D
// slots: the rows
// x-1 .. x+G+1 a group reads, and D rows ahead), and lap(psi) (G + 2
// slots: rows x-1 .. x+G, each formed once). One thread fills the psi and
// zeta rings: per row three 1-D cp.async.bulk copies a field (the strip,
// and the two 16-byte halo pieces at (y0 - 4) mod P and (y0 + w) mod P, the
// only place the y wrap is taken), completing on the slot's mbarrier; the
// row's source is picked once a row: (x + M) mod M for K1, for K12 the top
// slab above the block, the bottom slab below it. The producer keeps D rows
// beyond the next group's in flight, so the card has loads in flight while
// the block forms lap(psi) and the body. A group: every thread issues its
// 16-byte loads of f1 and f2 (only where the scheme reads them), waits on
// the slots of the rows it newly needs (the mbarrier phase of the row's
// fill), forms its lap(psi) row, a block barrier, the body of its row
// (float4 reads of the rings, 16-byte stores of zeta_new and the carry), a
// block barrier, and the producer refills the slots the group freed. The
// wind row is read once, 16 bytes a thread. The layout (W, R, D, NT) comes
// from the host by shape (tpu_qg_torch.ops.step_kernel.STEP_ROWS_BY_M, from
// chip_smoke.py's k1_sweep). Shapes with P % 4 != 0, or operands not
// 16-byte aligned, take the tile design below (step_kernel,
// step_sharded_kernel).
//
// Bits: a thread forms four points from the same registers, and a product
// that two of them share would be formed once and not contracted into an
// FMA; opaque() keeps that product each point's own, so K1 and K12 give
// the tile design's bits (chip_smoke.py holds K1 bitwise against the tile
// kernel, step_kernel).
//
// The tile design (step_tile in step_device.cuh; K8, and K1, K9 and K12 on
// the shapes above): one 256-thread block per 32 x 64 tile, the layers in
// turn; psi (halo 2) and zeta (halo 1) land in shared memory with the
// periodic wrap done in the load index, lap(psi) is formed once on the tile
// plus a ring of 1, and every stencil neighbour is then a shared-memory
// read.

#include <cuda_runtime.h>

#include <cstdint>

#include "step_device.cuh"
#include "step_rows.cuh"

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
// _tendencies. K1's body with the update cut off (kTendOnly): it reads zeta
// and psi and writes the tendency, three (L, M, P) fields, 101 MB at 2048^2
// and 1611 MB at 8192^2 for two layers (0.030 and 0.481 ms at 3.35 TB/s).
// Two kernels: K1's row-streaming design (tendency_rows_kernel, below; the
// f1/f2 loads and the carry cut, one 16-byte tendency store a thread a row)
// on P % 4 == 0 with 16-byte aligned operands, and this tile kernel on the
// rest; both give the same bits.
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

// ---------------------------------------------------------------------------
// The row-streaming step (K1, K12): design in the header, body (step_rows)
// in step_rows.cuh.
// ---------------------------------------------------------------------------

// K1 in the row-streaming design.
template <int W, int NT, int D>
__global__ void __launch_bounds__(NT)
step_rows_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
                 const float* __restrict__ f1, const float* __restrict__ f2,
                 const float* __restrict__ wind, float* __restrict__ zeta_new,
                 float* __restrict__ carry, int M, int P, int R, StepConsts c,
                 int leapfrog, int step) {
  step_rows<W, NT, D, false>(zeta, psi, f1, f2, wind, zeta_new, carry, M, P,
                             R, c, leapfrog, step, Slabs{}, BlockUnit{});
}

// K12 in the row-streaming design: the rows outside [0, M) from the slabs.
template <int W, int NT, int D>
__global__ void __launch_bounds__(NT)
step_rows_sharded_kernel(const float* __restrict__ zeta,
                         const float* __restrict__ psi,
                         const float* __restrict__ f1,
                         const float* __restrict__ f2,
                         const float* __restrict__ wind,
                         float* __restrict__ zeta_new,
                         float* __restrict__ carry, int M, int P, int R,
                         StepConsts c, int leapfrog, int step, Slabs sl) {
  step_rows<W, NT, D, true>(zeta, psi, f1, f2, wind, zeta_new, carry, M, P,
                            R, c, leapfrog, step, sl, BlockUnit{});
}

// K9 in the row-streaming design: K1's step_rows with the update cut off.
template <int L, int W, int NT, int D>
__global__ void __launch_bounds__(NT)
tendency_rows_kernel(const float* __restrict__ zeta,
                     const float* __restrict__ psi,
                     const float* __restrict__ wind, float* __restrict__ tend,
                     int M, int P, int R, StepConsts c) {
  step_rows<W, NT, D, false, L, kBodyBase, true>(
      zeta, psi, nullptr, nullptr, wind, tend, nullptr, M, P, R, c, 0, 0,
      Slabs{}, BlockUnit{});
}

template <int W, int NT, int D>
struct RowsTag {
  static constexpr int kW = W, kNT = NT, kD = D;
};

// Calls f(RowsTag<W, NT, D>{}) for a layout of the sweep: W in {128, 256},
// NT = 128, D in {2, 4, 8}; cudaErrorInvalidValue for any other.
template <class F>
int rows_dispatch(int W, int NT, int D, F&& f) {
#define QG_ROWS_CASE(w, nt, d) \
  if (W == w && NT == nt && D == d) return f(RowsTag<w, nt, d>{});
#define QG_ROWS_D(w, nt) \
  QG_ROWS_CASE(w, nt, 2) QG_ROWS_CASE(w, nt, 4) QG_ROWS_CASE(w, nt, 8)
  QG_ROWS_D(128, 128) QG_ROWS_D(256, 128)
#undef QG_ROWS_D
#undef QG_ROWS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// K1 (sharded = 0) and K12 (sharded = 1) in the row-streaming design, in
// the layout (W, R, D, NT): W columns a strip, R rows a run, D rows
// ahead, NT threads. P % 4 == 0 and every operand 16-byte
// aligned; for K12 zeta_top .. psi_bot are (2, H, P) device slabs, H >= 2
// (null for K1).
extern "C" int qg_step_rows_launch(const float* zeta, const float* psi,
                                   const float* f1, const float* f2,
                                   const float* wind, float* zeta_new,
                                   float* carry, int M, int P,
                                   const float* consts, int leapfrog,
                                   int step, int W, int R, int D, int NT,
                                   int sharded, const float* zeta_top,
                                   const float* zeta_bot,
                                   const float* psi_top, const float* psi_bot,
                                   int H, void* stream) {
  const bool ok =
      M >= 1 && P >= 4 && P % 4 == 0 && R >= 1 && aligned16(zeta) &&
      aligned16(psi) && aligned16(f1) && aligned16(f2) && aligned16(wind) &&
      aligned16(zeta_new) && aligned16(carry) &&
      (!sharded || (H >= 2 && aligned16(zeta_top) && aligned16(zeta_bot) &&
                    aligned16(psi_top) && aligned16(psi_bot)));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const StepConsts c = step_consts(consts);
  const Slabs sl{zeta_top, zeta_bot, psi_top, psi_bot, H};
  auto st = static_cast<cudaStream_t>(stream);
  return rows_dispatch(W, NT, D, [&](auto tag) {
    using T = decltype(tag);
    constexpr int smem = RowsLayout<T::kW, T::kNT, T::kD>::kSmem;
    dim3 grid((P + T::kW - 1) / T::kW, (M + R - 1) / R, 2);
    if (sharded) {
      step_rows_sharded_kernel<T::kW, T::kNT, T::kD><<<grid, T::kNT, smem, st>>>(
          zeta, psi, f1, f2, wind, zeta_new, carry, M, P, R, c, leapfrog,
          step, sl);
    } else {
      step_rows_kernel<T::kW, T::kNT, T::kD><<<grid, T::kNT, smem, st>>>(
          zeta, psi, f1, f2, wind, zeta_new, carry, M, P, R, c, leapfrog,
          step);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// A layout's compiled kernel: registers a thread, local memory (spills) in
// bytes a thread, dynamic shared memory in bytes a block, and the most
// blocks one SM of the current device holds.
extern "C" int qg_step_rows_attributes(int W, int D, int NT, int sharded,
                                       int* regs, int* local_bytes, int* smem,
                                       int* blocks_per_sm) {
  return rows_dispatch(W, NT, D, [&](auto tag) {
    using T = decltype(tag);
    constexpr int bytes = RowsLayout<T::kW, T::kNT, T::kD>::kSmem;
    const void* fn =
        sharded ? reinterpret_cast<const void*>(
                      step_rows_sharded_kernel<T::kW, T::kNT, T::kD>)
                : reinterpret_cast<const void*>(
                      step_rows_kernel<T::kW, T::kNT, T::kD>);
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

// K9 in the row-streaming design, L layers (1 or 2), in the layout (W, R, D,
// NT) of the sweep. P % 4 == 0 and every operand 16-byte aligned; wind and
// tend as qg_tendency_launch.
extern "C" int qg_tendency_rows_launch(const float* zeta, const float* psi,
                                       const float* wind, float* tend, int L,
                                       int M, int P, const float* consts,
                                       int W, int R, int D, int NT,
                                       void* stream) {
  const bool ok = (L == 1 || L == 2) && M >= 1 && P >= 4 && P % 4 == 0 &&
                  R >= 1 && aligned16(zeta) && aligned16(psi) &&
                  aligned16(wind) && aligned16(tend);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const StepConsts c = step_consts(consts);
  auto st = static_cast<cudaStream_t>(stream);
  return rows_dispatch(W, NT, D, [&](auto tag) {
    using T = decltype(tag);
    constexpr int smem = RowsLayout<T::kW, T::kNT, T::kD>::kSmem;
    dim3 grid((P + T::kW - 1) / T::kW, (M + R - 1) / R, L);
    auto kernel = L == 2 ? tendency_rows_kernel<2, T::kW, T::kNT, T::kD>
                         : tendency_rows_kernel<1, T::kW, T::kNT, T::kD>;
    kernel<<<grid, T::kNT, smem, st>>>(zeta, psi, wind, tend, M, P, R, c);
    return static_cast<int>(cudaGetLastError());
  });
}

// K9's row kernel for L layers in a layout: as qg_step_rows_attributes.
extern "C" int qg_tendency_rows_attributes(int L, int W, int D, int NT,
                                           int* regs, int* local_bytes,
                                           int* smem, int* blocks_per_sm) {
  if (L != 1 && L != 2) return static_cast<int>(cudaErrorInvalidValue);
  return rows_dispatch(W, NT, D, [&](auto tag) {
    using T = decltype(tag);
    constexpr int bytes = RowsLayout<T::kW, T::kNT, T::kD>::kSmem;
    const void* fn =
        L == 2 ? reinterpret_cast<const void*>(
                     tendency_rows_kernel<2, T::kW, T::kNT, T::kD>)
               : reinterpret_cast<const void*>(
                     tendency_rows_kernel<1, T::kW, T::kNT, T::kD>);
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
