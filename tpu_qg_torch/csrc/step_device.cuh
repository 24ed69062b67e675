// The step's point body (step_lap, step_tendency, step_update), shared by
// every step kernel, and the tile design that runs it (step_tile): K8, and
// K1, K9, K12 and K18 on the shapes the row-streaming design does not take
// (step_kernel.cu, lab_kernel.cu), and the first one-launch kernels K15,
// K15's sharded form and K17 (fused_kernels.cu). K1, K9, K12 and K18 run
// the same body in the row-streaming design (step_rows in step_rows.cuh),
// so every step kernel gives the same bits for the same point. Design
// notes in step_kernel.cu.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int TX = 32;    // tile rows (x, strided axis)
constexpr int TY = 64;    // tile columns (y, contiguous axis)

// Float constants, each rounded once on the host from its float64 value
// (the plain version's Python-scalar constants round the same way).
struct StepConsts {
  float inv_dx2;      // 1/dx^2
  float half_inv_dx;  // 0.5/dx
  float jac_den;      // 12 dx^2
  float visc;
  float beta[2];      // per layer (one layer: beta)
  float U;
  float r;
  float dt;
  float two_dt;
  float ra;
  float c23;          // 23/12
  float c16;          // 16/12
  float c5;           // 5/12
};
constexpr int kNumConsts = sizeof(StepConsts) / sizeof(float);

// The point body. Every step kernel forms each point from these three
// functions, in this order of operations, so that the compiler contracts
// the same products into the same FMAs in each of them.

// lap at a point from its centre and its four neighbours.
__device__ __forceinline__ float step_lap(float c, float xm, float xp, float ym,
                                          float yp, float inv_dx2) {
  return ((((xm + xp) - 4.0f * c) + ym) + yp) * inv_dx2;
}

// K18's tendency bodies (lab_kernel.cu; tpu_qg/ops/_stencil_lab.py BODIES):
// K1's body (also the lab's legacy and aligned variants), every neighbour
// read as the centre, the x neighbours read as the centre, no Jacobian.
constexpr int kBodyBase = 0;
constexpr int kBodyNorot = 1;
constexpr int kBodyNoslice = 2;
constexpr int kBodyNojac = 3;

// Layer l's tendency at a point of an L-layer step. lap(a, b), zeta(a, b)
// and psi(a, b) read lap(psi), zeta and psi at x + a, y + b (a, b in -1, 0,
// 1; lap at the point and its four neighbours only), beta() reads c.beta[l]
// and wind() F(y), added on layer 0 when `wind_on`: the body reads each
// where K1's first tile body read it, so the tile kernels keep their
// schedule. kBody as in step_tile: nojac drops the Jacobian, nojac and
// noslice drop one layer's U term, as tpu_qg's bodies do.
template <int L, int kBody = kBodyBase, class Lap, class Zeta, class Psi,
          class Beta, class Wind>
__device__ __forceinline__ float step_tendency(const StepConsts& c, int l,
                                               Lap lap, Zeta zeta, Psi psi,
                                               Beta beta, bool wind_on,
                                               Wind wind) {
  constexpr bool kOneLayerU = kBody == kBodyBase || kBody == kBodyNorot;
  const float lap_c = lap(0, 0);
  const float visc_term =
      c.visc * step_lap(lap_c, lap(-1, 0), lap(1, 0), lap(0, -1), lap(0, 1),
                        c.inv_dx2);

  const float z_xp = zeta(1, 0), z_xm = zeta(-1, 0);
  const float z_yp = zeta(0, 1), z_ym = zeta(0, -1);
  const float z_xpyp = zeta(1, 1), z_xpym = zeta(1, -1);
  const float z_xmyp = zeta(-1, 1), z_xmym = zeta(-1, -1);
  const float p_xp = psi(1, 0), p_xm = psi(-1, 0);
  const float p_yp = psi(0, 1), p_ym = psi(0, -1);
  const float p_xpyp = psi(1, 1), p_xpym = psi(1, -1);
  const float p_xmyp = psi(-1, 1), p_xmym = psi(-1, -1);

  float tend = visc_term;
  if constexpr (kBody != kBodyNojac) {
    const float j_pp = (z_xp - z_xm) * (p_yp - p_ym)
                       - (z_yp - z_ym) * (p_xp - p_xm);
    const float j_pt = ((z_xp * (p_xpyp - p_xpym) - z_xm * (p_xmyp - p_xmym))
                        - z_yp * (p_xpyp - p_xmyp))
                       + z_ym * (p_xpym - p_xmym);
    const float j_tp = ((z_xpyp * (p_yp - p_xp) - z_xmym * (p_xm - p_ym))
                        - z_xmyp * (p_yp - p_xm))
                       + z_xpym * (p_xp - p_ym);
    tend = tend - ((j_pp + j_pt) + j_tp) / c.jac_den;
  }
  const float dpsi_dx = c.half_inv_dx * (p_xp - p_xm);

  tend = tend - beta() * dpsi_dx;
  if (l == 0) {
    if (L == 2 || kOneLayerU) {
      tend = tend - c.U * (c.half_inv_dx * (z_xp - z_xm));
    }
    if (L == 1) tend = tend - c.r * lap_c;
    if (wind_on) tend = tend + wind();
  } else {
    tend = tend - c.r * lap_c;
  }
  return tend;
}

// Whether the update reads f1 and f2: leapfrog reads f1 (the filtered
// previous level) from step 1 on, AB3 reads both from step 2 on.
__device__ __forceinline__ bool step_reads_f1(int leapfrog, int step) {
  return leapfrog ? step != 0 : step >= 2;
}
__device__ __forceinline__ bool step_reads_f2(int leapfrog, int step) {
  return !leapfrog && step >= 2;
}

// The time update of a point with centre zeta zc: zeta_new and the carry
// (the tendency under Euler/AB3, the filtered current level under
// leapfrog-RA). f1v() and f2v() read the history fields, only where
// step_reads_f1/f2 say.
template <class F1, class F2>
__device__ __forceinline__ void step_update(const StepConsts& c, int leapfrog,
                                            int step, float zc, float tend,
                                            F1 f1v, F2 f2v, float& zn,
                                            float& out) {
  if (leapfrog) {
    const float zpf = (step == 0) ? zc : f1v();
    zn = (step == 0) ? zc + c.dt * tend : zpf + c.two_dt * tend;
    out = zc + c.ra * ((zpf - 2.0f * zc) + zn);
  } else {
    if (step < 2) {
      zn = zc + c.dt * tend;
    } else {
      zn = zc + c.dt * ((c.c23 * tend - c.c16 * f1v()) + c.c5 * f2v());
    }
    out = tend;
  }
}

// v, opaque to the compiler. A thread that forms several points passes
// through this an operand of each product two of its points would share:
// a shared product is formed once and not contracted into an FMA, and the
// points would not give the bits of a kernel that forms one at a time.
__device__ __forceinline__ float opaque(float v) {
  asm volatile("" : "+f"(v));
  return v;
}

// K8's modal projection P^-1 = [[q11, q12], [q21, q22]].
struct ModalConsts {
  float q11, q12, q21, q22;
};
constexpr int kNumModalConsts = sizeof(ModalConsts) / sizeof(float);

// step_tile's shared memory: psi with a halo of 2, zeta and lap(psi) with a
// halo of 1, and (kModes) layer 0's zeta_new.
struct StepTiles {
  float (*ps)[TY + 4];
  float (*zs)[TY + 2];
  float (*lp)[TY + 2];
  float (*zn0)[TY];
};
constexpr int kStepTileFloats =
    (TX + 4) * (TY + 4) + 2 * (TX + 2) * (TY + 2) + TX * TY;

// The exchanged row slabs of a sharded step (K12, K15's sharded form), each
// an (L, H, P) field, H >= 2: the block owns rows 0 .. M-1, row -k (k <= H)
// is row H - k of the top slab and row M + k (k < H) row k of the bottom
// slab. The y wrap stays local to the block.
struct Slabs {
  const float* zeta_top;
  const float* zeta_bot;
  const float* psi_top;
  const float* psi_bot;
  int H;
};

// Row gx (-2 <= gx < M + 2 + TX), column gy of layer l of a sharded block
// (`layer` = the block's layer l): rows above the block from the top slab,
// rows at M and below from the bottom slab; rows past the bottom slab feed
// no output row of the tile (the stencil reaches 2 rows) and load as 0.
template <bool kL2>
__device__ __forceinline__ float slab_ld(const float* layer, const float* top,
                                         const float* bot, int l, int gx,
                                         int gy, int M, int P, int H) {
  if (gx < 0) return ld<kL2>(top + ((size_t)l * H + H + gx) * P + gy);
  if (gx >= M) {
    return gx - M < H ? ld<kL2>(bot + ((size_t)l * H + gx - M) * P + gy)
                      : 0.0f;
  }
  return ld<kL2>(layer + (size_t)gx * P + gy);
}

// K8's and K9's tiles in static shared memory (zn0 only where the modes need
// it).
#define STATIC_STEP_TILES(kModes)                      \
  __shared__ float ps[TX + 4][TY + 4];                 \
  __shared__ float zs[TX + 2][TY + 2];                 \
  __shared__ float lp[TX + 2][TY + 2];                 \
  __shared__ float zn0[(kModes) ? TX : 1][TY];         \
  const StepTiles tiles{ps, zs, lp, zn0}

// The tiles carved from `smem` (kStepTileFloats floats).
__device__ __forceinline__ StepTiles step_tiles(float* smem) {
  float* zs = smem + (TX + 4) * (TY + 4);
  float* lp = zs + (TX + 2) * (TY + 2);
  return StepTiles{reinterpret_cast<float (*)[TY + 4]>(smem),
                   reinterpret_cast<float (*)[TY + 2]>(zs),
                   reinterpret_cast<float (*)[TY + 2]>(lp),
                   reinterpret_cast<float (*)[TY]>(lp + (TX + 2) * (TY + 2))};
}

// The step over the TX x TY tile at (x0, y0) for L layers, with NT threads a
// block, in the shared memory `t`. kModes (L = 2) also writes the modes
// P^-1 zeta_new: a thread visits the same tile points in both layers, so
// it keeps layer 0's zeta_new in shared memory until layer 1's is formed.
// kL2: see ld(). kTendOnly (K9) writes the tendency to zeta_new and stops
// there: no f1/f2 reads, no update, no carry. kSharded (K12, K15's sharded
// form) reads the rows outside [0, M) from the slabs `sl` instead of
// wrapping. kBody (K18) swaps the tendency body: DX and DY are the x and y
// neighbour offsets, 0 where the body reads the centre in their place, and
// nojac and noslice drop one layer's U term, as tpu_qg's bodies do. Ends
// with a barrier: the caller may run the next tile.
template <int L, bool kModes, int NT, bool kL2, bool kTendOnly = false,
          bool kSharded = false, int kBody = kBodyBase>
__device__ __forceinline__ void step_tile(
    const float* __restrict__ zeta, const float* __restrict__ psi,
    const float* __restrict__ f1, const float* __restrict__ f2,
    const float* __restrict__ wind, float* __restrict__ zeta_new,
    float* __restrict__ carry, float* __restrict__ modes, int M, int P,
    const StepConsts& c, const ModalConsts& q, int leapfrog, int step, int x0,
    int y0, const StepTiles& t, Slabs sl = Slabs{}) {
  constexpr int DX = kBody == kBodyNorot || kBody == kBodyNoslice ? 0 : 1;
  constexpr int DY = kBody == kBodyNorot ? 0 : 1;
  float (*ps)[TY + 4] = t.ps;
  float (*zs)[TY + 2] = t.zs;
  float (*lp)[TY + 2] = t.lp;
  float (*zn0)[TY] = t.zn0;
  const size_t plane = (size_t)M * P;

  for (int l = 0; l < L; ++l) {
    const float* pl = psi + l * plane;
    const float* zl = zeta + l * plane;
    for (int idx = threadIdx.x; idx < (TX + 4) * (TY + 4); idx += NT) {
      const int i = idx / (TY + 4), j = idx % (TY + 4);
      if constexpr (kSharded) {
        ps[i][j] = slab_ld<kL2>(pl, sl.psi_top, sl.psi_bot, l, x0 - 2 + i,
                                (y0 - 2 + j + P) % P, M, P, sl.H);
      } else {
        const int gx = (x0 - 2 + i + M) % M, gy = (y0 - 2 + j + P) % P;
        ps[i][j] = ld<kL2>(pl + (size_t)gx * P + gy);
      }
    }
    for (int idx = threadIdx.x; idx < (TX + 2) * (TY + 2); idx += NT) {
      const int i = idx / (TY + 2), j = idx % (TY + 2);
      if constexpr (kSharded) {
        zs[i][j] = slab_ld<kL2>(zl, sl.zeta_top, sl.zeta_bot, l, x0 - 1 + i,
                                (y0 - 1 + j + P) % P, M, P, sl.H);
      } else {
        const int gx = (x0 - 1 + i + M) % M, gy = (y0 - 1 + j + P) % P;
        zs[i][j] = ld<kL2>(zl + (size_t)gx * P + gy);
      }
    }
    __syncthreads();

    // lap(psi) on the tile plus a ring of 1: lp[i][j] sits at ps[i+1][j+1].
    for (int idx = threadIdx.x; idx < (TX + 2) * (TY + 2); idx += NT) {
      const int i = idx / (TY + 2), j = idx % (TY + 2);
      lp[i][j] = step_lap(ps[i + 1][j + 1], ps[i + 1 - DX][j + 1],
                          ps[i + 1 + DX][j + 1], ps[i + 1][j + 1 - DY],
                          ps[i + 1][j + 1 + DY], c.inv_dx2);
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < TX * TY; idx += NT) {
      const int i = idx / TY, j = idx % TY;
      const int gx = x0 + i, gy = y0 + j;
      if (gx >= M || gy >= P) continue;
      // Centres: psi at ps[i+2][j+2], zeta and lap at [i+1][j+1].
      const int pi = i + 2, pj = j + 2, zi = i + 1, zj = j + 1;
      // DX and DY stand in for the neighbour offsets (0: the centre).
      const float tend = step_tendency<L, kBody>(
          c, l, [&](int a, int b) { return lp[zi + a * DX][zj + b * DY]; },
          [&](int a, int b) { return zs[zi + a * DX][zj + b * DY]; },
          [&](int a, int b) { return ps[pi + a * DX][pj + b * DY]; },
          [&] { return c.beta[l]; }, wind != nullptr,
          [&] { return wind[gy]; });

      const size_t at = (size_t)gx * P + gy;
      const size_t off = l * plane + at;
      if constexpr (kTendOnly) {
        zeta_new[off] = tend;
        continue;
      }
      float zn, out;
      step_update(c, leapfrog, step, zs[zi][zj], tend,
                  [&] { return ld<kL2>(f1 + off); },
                  [&] { return ld<kL2>(f2 + off); }, zn, out);
      zeta_new[off] = zn;
      carry[off] = out;
      if constexpr (kModes) {
        if (l == 0) {
          zn0[i][j] = zn;
        } else {
          modes[at] = q.q11 * zn0[i][j] + q.q12 * zn;
          modes[at + plane] = q.q21 * zn0[i][j] + q.q22 * zn;
        }
      }
    }
    __syncthreads();   // the next layer reuses the tiles
  }
}

inline StepConsts step_consts(const float* consts) {
  StepConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumConsts; ++k) dst[k] = consts[k];
  return c;
}

}  // namespace
