// K10: the multigrid smoother (nu damped-Jacobi sweeps, optionally with the
// residual or the full-weighting restricted residual), and K11: the coarse
// correction plus post-smoother (u2 + bilinear prolongation of the coarse
// error, then nu sweeps), each one pass over the level's fields.
//
// K10 replaces tpu_qg/ops/pallas_mg.py mg_smooth (:340, _mg_kernel with
// _restrict_tile) and K11 replaces mg_prolong_smooth (:298,
// _mg_prolong_kernel with _prolong_tile).
//
// Per mode k of the (K, M, P) fields (axis 1 = x, axis 2 = y, y contiguous),
// with A_k = lap_5p + alpha_k at spacing dx in difference form:
//   sweep:    w <- w + (omega / diag_k) * (f - A_k w),  diag_k = alpha_k - 4/dx^2
//   residual: r = f - A_k w
//   restrict: rc[X, Y] = rows then columns of [1, 2, 1]/4 at fine (2X, 2Y)
//   prolong:  u2 + e, e rows first (even: ec[q]; odd: ec[q]/2 + ec[q+1]/2),
//             then columns (even: v[p]; odd: (v[p] + v[p+1])/2)
// The arithmetic follows the Pallas kernel's grouping term for term, with
// every add and multiply rounded on its own (__fadd_rn, __fmul_rn: no fused
// multiply-add), as the plain versions in tpu_qg_torch/ops/mg_kernels.py
// compute them; the constants (1/dx^2, alpha_k, omega/diag_k) are rounded
// once on the host from their float64 values. Both designs below form every
// point with the same functions (lap_alpha_pt, sweep_pt, fw3, prolong_v), so
// they give the same bits.
//
// Bound: device-memory bandwidth. K10 reads u and f and writes u and r (the
// residual form, four (K, M, P) fields), u and rc (the restrict form, 3.25
// fields) or u alone (three fields); K11 reads u2, f and ec and writes u
// (3.25 fields): at 8192^2 with K = 2, 1745 MB and 0.52 ms at 3.35 TB/s for
// the restrict form and K11. Some 13 float operations a point a sweep are
// far below the card's float32 rate.
//
// The row-streaming design (mg_rows_kernel<kForm, NU>: the four forms, smooth
// only, residual, restrict and prolong, of one body; nu = NU sweeps, 1 or 2).
// A warp takes one mode, one strip of kRowsW = 120 y columns and one run of R
// rows (R even, so a run starts at an even x), and walks down the run one
// row a step; the warps of a block take consecutive runs of one strip and
// share nothing. Lane l owns the 4 columns [4l, 4l + 4) of a 128-column ring
// row that starts at y0 - 4: the strip and 4 halo columns a side, so every
// lane's piece is 16-byte aligned. Loads: lane 0 keeps D rows ahead in flight
// in a ring of S = L + 1 + D shared-memory slots, each holding row x of u (or
// u2) and f, and for K11 coarse row ceil(x/2) of ec, by 1-D bulk copies
// (bulk_row: the strip and two 16-byte halo pieces, the only place the y wrap
// is taken) completing on the slot's mbarrier; the row source is (x + M) mod
// M. Sweeps as a pipeline in registers: at the step that row x enters, stage
// s (sweep s, then the residual) forms row x - s from the last three rows of
// stage s - 1, which the lane keeps in registers (its ring), the y neighbours
// of its 4 columns from the lanes beside it (__shfl_up/down), and f from the
// slot of its row, which stays live for L steps (nu, or nu + 1 with the
// residual). So stage s lags stage s - 1 by one row, and the x halo costs
// only the run's start-up, (R + 2 h)/R rows. Every stage forms all 128
// columns; a stage s columns from the ring's edge holds garbage there, and no
// stored point reads it (h <= 4: nu + residual + restriction within the ring
// row's halo). The restriction follows the residual: coarse row X from r at
// fine rows 2X - 1 .. 2X + 1, the last three rows of the residual's ring, when
// 2X + 1 enters it; an odd lane stores 4 coarse values (its two and its right
// neighbour's) in one 16-byte store. K11 forms u2 + e as the row enters (stage
// 0), fine row x from coarse rows floor(x/2) (slot x, or x - 1 where x is odd)
// and floor(x/2) + 1 (slot x). u, r and rc go out in 16-byte stores. No block
// barrier: a warp's own lanes meet at __syncwarp before lane 0 refills the
// slot the step freed. Layouts (R, D, threads) by level extent from the host
// (tpu_qg_torch.ops.mg_kernels.MG_ROWS_BY_M). Why it leaves the tile design
// below: there a block loads its whole window and then computes, so only the
// other blocks on the SM hide a load's latency; its 32 x 64 tile reads 1.41x
// the tile (restrict form) and computes every index with a run-time division
// and two wraps; its loads are 4-byte and unaligned, and each of its nu + 2
// passes ends in a block barrier (2.2 ms at 8192^2, 24% of the bound).
//
// The tile design (mg_smooth_kernel, mg_prolong_kernel: P % 4 != 0, nu > 2,
// a halo beyond 4 or an operand not 16-byte aligned): one block per 32 x 64
// tile and mode (blockIdx.z), 256 threads. The tile plus a halo of h = nu
// (+1 for the residual, +1 more for the restriction) of u and f lands in
// shared memory with the periodic wrap done in the load index; the nu sweeps
// run there, ping-ponging between two buffers with a barrier between sweeps.
// Each sweep leaves one ring fewer valid, so the halo is recomputed rather
// than exchanged (temporal blocking). The residual is formed on the tile
// (plus a ring of 1 for the restriction, whose 16 x 32 coarse tile starts at
// the even fine origin). K11 loads the coarse tile with a ring of
// ceil(nu/2) + 1, forms u2 + e on the tile plus a halo of nu, then sweeps as
// K10 does. Outputs go to new buffers: a tile's neighbours read its inputs as
// their halo.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_copy.cuh"
#include "common.cuh"

namespace {

constexpr int MG_TX = 32;        // tile rows (x, strided axis)
constexpr int MG_TY = 64;        // tile columns (y, contiguous axis)
constexpr int MG_THREADS = 256;
constexpr int kMaxModes = 4;
constexpr int kMaxHalo = 8;      // nu + residual + restrict

// inv_dx2 = 1/dx^2, and per mode alpha_k and cw_k = omega / diag_k.
struct MgConsts {
  float inv_dx2;
  float alpha[kMaxModes];
  float cw[kMaxModes];
};
constexpr int kNumMgConsts = sizeof(MgConsts) / sizeof(float);

__device__ __forceinline__ int wrap(int g, int n) {
  g %= n;
  return g < 0 ? g + n : g;
}

// floor(g / 2) for any sign.
__device__ __forceinline__ int half_floor(int g) { return (g - (g & 1)) / 2; }

// (lap + alpha) w at a point c with neighbours x + 1, x - 1, y + 1, y - 1,
// in the Pallas kernel's difference form (_lap_alpha_slab).
__device__ __forceinline__ float lap_alpha_pt(float c, float xp, float xm,
                                              float yp, float ym,
                                              float inv_dx2, float alpha) {
  const float lap = __fmul_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(xp, c), __fsub_rn(xm, c)),
                __fadd_rn(__fsub_rn(yp, c), __fsub_rn(ym, c))),
      inv_dx2);
  return __fadd_rn(lap, __fmul_rn(alpha, c));
}

// (lap + alpha) w at `at` of a shared window with row stride `s`.
__device__ __forceinline__ float lap_alpha(const float* w, int at, int s,
                                           float inv_dx2, float alpha) {
  return lap_alpha_pt(w[at], w[at + s], w[at - s], w[at + 1], w[at - 1],
                      inv_dx2, alpha);
}

// One damped-Jacobi update of a point: a + cw (f - (lap + alpha) a).
__device__ __forceinline__ float sweep_pt(float a, float f, float la,
                                          float cw) {
  return __fadd_rn(a, __fmul_rn(cw, __fsub_rn(f, la)));
}

// The prolongation's row stage at one coarse column: ec[q] (even fine row),
// ec[q]/2 + ec[q+1]/2 (odd).
__device__ __forceinline__ float prolong_v(float e, float e_next, bool odd) {
  return odd ? __fadd_rn(__fmul_rn(0.5f, e), __fmul_rn(0.5f, e_next)) : e;
}

// The rows x cols window of a periodic (m, p) plane whose corner is at
// (gx0, gy0), into `dst`.
__device__ __forceinline__ void load_window(const float* __restrict__ src,
                                            float* dst, int m, int p, int gx0,
                                            int gy0, int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += MG_THREADS) {
    const int i = idx / cols, j = idx % cols;
    dst[idx] = src[(size_t)wrap(gx0 + i, m) * p + wrap(gy0 + j, p)];
  }
}

// nu sweeps on a rows x cols window, sweep s updating ring s inwards, from
// `a` into `b` and back; returns the buffer that holds the result.
__device__ __forceinline__ float* sweeps(float* a, float* b, const float* f,
                                         int rows, int cols, int nu,
                                         float inv_dx2, float alpha,
                                         float cw) {
  for (int s = 1; s <= nu; ++s) {
    const int ri = rows - 2 * s, rj = cols - 2 * s;
    for (int idx = threadIdx.x; idx < ri * rj; idx += MG_THREADS) {
      const int at = (s + idx / rj) * cols + s + idx % rj;
      b[at] = sweep_pt(a[at], f[at], lap_alpha(a, at, cols, inv_dx2, alpha),
                       cw);
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  return a;
}

// Writes the tile's interior of window `w` (halo h) to plane `dst`.
__device__ __forceinline__ void store_tile(const float* w, float* dst, int M,
                                           int P, int x0, int y0, int h,
                                           int cols) {
  for (int idx = threadIdx.x; idx < MG_TX * MG_TY; idx += MG_THREADS) {
    const int i = idx / MG_TY, j = idx % MG_TY;
    const int gx = x0 + i, gy = y0 + j;
    if (gx < M && gy < P) dst[(size_t)gx * P + gy] = w[(h + i) * cols + h + j];
  }
}

// [1, 2, 1]/4 of three values in the Pallas kernel's order.
__device__ __forceinline__ float fw3(float lo, float mid, float hi) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.5f, mid)),
                   __fmul_rn(0.25f, hi));
}

template <bool kResidual, bool kRestrict>
__global__ void __launch_bounds__(MG_THREADS)
mg_smooth_kernel(const float* __restrict__ u, const float* __restrict__ f,
                 float* __restrict__ u_out, float* __restrict__ r_out, int M,
                 int P, int nu, MgConsts c) {
  extern __shared__ float smem[];
  const int h = nu + (kResidual ? 1 : 0) + (kRestrict ? 1 : 0);
  const int rows = MG_TX + 2 * h, cols = MG_TY + 2 * h, n = rows * cols;
  float* a = smem;
  float* b = a + n;
  float* fs = b + n;
  const int k = blockIdx.z;
  const size_t plane = (size_t)M * P;
  const int x0 = blockIdx.y * MG_TX, y0 = blockIdx.x * MG_TY;
  const float alpha = c.alpha[k];

  load_window(u + k * plane, a, M, P, x0 - h, y0 - h, rows, cols);
  load_window(f + k * plane, fs, M, P, x0 - h, y0 - h, rows, cols);
  __syncthreads();
  const float* w = sweeps(a, b, fs, rows, cols, nu, c.inv_dx2, alpha, c.cw[k]);
  store_tile(w, u_out + k * plane, M, P, x0, y0, h, cols);
  if constexpr (kResidual && !kRestrict) {
    for (int idx = threadIdx.x; idx < MG_TX * MG_TY; idx += MG_THREADS) {
      const int i = idx / MG_TY, j = idx % MG_TY;
      const int gx = x0 + i, gy = y0 + j;
      if (gx >= M || gy >= P) continue;
      const int at = (h + i) * cols + h + j;
      r_out[k * plane + (size_t)gx * P + gy] =
          __fsub_rn(fs[at], lap_alpha(w, at, cols, c.inv_dx2, alpha));
    }
  }
  if constexpr (kRestrict) {
    // The residual on the tile plus a ring of 1, into the spare buffer.
    float* r = (w == a) ? b : a;
    for (int idx = threadIdx.x; idx < (MG_TX + 2) * (MG_TY + 2);
         idx += MG_THREADS) {
      const int at = (h - 1 + idx / (MG_TY + 2)) * cols + h - 1 +
                     idx % (MG_TY + 2);
      r[at] = __fsub_rn(fs[at], lap_alpha(w, at, cols, c.inv_dx2, alpha));
    }
    __syncthreads();
    const int Mc = M / 2, Pc = P / 2;
    for (int idx = threadIdx.x; idx < (MG_TX / 2) * (MG_TY / 2);
         idx += MG_THREADS) {
      const int ci = idx / (MG_TY / 2), cj = idx % (MG_TY / 2);
      const int X = x0 / 2 + ci, Y = y0 / 2 + cj;
      if (X >= Mc || Y >= Pc) continue;
      const int at = (h + 2 * ci) * cols + h + 2 * cj;
      float rw[3];
      for (int d = 0; d < 3; ++d) {
        const int col = at + d - 1;
        rw[d] = fw3(r[col + cols], r[col], r[col - cols]);
      }
      r_out[(size_t)k * Mc * Pc + (size_t)X * Pc + Y] = fw3(rw[0], rw[1], rw[2]);
    }
  }
}

__global__ void __launch_bounds__(MG_THREADS)
mg_prolong_kernel(const float* __restrict__ u2, const float* __restrict__ ec,
                  const float* __restrict__ f, float* __restrict__ u_out,
                  int M, int P, int nu, MgConsts c) {
  extern __shared__ float smem[];
  const int h = nu;
  const int rows = MG_TX + 2 * h, cols = MG_TY + 2 * h, n = rows * cols;
  const int hc = (h + 1) / 2 + 1;
  const int crows = MG_TX / 2 + 2 * hc, ccols = MG_TY / 2 + 2 * hc;
  float* a = smem;
  float* b = a + n;
  float* fs = b + n;
  float* es = fs + n;
  const int k = blockIdx.z;
  const int Mc = M / 2, Pc = P / 2;
  const size_t plane = (size_t)M * P;
  const int x0 = blockIdx.y * MG_TX, y0 = blockIdx.x * MG_TY;

  load_window(u2 + k * plane, a, M, P, x0 - h, y0 - h, rows, cols);
  load_window(f + k * plane, fs, M, P, x0 - h, y0 - h, rows, cols);
  load_window(ec + (size_t)k * Mc * Pc, es, Mc, Pc, x0 / 2 - hc, y0 / 2 - hc,
              crows, ccols);
  __syncthreads();
  // u2 + prolong(ec) on the tile plus the halo: fine row x0 + gi sits at
  // coarse row x0/2 + floor(gi/2) (x0 is even), window row floor(gi/2) + hc.
  for (int idx = threadIdx.x; idx < n; idx += MG_THREADS) {
    const int gi = idx / cols - h, gj = idx % cols - h;
    const float* e = es + (half_floor(gi) + hc) * ccols + half_floor(gj) + hc;
    float v[2];
    for (int d = 0; d < 2; ++d) v[d] = prolong_v(e[d], e[d + ccols], gi & 1);
    const float p = (gj & 1) ? __fmul_rn(0.5f, __fadd_rn(v[0], v[1])) : v[0];
    a[idx] = __fadd_rn(a[idx], p);
  }
  __syncthreads();
  const float* w = sweeps(a, b, fs, rows, cols, nu, c.inv_dx2, c.alpha[k],
                          c.cw[k]);
  store_tile(w, u_out + k * plane, M, P, x0, y0, h, cols);
}

// ---------------------------------------------------------------------------
// The row-streaming design (mg_rows_kernel): notes in the header.
// ---------------------------------------------------------------------------

enum MgForm : int {
  kFormSmooth = 0,    // K10, u only
  kFormResidual = 1,  // K10, u and r
  kFormRestrict = 2,  // K10, u and the restricted residual rc
  kFormProlong = 3    // K11
};

constexpr int kRowsW = 120;                 // output columns of a strip
constexpr int kRowsRing = kRowsW + 8;       // a ring row: 4 halo columns a side
constexpr int kRowsCoarse = kRowsW / 2 + 8;  // K11's coarse ring row
constexpr int kRowsHalo = 4;                // the y halo a ring row holds
constexpr int kRowsMaxAhead = 8;
constexpr int kRowsMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The schedule of a form: rows a run reads above x0 - nu (kTop) and below
// x_end - 1 + nu (kBot), the steps L a row's slot stays live after the step
// it enters (its f's last reader is sweep nu, or the residual), and the
// floats of a slot (u or u2, f, and for K11 a coarse row).
template <int kForm, int NU>
struct MgRows {
  static constexpr bool kRes = kForm == kFormResidual || kForm == kFormRestrict;
  static constexpr int kTop = kForm == kFormRestrict ? 2 : kRes ? 1 : 0;
  static constexpr int kBot = kRes ? 1 : 0;
  static constexpr int L = NU + (kRes ? 1 : 0);
  static constexpr int kSlotFloats =
      2 * kRowsRing + (kForm == kFormProlong ? kRowsCoarse : 0);
  static_assert(NU + kTop <= kRowsHalo, "the y halo a ring row holds");
};

// Bytes of one warp's ring: S mbarriers padded to 16 bytes, then S slots.
__host__ __device__ constexpr int mg_rows_bar_bytes(int S) {
  return (S * 8 + 15) / 16 * 16;
}
__host__ __device__ constexpr int mg_rows_warp_bytes(int slot_floats, int S) {
  return mg_rows_bar_bytes(S) + S * slot_floats * 4;
}

template <int n>
__device__ __forceinline__ void shift_rows(float (&rows)[3][n]) {
#pragma unroll
  for (int j = 0; j < n; ++j) {
    rows[0][j] = rows[1][j];
    rows[1][j] = rows[2][j];
  }
}

// (lap + alpha) of the middle row of `w` (rows x - 1, x, x + 1) at a lane's
// 4 columns, the y neighbours of its first and last column from the lanes
// beside it.
__device__ __forceinline__ void lap_alpha_row(const float (&w)[3][4],
                                              float inv_dx2, float alpha,
                                              float (&la)[4]) {
  const float left = __shfl_up_sync(kFull, w[1][3], 1);
  const float right = __shfl_down_sync(kFull, w[1][0], 1);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    la[j] = lap_alpha_pt(w[1][j], w[2][j], w[0][j],
                         j < 3 ? w[1][j + 1] : right,
                         j > 0 ? w[1][j - 1] : left, inv_dx2, alpha);
  }
}

template <int kForm, int NU>
__global__ void __launch_bounds__(kRowsMaxThreads)
mg_rows_kernel(const float* __restrict__ u, const float* __restrict__ f,
               const float* __restrict__ ec, float* __restrict__ u_out,
               float* __restrict__ r_out, int M, int P, int R, int D,
               MgConsts c) {
  using F = MgRows<kForm, NU>;
  constexpr bool kProlong = kForm == kFormProlong;
  constexpr int kSlot = F::kSlotFloats;
  extern __shared__ __align__(16) unsigned char mg_rows_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (blockIdx.y * (blockDim.x >> 5) + warp) * R;
  if (x0 >= M) return;
  const int S = F::L + 1 + D;
  unsigned char* mine = mg_rows_smem + warp * mg_rows_warp_bytes(kSlot, S);
  auto* bar = reinterpret_cast<unsigned long long*>(mine);
  float* ring = reinterpret_cast<float*>(mine + mg_rows_bar_bytes(S));

  const int k = blockIdx.z;
  const int y0 = blockIdx.x * kRowsW;
  const int w = min(kRowsW, P - y0);
  const int x_end = min(x0 + R, M);
  int x_lo = x0 - NU - F::kTop;
  if (kProlong) x_lo -= x_lo & 1;    // even: slot x carries coarse ceil(x/2)
  const int x_hi = x_end - 1 + NU + F::kBot;
  const int Mc = M / 2, Pc = P / 2;
  const float* u_k = u + (size_t)k * M * P;
  const float* f_k = f + (size_t)k * M * P;
  const float* ec_k = kProlong ? ec + (size_t)k * Mc * Pc : nullptr;

  // Lane 0 fills row x's slot s: x of u (u2) and f, K11 coarse ceil(x/2).
  auto fill = [&](int x, int s) {
    float* dst = ring + s * kSlot;
    const unsigned fine = static_cast<unsigned>(w + 8) * 4u;
    const unsigned coarse =
        kProlong ? static_cast<unsigned>(w / 2 + 8) * 4u : 0u;
    mbar_expect(&bar[s], 2u * fine + coarse);
    const size_t row = (size_t)(((x % M) + M) % M) * P;
    const int left = (y0 - 4 + P) % P, right = (y0 + w) % P;
    bulk_row(dst, u_k + row, y0, w, left, right, &bar[s]);
    bulk_row(dst + kRowsRing, f_k + row, y0, w, left, right, &bar[s]);
    if constexpr (kProlong) {
      const int q = (x + 1) >> 1;
      bulk_row(dst + 2 * kRowsRing,
               ec_k + (size_t)(((q % Mc) + Mc) % Mc) * Pc, y0 / 2, w / 2,
               (y0 / 2 - 4 + Pc) % Pc, (y0 / 2 + w / 2) % Pc, &bar[s]);
    }
  };

  int next = x_lo, s_next = 0;   // lane 0: the next row to fill, its slot
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s]);
    for (; next <= min(x_lo + D, x_hi); ++next) {
      fill(next, s_next);
      s_next = s_next + 1 == S ? 0 : s_next + 1;
    }
  }
  __syncwarp();

  const float inv_dx2 = c.inv_dx2, alpha = c.alpha[k], cw = c.cw[k];
  const int col = 4 * lane;                      // the lane's ring columns
  const bool store = lane >= 1 && lane <= w / 4;  // strip lanes
  const size_t out_at = (size_t)k * M * P + y0 + col - 4;
  float wv[NU + 1][3][4] = {};   // stage s's last three rows, oldest first
  float rv[3][4] = {};           // the residual's (restrict form)
  int s_in = 0;                  // the slot of row xin
  unsigned phase = 0;            // the parity of its fill
  auto back = [&](int n) { return s_in >= n ? s_in - n : s_in - n + S; };

  for (int xin = x_lo; xin <= x_hi; ++xin) {
    mbar_wait(&bar[s_in], phase);
    const float* slot = ring + s_in * kSlot;
    // Stage 0: row xin of u, or u2 + prolong(ec).
    shift_rows(wv[0]);
    const float4 a = lds4(slot + col);
    float a4[4] = {a.x, a.y, a.z, a.w};
    if constexpr (kProlong) {
      // Fine columns y0 - 4 + col + j sit on coarse ring column 2 + col/2 +
      // floor(j/2); x odd reads coarse rows (x - 1)/2 (slot x - 1) and
      // (x + 1)/2 (slot x).
      const bool odd = xin & 1;
      const float* e1 = slot + 2 * kRowsRing + 2 + col / 2;
      const float* e0 = odd ? ring + back(1) * kSlot + 2 * kRowsRing + 2 +
                                  col / 2
                            : e1;
      float v[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) v[d] = prolong_v(e0[d], e1[d], odd);
      const float p4[4] = {v[0], __fmul_rn(0.5f, __fadd_rn(v[0], v[1])), v[1],
                           __fmul_rn(0.5f, __fadd_rn(v[1], v[2]))};
#pragma unroll
      for (int j = 0; j < 4; ++j) a4[j] = __fadd_rn(a4[j], p4[j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[0][2][j] = a4[j];

    // Sweep s forms row xin - s, once its inputs are rows of the run.
#pragma unroll
    for (int s = 1; s <= NU; ++s) {
      shift_rows(wv[s]);
      if (xin >= x_lo + 2 * s) {
        const float4 fv = lds4(ring + back(s) * kSlot + kRowsRing + col);
        const float f4[4] = {fv.x, fv.y, fv.z, fv.w};
        float la[4];
        lap_alpha_row(wv[s - 1], inv_dx2, alpha, la);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wv[s][2][j] = sweep_pt(wv[s - 1][1][j], f4[j], la[j], cw);
        }
      }
    }
    const int xu = xin - NU;
    if (store && xu >= x0 && xu < x_end) {
      *reinterpret_cast<float4*>(u_out + out_at + (size_t)xu * P) =
          make_float4(wv[NU][2][0], wv[NU][2][1], wv[NU][2][2], wv[NU][2][3]);
    }

    if constexpr (F::kRes) {
      // The residual of row xr = xin - NU - 1.
      const int xr = xu - 1;
      float r4[4] = {};
      if (xin >= x_lo + 2 * (NU + 1)) {
        const float4 fv =
            lds4(ring + back(NU + 1) * kSlot + kRowsRing + col);
        const float f4[4] = {fv.x, fv.y, fv.z, fv.w};
        float la[4];
        lap_alpha_row(wv[NU], inv_dx2, alpha, la);
#pragma unroll
        for (int j = 0; j < 4; ++j) r4[j] = __fsub_rn(f4[j], la[j]);
      }
      if constexpr (kForm == kFormResidual) {
        if (store && xr >= x0 && xr < x_end) {
          *reinterpret_cast<float4*>(r_out + out_at + (size_t)xr * P) =
              make_float4(r4[0], r4[1], r4[2], r4[3]);
        }
      } else {
        shift_rows(rv);
#pragma unroll
        for (int j = 0; j < 4; ++j) rv[2][j] = r4[j];
        if ((xr & 1) && xr > x0 && xr < x_end) {
          // Coarse row X = (xr - 1)/2 from r at rows xr - 2 .. xr: rows,
          // then columns 2Y - 1 .. 2Y + 1 at 2Y = the lane's columns 0, 2.
          float rw[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) rw[j] = fw3(rv[2][j], rv[1][j], rv[0][j]);
          const float left = __shfl_up_sync(kFull, rw[3], 1);
          const float c0 = fw3(left, rw[0], rw[1]);
          const float c1 = fw3(rw[1], rw[2], rw[3]);
          const float n0 = __shfl_down_sync(kFull, c0, 1);
          const float n1 = __shfl_down_sync(kFull, c1, 1);
          if (store && (lane & 1)) {
            *reinterpret_cast<float4*>(
                r_out + (size_t)k * Mc * Pc + (size_t)((xr - 1) / 2) * Pc +
                y0 / 2 + col / 2 - 2) = make_float4(c0, c1, n0, n1);
          }
        }
      }
    }

    __syncwarp();   // every lane's reads of the slot row xin - L freed
    if (lane == 0) {
      const int upto = min(xin + 1 + D, x_hi);
      if (next <= upto) {
        fence_proxy_async();
        for (; next <= upto; ++next) {
          fill(next, s_next);
          s_next = s_next + 1 == S ? 0 : s_next + 1;
        }
      }
    }
    if (++s_in == S) {
      s_in = 0;
      phase ^= 1u;
    }
  }
}

template <int kForm, int NU>
struct MgRowsTag {
  static constexpr int kF = kForm, kNu = NU;
};

// Calls fn(MgRowsTag<form, nu>{}) for an instance the source holds (the four
// forms, nu 1 or 2); cudaErrorInvalidValue for any other.
template <class Fn>
int mg_rows_dispatch(int form, int nu, Fn&& fn) {
#define QG_MG_ROWS_CASE(fm, n) \
  if (form == fm && nu == n) return fn(MgRowsTag<fm, n>{});
  QG_MG_ROWS_CASE(kFormSmooth, 1) QG_MG_ROWS_CASE(kFormSmooth, 2)
  QG_MG_ROWS_CASE(kFormResidual, 1) QG_MG_ROWS_CASE(kFormResidual, 2)
  QG_MG_ROWS_CASE(kFormRestrict, 1) QG_MG_ROWS_CASE(kFormRestrict, 2)
  QG_MG_ROWS_CASE(kFormProlong, 1) QG_MG_ROWS_CASE(kFormProlong, 2)
#undef QG_MG_ROWS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

MgConsts mg_consts(const float* consts) {
  MgConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int i = 0; i < kNumMgConsts; ++i) dst[i] = consts[i];
  return c;
}

dim3 mg_grid(int M, int P, int K) {
  return dim3((P + MG_TY - 1) / MG_TY, (M + MG_TX - 1) / MG_TX, K);
}

}  // namespace

extern "C" int qg_mg_num_consts() { return kNumMgConsts; }
extern "C" int qg_mg_max_modes() { return kMaxModes; }
extern "C" int qg_mg_max_halo() { return kMaxHalo; }

// K10. consts: host array of kNumMgConsts floats in MgConsts order. r_out is
// (K, M, P) for the residual form, (K, M/2, P/2) for the restrict form (M and
// P even), and ignored for the smooth-only form.
extern "C" int qg_mg_smooth_launch(const float* u, const float* f,
                                   float* u_out, float* r_out, int K, int M,
                                   int P, int nu, int residual, int restrict_,
                                   const float* consts, void* stream) {
  const int h = nu + (residual ? 1 : 0) + (restrict_ ? 1 : 0);
  if (K < 1 || K > kMaxModes || nu < 0 || h > kMaxHalo ||
      (restrict_ && (!residual || M % 2 || P % 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 3 * (MG_TX + 2 * h) * (MG_TY + 2 * h) * sizeof(float);
  auto kernel = !residual  ? mg_smooth_kernel<false, false>
                : restrict_ ? mg_smooth_kernel<true, true>
                            : mg_smooth_kernel<true, false>;
  if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  kernel<<<mg_grid(M, P, K), MG_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(u, f, u_out, r_out, M, P, nu,
                                                mg_consts(consts));
  return static_cast<int>(cudaGetLastError());
}

// K11. ec: (K, M/2, P/2); M and P even.
extern "C" int qg_mg_prolong_launch(const float* u2, const float* ec,
                                    const float* f, float* u_out, int K,
                                    int M, int P, int nu, const float* consts,
                                    void* stream) {
  if (K < 1 || K > kMaxModes || nu < 0 || nu > kMaxHalo || M % 2 || P % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int hc = (nu + 1) / 2 + 1;
  const int smem = (3 * (MG_TX + 2 * nu) * (MG_TY + 2 * nu) +
                    (MG_TX / 2 + 2 * hc) * (MG_TY / 2 + 2 * hc)) *
                   sizeof(float);
  if (int err = set_smem(reinterpret_cast<const void*>(mg_prolong_kernel), smem))
    return err;
  mg_prolong_kernel<<<mg_grid(M, P, K), MG_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(u2, ec, f, u_out, M,
                                                           P, nu,
                                                           mg_consts(consts));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qg_mg_rows_width() { return kRowsW; }

// The row-streaming K10 (form 0 smooth only, 1 residual, 2 restrict) and K11
// (form 3) in the layout (R, D, NT): R rows a run (even), D rows ahead, NT
// threads (NT / 32 warps, each on its own run). nu 1 or 2; P % 4 == 0 (P % 8
// == 0 for restrict and prolong, whose coarse rows go by 16-byte pieces), M
// even for restrict and prolong; every operand 16-byte aligned. ec: (K, M/2,
// P/2) for K11, else ignored; r_out as for qg_mg_smooth_launch.
extern "C" int qg_mg_rows_launch(int form, const float* u, const float* f,
                                 const float* ec, float* u_out, float* r_out,
                                 int K, int M, int P, int nu, int R, int D,
                                 int NT, const float* consts, void* stream) {
  const bool coarse = form == kFormRestrict || form == kFormProlong;
  const bool ok =
      K >= 1 && K <= kMaxModes && M >= 2 && P >= 4 && P % 4 == 0 &&
      (!coarse || (M % 2 == 0 && P % 8 == 0)) && R >= 2 && R % 2 == 0 &&
      D >= 1 && D <= kRowsMaxAhead && NT >= 32 && NT % 32 == 0 &&
      NT <= kRowsMaxThreads && aligned16(u) && aligned16(f) &&
      aligned16(u_out) && (form != kFormProlong || aligned16(ec)) &&
      (form == kFormSmooth || form == kFormProlong || aligned16(r_out));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const MgConsts c = mg_consts(consts);
  auto st = static_cast<cudaStream_t>(stream);
  return mg_rows_dispatch(form, nu, [&](auto tag) {
    using T = decltype(tag);
    using F = MgRows<T::kF, T::kNu>;
    const int smem =
        NT / 32 * mg_rows_warp_bytes(F::kSlotFloats, F::L + 1 + D);
    auto kernel = mg_rows_kernel<T::kF, T::kNu>;
    if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem))
      return err;
    const int runs = (M + R - 1) / R;
    dim3 grid((P + kRowsW - 1) / kRowsW, (runs + NT / 32 - 1) / (NT / 32), K);
    kernel<<<grid, NT, smem, st>>>(u, f, ec, u_out, r_out, M, P, R, D, c);
    return static_cast<int>(cudaGetLastError());
  });
}

// The compiled row-streaming instance of (form, nu) in the layout (D, NT):
// registers a thread, local memory (spills) in bytes a thread, dynamic
// shared memory in bytes a block, and the most blocks one SM of the current
// device holds.
extern "C" int qg_mg_rows_attributes(int form, int nu, int D, int NT,
                                     int* regs, int* local_bytes, int* smem,
                                     int* blocks_per_sm) {
  if (D < 1 || D > kRowsMaxAhead || NT < 32 || NT % 32 ||
      NT > kRowsMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  return mg_rows_dispatch(form, nu, [&](auto tag) {
    using T = decltype(tag);
    using F = MgRows<T::kF, T::kNu>;
    const int bytes =
        NT / 32 * mg_rows_warp_bytes(F::kSlotFloats, F::L + 1 + D);
    const void* fn = reinterpret_cast<const void*>(
        mg_rows_kernel<T::kF, T::kNu>);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *smem = bytes;
    if (int e = set_smem(fn, bytes)) return e;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, NT,
                                                        bytes);
    return static_cast<int>(err);
  });
}
