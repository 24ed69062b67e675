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
// once on the host from their float64 values.
//
// Bound: device-memory bandwidth. K10 reads u and f and writes u and r (the
// residual form, four (K, M, P) fields), u and rc (the restrict form, 3.25
// fields) or u alone (three fields); K11 reads u2, f and ec and writes u
// (3.25 fields): at 8192^2 with K = 2, 1745 MB and 0.52 ms at 3.35 TB/s for
// the restrict form and K11. Some 13 float operations a point a sweep are
// far below the card's float32 rate.
//
// Design: one block per 32 x 64 tile and mode (blockIdx.z), 256 threads.
// The tile plus a halo of h = nu (+1 for the residual, +1 more for the
// restriction) of u and f lands in shared memory with the periodic wrap
// done in the load index; the nu sweeps run there, ping-ponging between two
// buffers with a barrier between sweeps. Each sweep leaves one ring fewer
// valid, so the halo is recomputed rather than exchanged (temporal
// blocking): the extra reads of the halo hit L2, and the device-memory
// traffic stays one read of each input and one write of each output. The
// residual is formed on the tile (plus a ring of 1 for the restriction,
// whose 16 x 32 coarse tile starts at the even fine origin). K11 loads the
// coarse tile with a ring of ceil(nu/2) + 1, forms u2 + e on the tile plus
// a halo of nu, then sweeps as K10 does. Outputs go to new buffers: a
// tile's neighbours read its inputs as their halo.

#include <cuda_runtime.h>

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

// (lap + alpha) w at `at` of a shared window with row stride `s`, in the
// Pallas kernel's difference form (_lap_alpha_slab).
__device__ __forceinline__ float lap_alpha(const float* w, int at, int s,
                                           float inv_dx2, float alpha) {
  const float c = w[at];
  const float lap = __fmul_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(w[at + s], c), __fsub_rn(w[at - s], c)),
                __fadd_rn(__fsub_rn(w[at + 1], c), __fsub_rn(w[at - 1], c))),
      inv_dx2);
  return __fadd_rn(lap, __fmul_rn(alpha, c));
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
      const float r = __fsub_rn(f[at], lap_alpha(a, at, cols, inv_dx2, alpha));
      b[at] = __fadd_rn(a[at], __fmul_rn(cw, r));
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
    for (int d = 0; d < 2; ++d) {
      v[d] = (gi & 1) ? __fadd_rn(__fmul_rn(0.5f, e[d]),
                                  __fmul_rn(0.5f, e[d + ccols]))
                      : e[d];
    }
    const float p = (gj & 1) ? __fmul_rn(0.5f, __fadd_rn(v[0], v[1])) : v[0];
    a[idx] = __fadd_rn(a[idx], p);
  }
  __syncthreads();
  const float* w = sweeps(a, b, fs, rows, cols, nu, c.inv_dx2, c.alpha[k],
                          c.cw[k]);
  store_tile(w, u_out + k * plane, M, P, x0, y0, h, cols);
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
