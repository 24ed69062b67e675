// K1: the fused two-layer step kernel (tendency + time update in one pass),
// and K8: the same step for one or two layers with the modal projection as a
// third output.
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
// 2048^2 — and does ~60 flops per point. Design: one block per 32 x 64 tile,
// the layers in turn; psi (halo 2) and zeta (halo 1) land in shared memory
// with the periodic wrap done in the load index, lap(psi) is formed once on
// the tile plus a ring of 1, and every stencil neighbour is then a
// shared-memory read. Threads walk the tile with y fastest, so each warp's
// global loads and stores are 128-byte contiguous runs along the contiguous
// axis.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;    // tile rows (x, strided axis)
constexpr int TY = 64;    // tile columns (y, contiguous axis)
constexpr int THREADS = 256;

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

// K8's modal projection P^-1 = [[q11, q12], [q21, q22]].
struct ModalConsts {
  float q11, q12, q21, q22;
};
constexpr int kNumModalConsts = sizeof(ModalConsts) / sizeof(float);

// The step over one tile for L layers. kModes (L = 2) also writes the modes
// P^-1 zeta_new: a thread visits the same tile points in both layers, so
// it keeps layer 0's zeta_new in shared memory until layer 1's is formed.
template <int L, bool kModes>
__device__ __forceinline__ void step_tile(
    const float* __restrict__ zeta, const float* __restrict__ psi,
    const float* __restrict__ f1, const float* __restrict__ f2,
    const float* __restrict__ wind, float* __restrict__ zeta_new,
    float* __restrict__ carry, float* __restrict__ modes, int M, int P,
    const StepConsts& c, const ModalConsts& q, int leapfrog, int step) {
  __shared__ float ps[TX + 4][TY + 4];   // psi, halo 2
  __shared__ float zs[TX + 2][TY + 2];   // zeta, halo 1
  __shared__ float lp[TX + 2][TY + 2];   // lap(psi), halo 1
  __shared__ float zn0[kModes ? TX : 1][TY];   // layer 0's zeta_new

  const int x0 = blockIdx.y * TX;
  const int y0 = blockIdx.x * TY;
  const size_t plane = (size_t)M * P;

  for (int l = 0; l < L; ++l) {
    const float* pl = psi + l * plane;
    const float* zl = zeta + l * plane;
    for (int idx = threadIdx.x; idx < (TX + 4) * (TY + 4); idx += THREADS) {
      const int i = idx / (TY + 4), j = idx % (TY + 4);
      const int gx = (x0 - 2 + i + M) % M, gy = (y0 - 2 + j + P) % P;
      ps[i][j] = pl[(size_t)gx * P + gy];
    }
    for (int idx = threadIdx.x; idx < (TX + 2) * (TY + 2); idx += THREADS) {
      const int i = idx / (TY + 2), j = idx % (TY + 2);
      const int gx = (x0 - 1 + i + M) % M, gy = (y0 - 1 + j + P) % P;
      zs[i][j] = zl[(size_t)gx * P + gy];
    }
    __syncthreads();

    // lap(psi) on the tile plus a ring of 1: lp[i][j] sits at ps[i+1][j+1].
    for (int idx = threadIdx.x; idx < (TX + 2) * (TY + 2); idx += THREADS) {
      const int i = idx / (TY + 2), j = idx % (TY + 2);
      lp[i][j] = ((((ps[i][j + 1] + ps[i + 2][j + 1]) - 4.0f * ps[i + 1][j + 1])
                   + ps[i + 1][j]) + ps[i + 1][j + 2]) * c.inv_dx2;
    }
    __syncthreads();

    for (int idx = threadIdx.x; idx < TX * TY; idx += THREADS) {
      const int i = idx / TY, j = idx % TY;
      const int gx = x0 + i, gy = y0 + j;
      if (gx >= M || gy >= P) continue;
      // Centres: psi at ps[i+2][j+2], zeta and lap at [i+1][j+1].
      const int pi = i + 2, pj = j + 2, zi = i + 1, zj = j + 1;
      const float lap_c = lp[zi][zj];
      const float visc_term =
          c.visc * (((((lp[zi - 1][zj] + lp[zi + 1][zj]) - 4.0f * lap_c)
                      + lp[zi][zj - 1]) + lp[zi][zj + 1]) * c.inv_dx2);

      const float z_xp = zs[zi + 1][zj], z_xm = zs[zi - 1][zj];
      const float z_yp = zs[zi][zj + 1], z_ym = zs[zi][zj - 1];
      const float z_xpyp = zs[zi + 1][zj + 1], z_xpym = zs[zi + 1][zj - 1];
      const float z_xmyp = zs[zi - 1][zj + 1], z_xmym = zs[zi - 1][zj - 1];
      const float p_xp = ps[pi + 1][pj], p_xm = ps[pi - 1][pj];
      const float p_yp = ps[pi][pj + 1], p_ym = ps[pi][pj - 1];
      const float p_xpyp = ps[pi + 1][pj + 1], p_xpym = ps[pi + 1][pj - 1];
      const float p_xmyp = ps[pi - 1][pj + 1], p_xmym = ps[pi - 1][pj - 1];

      const float j_pp = (z_xp - z_xm) * (p_yp - p_ym)
                         - (z_yp - z_ym) * (p_xp - p_xm);
      const float j_pt = ((z_xp * (p_xpyp - p_xpym) - z_xm * (p_xmyp - p_xmym))
                          - z_yp * (p_xpyp - p_xmyp))
                         + z_ym * (p_xpym - p_xmym);
      const float j_tp = ((z_xpyp * (p_yp - p_xp) - z_xmym * (p_xm - p_ym))
                          - z_xmyp * (p_yp - p_xm))
                         + z_xpym * (p_xp - p_ym);
      const float jac = ((j_pp + j_pt) + j_tp) / c.jac_den;
      const float dpsi_dx = c.half_inv_dx * (p_xp - p_xm);

      float tend = (visc_term - jac) - c.beta[l] * dpsi_dx;
      if (l == 0) {
        tend = tend - c.U * (c.half_inv_dx * (z_xp - z_xm));
        if (L == 1) tend = tend - c.r * lap_c;
        if (wind != nullptr) tend = tend + wind[gy];
      } else {
        tend = tend - c.r * lap_c;
      }

      const size_t at = (size_t)gx * P + gy;
      const size_t off = l * plane + at;
      const float zc = zs[zi][zj];
      float zn, out;
      if (leapfrog) {
        const float zpf = (step == 0) ? zc : f1[off];
        zn = (step == 0) ? zc + c.dt * tend : zpf + c.two_dt * tend;
        out = zc + c.ra * ((zpf - 2.0f * zc) + zn);
      } else {
        if (step < 2) {
          zn = zc + c.dt * tend;
        } else {
          zn = zc + c.dt * ((c.c23 * tend - c.c16 * f1[off]) + c.c5 * f2[off]);
        }
        out = tend;
      }
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

__global__ void __launch_bounds__(THREADS)
step_kernel(const float* __restrict__ zeta, const float* __restrict__ psi,
            const float* __restrict__ f1, const float* __restrict__ f2,
            const float* __restrict__ wind, float* __restrict__ zeta_new,
            float* __restrict__ carry, int M, int P, StepConsts c,
            int leapfrog, int step) {
  step_tile<2, false>(zeta, psi, f1, f2, wind, zeta_new, carry, nullptr, M,
                      P, c, ModalConsts{}, leapfrog, step);
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
  step_tile<L, L == 2>(zeta, psi, f1, f2, wind, zeta_new, carry, modes, M, P,
                       c, q, leapfrog, step);
}

StepConsts step_consts(const float* consts) {
  StepConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumConsts; ++k) dst[k] = consts[k];
  return c;
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
