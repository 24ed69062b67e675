// K2 (the y-DFT), K3 (the mirror-pair x-kernel), K4 (the x-DFT) and K5
// (symbols + inverse x-DFT) of the packed modal inversion. Two routes:
// psi = K2^-1(K3(K2(zeta))), three passes over device memory, and the
// four-pass psi = K2^-1(K5(K4(K2(zeta)))) that tpu_qg takes for M > 2432.
//
// Conventions shared with tpu_qg/ops/matmul_fft.py and pallas_fft.py:
//   * complex fields are planar: (2, rows, N) float32, plane 0 = re, 1 = im;
//   * the y-spectrum is kept in PERMUTED order: with N = N1 * N2 (N1 the
//     largest divisor <= 128), slot k2*N1 + k1 holds frequency k2 + N2*k1;
//     so is the x-spectrum between K4 and K5.
//
// Every kernel transforms with an in-place radix-2 FFT in shared memory:
// the forward pass is decimation in frequency (natural order in, bit-reversed
// out), the inverse pass decimation in time (bit-reversed in, natural out),
// so no reorder pass is needed between them. Up to four consecutive radix-2
// stages run in registers per shared-memory round trip (group_pass), so a
// 2048-point transform takes 3 barriers instead of 11. Twiddles come from a
// float32 table of exp(-2 pi i k/R), k < R/2, built in float64 on the host.
//
// An extent N = R * m with R = 2^logr and m odd (the reference's 128 * n,
// e.g. 384 = 128 * 3 or 1536 = 512 * 3) runs the radix-2 passes on m
// sub-columns of length R, sub-column q holding x[m r + q] at q * sub +
// pad(r), and joins them with an m-point DFT (mixed_fwd / mixed_inv, on a
// second float32 table of exp(-2 pi i j/N), j < N). The power-of-two case
// (m = 1) is a separate template instance with no joining stage.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int bitrev(int v, int logn) {
  return logn == 0 ? 0 : static_cast<int>(__brev(static_cast<unsigned>(v)) >> (32 - logn));
}

// Permuted slot -> frequency (matmul_fft.freq_order).
__device__ __forceinline__ int slot_freq(int s, int n1, int n2) {
  return s / n1 + n2 * (s % n1);
}

// Shared-memory slot of element i of a column: one pad word every 32
// elements spreads the strided butterfly accesses over the 32 banks.
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Loads `count` complex values from the two planes of a planar field into
// shared memory, dst[sidx(i)] = src[gidx(i)] (gidx < 0 reads a zero), with
// kBatch loads per plane in flight per thread: a plain loop would wait for
// each global load before its shared-memory store.
constexpr int kBatch = 8;

template <class GIdx, class SIdx>
__device__ __forceinline__ void load_planar(const float* __restrict__ src,
                                            size_t src_plane, float* dst,
                                            int dst_plane, int count,
                                            GIdx gidx, SIdx sidx) {
  for (int i0 = threadIdx.x; i0 < count; i0 += kBatch * blockDim.x) {
    float vr[kBatch], vi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const long long g = i < count ? gidx(i) : -1;
      vr[u] = g >= 0 ? src[g] : 0.0f;
      vi[u] = g >= 0 ? src[g + src_plane] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < count) {
        dst[sidx(i)] = vr[u];
        dst[sidx(i) + dst_plane] = vi[u];
      }
    }
  }
}

// Radix-2 stages per register pass: 16 complex values per thread.
constexpr int kGroupStages = 4;

// Radix-2 butterflies of K consecutive stages (spans 2^(lo+K-1) .. 2^lo),
// done in registers on groups of 2^K elements that only interact with each
// other: element j of a group sits at base + j * 2^lo. The butterflies and
// twiddles are exactly those of the K radix-2 stages, so the result (and
// its bit-reversed order) does not depend on how stages are grouped; only
// the number of shared-memory round trips and barriers does.
template <int K, bool kInverse>
__device__ __forceinline__ void group_pass(float* re, float* im, int ncols,
                                           int stride, int logn, int lo,
                                           const float2* tw) {
  constexpr int G = 1 << K;
  const int s = 1 << lo;
  const int gpc = (1 << logn) >> K;         // groups per column
  for (int t = threadIdx.x; t < ncols * gpc; t += blockDim.x) {
    const int col = t / gpc, g = t - col * gpc;
    const int base = ((g >> lo) << (lo + K)) + (g & (s - 1));
    float* cr = re + col * stride;
    float* ci = im + col * stride;
    float xr[G], xi[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int a = pad(base + j * s);
      xr[j] = cr[a];
      xi[j] = ci[a];
    }
#pragma unroll
    for (int step = 0; step < K; ++step) {
      // DIF runs the spans from large to small, DIT from small to large.
      const int q = kInverse ? step : K - 1 - step;
      const int lh = lo + q;
      const int tws = logn - 1 - lh;          // twiddle stride n / 2^(lh+1)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j & (1 << q)) continue;
        const int k = j + (1 << q);
        const int pos = (base + j * s) & ((1 << lh) - 1);
        const float2 w = tw[pos << tws];
        if (!kInverse) {
          const float ur = xr[j], ui = xi[j], vr = xr[k], vi = xi[k];
          xr[j] = ur + vr;
          xi[j] = ui + vi;
          const float dr = ur - vr, di = ui - vi;
          xr[k] = dr * w.x - di * w.y;
          xi[k] = dr * w.y + di * w.x;
        } else {
          const float vr = xr[k], vi = xi[k];
          const float tr = vr * w.x + vi * w.y;   // v * conj(w)
          const float ti = vi * w.x - vr * w.y;
          const float ur = xr[j], ui = xi[j];
          xr[j] = ur + tr;
          xi[j] = ui + ti;
          xr[k] = ur - tr;
          xi[k] = ui - ti;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int a = pad(base + j * s);
      cr[a] = xr[j];
      ci[a] = xi[j];
    }
  }
  __syncthreads();
}

template <bool kInverse>
__device__ __forceinline__ void run_pass(int k, float* re, float* im,
                                         int ncols, int stride, int logn,
                                         int lo, const float2* tw) {
  switch (k) {
    case 4: return group_pass<4, kInverse>(re, im, ncols, stride, logn, lo, tw);
    case 3: return group_pass<3, kInverse>(re, im, ncols, stride, logn, lo, tw);
    case 2: return group_pass<2, kInverse>(re, im, ncols, stride, logn, lo, tw);
    default: return group_pass<1, kInverse>(re, im, ncols, stride, logn, lo, tw);
  }
}

// Forward radix-2 DIF over `ncols` columns of length n = 2^logn, stored
// planar at re/im + col*stride (padded slots): natural order in,
// bit-reversed order out.
__device__ void fft_dif(float* re, float* im, int ncols, int stride, int logn,
                        const float2* tw) {
  for (int top = logn - 1; top >= 0;) {
    const int k = min(kGroupStages, top + 1);
    run_pass<false>(k, re, im, ncols, stride, logn, top - k + 1, tw);
    top -= k;
  }
}

// Inverse (conjugate-twiddle) radix-2 DIT: bit-reversed order in, natural
// order out, unscaled.
__device__ void ifft_dit(float* re, float* im, int ncols, int stride, int logn,
                         const float2* tw) {
  for (int lo = 0; lo < logn;) {
    const int k = min(kGroupStages, logn - lo);
    run_pass<true>(k, re, im, ncols, stride, logn, lo, tw);
    lo += k;
  }
}

// Shared-memory slot of element n of a column split into m sub-columns.
__device__ __forceinline__ int sub_slot(int n, int m, int sub) {
  return (n % m) * sub + pad(n / m);
}

// Forward join, N = R * m: after fft_dif on the m sub-columns at re/im +
// q * sub (bit-reversed), X[f] = sum_q w^(q f) Y_q[f mod R], w = twn[1].
__device__ __forceinline__ float2 mixed_fwd(const float* re, const float* im,
                                            int sub, int m, int N, int logr,
                                            int f, const float2* __restrict__ twn) {
  const int pos = pad(bitrev(f & ((1 << logr) - 1), logr));
  float xr = 0.0f, xi = 0.0f;
  for (int q = 0, j = 0; q < m; ++q) {
    const float2 w = twn[j];
    const float ar = re[q * sub + pos], ai = im[q * sub + pos];
    xr += ar * w.x - ai * w.y;
    xi += ar * w.y + ai * w.x;
    j += f;
    if (j >= N) j -= N;
  }
  return make_float2(xr, xi);
}

// Inverse split, N = R * m: from a natural-order spectrum at re/im +
// pad(k), Z_a[k1] = sum_k2 X[k1 + R k2] conj(w)^(a (k1 + R k2)); ifft_dit of
// sub-column a (Z_a at bit-reversed k1) then holds x[a + m n] at pad(n).
__device__ __forceinline__ float2 mixed_inv(const float* re, const float* im,
                                            int m, int N, int logr, int a,
                                            int k1, const float2* __restrict__ twn) {
  const int R = 1 << logr;
  const int step = a * R;                  // < N
  float zr = 0.0f, zi = 0.0f;
  for (int k2 = 0, j = (a * k1) % N; k2 < m; ++k2) {
    const int s = pad(k1 + R * k2);
    const float2 w = twn[j];
    zr += re[s] * w.x + im[s] * w.y;
    zi += im[s] * w.x - re[s] * w.y;
    j += step;
    if (j >= N) j -= N;
  }
  return make_float2(zr, zi);
}

// Inverse split of `count` natural-order spectra (columns first ..
// first + count - 1 at bre/bim + col * bstride) into sub-column columns
// 0 .. count - 1 at re/im + col * cs, bit-reversed, ready for ifft_dit.
__device__ void split_cols(const float* bre, const float* bim, int bstride,
                           int first, int count, float* re, float* im, int cs,
                           int sub, int m, int N, int logr,
                           const float2* __restrict__ twn) {
  const int R = 1 << logr;
  for (int idx = threadIdx.x; idx < count * N; idx += blockDim.x) {
    const int cc = idx / N, t = idx - cc * N;
    const int a = t >> logr, k1 = t & (R - 1);
    const int b = (first + cc) * bstride;
    const float2 v = mixed_inv(bre + b, bim + b, m, N, logr, a, k1, twn);
    const int p = cc * cs + a * sub + pad(bitrev(k1, logr));
    re[p] = v.x;
    im[p] = v.y;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K2: 1-D DFT along y (the contiguous axis) of a planar (2, rows, P) field.
//
// Replaces tpu_qg/ops/pallas_fft.py PlanarFFT2._call_y (_build_kernel(axis=
// "y"), _plan, _chunk_dft, _cdot). Forward: natural -> permuted order.
// Inverse: permuted -> natural order, scaled 1/P.
//
// Bound: device-memory bandwidth (one read and one write of the field,
// 2 x 33.5 MB at 2048^2, against ~5 P log2 P flops per row). Design: one
// block per row; the row's P complex values (16 KB at P = 2048) sit in
// shared memory for all log2 P stages, the reorder into permuted order is a
// gather from shared memory, and global reads and writes are contiguous
// along the row. For P = R * m (m odd > 1) the forward pass joins the m
// sub-transforms while it writes the permuted spectrum, and the inverse
// splits the spectrum into a second row buffer before its radix-2 passes.
// ---------------------------------------------------------------------------
template <bool kMixed>
__global__ void __launch_bounds__(256)
y_dft_kernel(const float* __restrict__ in, float* __restrict__ out, int rows,
             int P, int logr, int m, int n1, int inverse,
             const float2* __restrict__ tw, const float2* __restrict__ twn) {
  extern __shared__ float smem[];
  const int R = 1 << logr;
  const int sub = pad(R);
  float* re = smem;                        // m sub-columns (m = 1: the row)
  float* im = smem + m * sub;
  float2* stw = reinterpret_cast<float2*>(smem + 2 * m * sub);
  float* bre = smem + 2 * m * sub + R;     // mixed: natural-order spectrum
  float* bim = bre + pad(P);
  for (int k = threadIdx.x; k < R / 2; k += blockDim.x) stw[k] = tw[k];
  const int row = blockIdx.x;
  const size_t plane = (size_t)rows * P;
  const float* in_r = in + (size_t)row * P;
  float* out_r = out + (size_t)row * P;
  float* out_i = out_r + plane;
  const int n2 = P / n1;

  if (!inverse) {
    load_planar(in_r, plane, re, m * sub, P,
                [](int n) { return (long long)n; },
                [=](int n) { return kMixed ? sub_slot(n, m, sub) : pad(n); });
    __syncthreads();
    fft_dif(re, im, m, sub, logr, stw);
    for (int s = threadIdx.x; s < P; s += blockDim.x) {
      const int f = slot_freq(s, n1, n2);
      if constexpr (kMixed) {
        const float2 v = mixed_fwd(re, im, sub, m, P, logr, f, twn);
        out_r[s] = v.x;
        out_i[s] = v.y;
      } else {
        const int p = pad(bitrev(f, logr));
        out_r[s] = re[p];
        out_i[s] = im[p];
      }
    }
  } else {
    if constexpr (kMixed) {
      load_planar(in_r, plane, bre, pad(P), P,
                  [](int s) { return (long long)s; },
                  [=](int s) { return pad(slot_freq(s, n1, n2)); });
      __syncthreads();
      for (int t = threadIdx.x; t < P; t += blockDim.x) {
        const int a = t >> logr, k1 = t & (R - 1);
        const float2 v = mixed_inv(bre, bim, m, P, logr, a, k1, twn);
        const int p = a * sub + pad(bitrev(k1, logr));
        re[p] = v.x;
        im[p] = v.y;
      }
    } else {
      load_planar(in_r, plane, re, pad(P), P,
                  [](int s) { return (long long)s; },
                  [=](int s) { return pad(bitrev(slot_freq(s, n1, n2), logr)); });
    }
    __syncthreads();
    ifft_dit(re, im, m, sub, logr, stw);
    const float scale = 1.0f / static_cast<float>(P);   // exact when m = 1
    for (int n = threadIdx.x; n < P; n += blockDim.x) {
      const int p = kMixed ? sub_slot(n, m, sub) : pad(n);
      out_r[n] = re[p] * scale;
      out_i[n] = im[p] * scale;
    }
  }
}

// The scalars from which K3 and K5 rebuild the packed-inversion symbols A
// and B (see K3 below).
struct SymConsts {
  float inv_dx2, alpha2;
  float a1r, a1i, a2r, a2i, b1r, b1i, b2r, b2i;
};
constexpr int kNumSymConsts = sizeof(SymConsts) / sizeof(float);

// Symbol stage of K3 and K5 on 2C spectra at sre/sim + col * ss (own slots
// 0..C-1, their mirror slots C..2C-1): for each own column and each {p, pm}
// pair of positions holding x-frequencies k and -k, V = A W + B conj(W(-k))
// for all four values, in place. kNatural: position p holds x-frequency p
// (joined spectra of a mixed extent), else bitrev(p).
template <bool kNatural>
__device__ void symbol_stage(float* sre, float* sim, int ss, int C,
                             const int* own, int M, int P, int logr, int n1y,
                             const SymConsts& c) {
  const int n2y = P / n1y;
  for (int idx = threadIdx.x; idx < C * M; idx += blockDim.x) {
    const int col = idx / M, p = idx - col * M;
    const int a = own[col];
    if (a < 0) continue;
    const int kx = kNatural ? p : bitrev(p, logr);
    const int kxm = kx == 0 ? 0 : M - kx;
    const int pm = kNatural ? kxm : bitrev(kxm, logr);
    if (p > pm) continue;
    const int sp = pad(p), spm = pad(pm);
    const int fy = slot_freq(a, n1y, n2y);
    const int fyf = min(fy, P - fy);
    const int kxf = min(kx, kxm);
    const float sx = sinpif(static_cast<float>(kxf) / static_cast<float>(M));
    const float sy = sinpif(static_cast<float>(fyf) / static_cast<float>(P));
    const float lam = (-4.0f * c.inv_dx2) * (sx * sx + sy * sy);
    const float inv1 = (kx == 0 && fy == 0) ? 0.0f : 1.0f / lam;
    const float inv2 = 1.0f / (lam + c.alpha2);
    const float ar = c.a1r * inv1 + c.a2r * inv2, ai = c.a1i * inv1 + c.a2i * inv2;
    const float br = c.b1r * inv1 + c.b2r * inv2, bi = c.b1i * inv1 + c.b2i * inv2;

    float* ra = sre + col * ss;
    float* ia = sim + col * ss;
    float* rb = sre + (C + col) * ss;
    float* ib = sim + (C + col) * ss;
    const float wa_pr = ra[sp], wa_pi = ia[sp], wa_mr = ra[spm], wa_mi = ia[spm];
    const float wb_pr = rb[sp], wb_pi = ib[sp], wb_mr = rb[spm], wb_mi = ib[spm];
    // V = A W + B conj(Wn), Wn = W(-k) from the partner column at pm.
    auto vre = [&](float wr, float wi, float nr, float ni) {
      return ar * wr - ai * wi + br * nr + bi * ni;
    };
    auto vim = [&](float wr, float wi, float nr, float ni) {
      return ai * wr + ar * wi + bi * nr - br * ni;
    };
    ra[sp] = vre(wa_pr, wa_pi, wb_mr, wb_mi);
    ia[sp] = vim(wa_pr, wa_pi, wb_mr, wb_mi);
    ra[spm] = vre(wa_mr, wa_mi, wb_pr, wb_pi);
    ia[spm] = vim(wa_mr, wa_mi, wb_pr, wb_pi);
    rb[sp] = vre(wb_pr, wb_pi, wa_mr, wa_mi);
    ib[sp] = vim(wb_pr, wb_pi, wa_mr, wa_mi);
    rb[spm] = vre(wb_mr, wb_mi, wa_pr, wa_pi);
    ib[spm] = vim(wb_mr, wb_mi, wa_pr, wa_pi);
  }
  __syncthreads();
}

// Writes the C columns of group g (0 = own slots, 1 = mirror slots) from
// natural-order columns at re/im + (colbase + col) * cs, scaled. A
// self-mirror slot is its own partner: it is written from the own group only.
template <bool kMixed>
__device__ __forceinline__ void write_group(float* __restrict__ out, size_t plane,
                                            const float* re, const float* im,
                                            int cs, int colbase, int g,
                                            const int* own, const int* mir,
                                            int C, int M, int P, int m, int sub,
                                            float scale) {
  const int* slots = g == 0 ? own : mir;
  for (int idx = threadIdx.x; idx < C * M; idx += blockDim.x) {
    const int col = idx % C, row = idx / C;
    const int a = slots[col];
    if (a < 0 || (g == 1 && a == own[col])) continue;
    const size_t off = (size_t)row * P + a;
    const int p = (colbase + col) * cs + (kMixed ? sub_slot(row, m, sub) : pad(row));
    out[off] = re[p] * scale;
    out[off + plane] = im[p] * scale;
  }
}

// ---------------------------------------------------------------------------
// K3: the mirror-pair x-kernel. For a y-spectral field Zy (permuted y slots,
// natural x rows) computes, per y slot a,
//   W = fft_x(Zy[:, a]),  V = A W + B conj(W(-k)),  out[:, a] = ifft_x(V),
// where W(-k) lives in the mirror slot b = sigma(a) (y-frequency negated) at
// the negated x-frequency. A and B fold the modal projection P^-1, the
// Poisson and modified-Helmholtz solves and the back-projection into two
// complex symbols (tpu_qg/ops/spectral.py:138-211).
//
// Replaces tpu_qg/ops/pallas_fft.py PlanarFFT2.pair_x_symbols
// (_build_pair_x_kernel, _symbols_for_block, _perm_matrices).
//
// Bound: device-memory bandwidth once the x-transforms stay on chip (one
// read and one write of the field, 2 x 33.5 MB at 2048^2), with the strided
// x-axis making coalescing the hard part. Design: a block takes C slots and
// their C mirror slots (host-built task table, each unordered pair exactly
// once, so self-mirror slots — y-frequency 0 and P/2 — are written once).
// Mirror slots of adjacent slots are adjacent, so a warp reads runs of C
// contiguous floats per row from both groups. All 2C columns (~C*M*16
// bytes, 133 KB at M = 2048, C = 4; dynamic shared memory above 48 KB) are
// forward-transformed in place, the symbol stage pairs bit-reversed
// positions p and pm (x-frequency k and -k) so it updates all four values of
// a pair in place, and the inverse transform brings both columns back to
// natural x order for the write. The symbols are rebuilt from indices in
// the cancellation-free form lambda = -4/dx^2 (sin^2(pi kx'/M) +
// sin^2(pi ky'/P)), k' = min(k, N - k), with inv1 = 0 at (0, 0)
// (zero-mean gauge). For M = R * m (m odd > 1) each column's m radix-2
// sub-transforms are joined into a second buffer in natural x order, the
// symbol stage pairs natural positions there, and the split back into
// sub-columns precedes the inverse passes; the wrapper halves C until
// both buffers fit.
// ---------------------------------------------------------------------------

// 512 threads of at most 128 registers: the 4-stage register passes fit.
template <bool kMixed>
__global__ void __launch_bounds__(512)
pair_x_kernel(const float* __restrict__ in, float* __restrict__ out,
              const int* __restrict__ own_slots,
              const int* __restrict__ mirror_slots, int M, int P, int logr,
              int m, int n1y, int ncols, int sub, int bstride, SymConsts c,
              const float2* __restrict__ tw, const float2* __restrict__ twn) {
  extern __shared__ float smem[];
  const int C = ncols, R = 1 << logr;
  const int cs = m * sub;                 // column: m sub-columns of R rows
  float* re = smem;                       // 2C columns: own 0..C-1, mirror C..2C-1
  float* im = smem + 2 * C * cs;
  float2* stw = reinterpret_cast<float2*>(smem + 4 * C * cs);
  float* bre = smem + 4 * C * cs + R;     // mixed: 2C natural-order spectra
  float* bim = bre + 2 * C * bstride;
  for (int k = threadIdx.x; k < R / 2; k += blockDim.x) stw[k] = tw[k];
  const size_t plane = (size_t)M * P;
  const int* own = own_slots + blockIdx.x * C;
  const int* mir = mirror_slots + blockIdx.x * C;

  // blockDim is a multiple of C (the wrapper checks), so each thread keeps
  // one column: element idx is row idx / C of column threadIdx.x % C.
  const int col = threadIdx.x % C;
  for (int g = 0; g < 2; ++g) {
    const int a = (g == 0 ? own : mir)[col];
    float* dst = re + (g * C + col) * cs;
    load_planar(in, plane, dst, 2 * C * cs, C * M,
                [=](int idx) { return a < 0 ? -1LL : (long long)(idx / C) * P + a; },
                [=](int idx) {
                  return kMixed ? sub_slot(idx / C, m, sub) : pad(idx / C);
                });
  }
  __syncthreads();
  fft_dif(re, im, 2 * C * m, sub, logr, stw);

  if constexpr (kMixed) {
    // Join each column's sub-transforms into natural x order.
    for (int idx = threadIdx.x; idx < 2 * C * M; idx += blockDim.x) {
      const int cc = idx / M, k = idx - cc * M;
      const float2 v = mixed_fwd(re + cc * cs, im + cc * cs, sub, m, M, logr, k, twn);
      bre[cc * bstride + pad(k)] = v.x;
      bim[cc * bstride + pad(k)] = v.y;
    }
    __syncthreads();
    symbol_stage<true>(bre, bim, bstride, C, own, M, P, logr, n1y, c);
    split_cols(bre, bim, bstride, 0, 2 * C, re, im, cs, sub, m, M, logr, twn);
  } else {
    symbol_stage<false>(re, im, cs, C, own, M, P, logr, n1y, c);
  }
  ifft_dit(re, im, 2 * C * m, sub, logr, stw);

  const float scale = 1.0f / static_cast<float>(M);   // exact when m = 1
  for (int g = 0; g < 2; ++g)
    write_group<kMixed>(out, plane, re, im, cs, g * C, g, own, mir, C, M, P,
                        m, sub, scale);
}

// ---------------------------------------------------------------------------
// K4: 1-D DFT along x (the strided axis) of a planar (2, M, P) field, for
// every y slot. Forward: natural -> permuted x order. Inverse: permuted ->
// natural x order, scaled 1/M.
//
// Replaces tpu_qg/ops/pallas_fft.py PlanarFFT2._call_x (_build_kernel(axis=
// "x")) and the unfused streaming form _call_x_stream(z, inverse)
// (_build_streaming_x, consts=None). The streaming form exists only because
// (2, M, 128) strips at M >= 4608 outgrow a TPU core's scoped VMEM; it
// computes what the BlockSpec form computes, and on Hopper one kernel serves
// every M: a column of M = 8192 values is 64 KB of shared memory.
//
// Bound: device-memory bandwidth (one read and one write of the field,
// 2 x 537 MB at 8192^2, against ~5 M log2 M flops per column), with the
// strided axis making coalescing the hard part, as in K3. Design: a block
// takes C adjacent y slots (C the most that fit, 1-8), so a warp reads and
// writes runs of C contiguous floats per row; the C columns are transformed
// in shared memory, and the permuted order of the spectrum is a gather
// (forward) or scatter (inverse) in shared memory, as in K2. A mixed extent
// M = R * m joins the m sub-transforms while it writes the spectrum
// (forward) and splits the spectrum in a second buffer before its radix-2
// passes (inverse).
// ---------------------------------------------------------------------------
template <bool kMixed>
__global__ void __launch_bounds__(512)
x_dft_kernel(const float* __restrict__ in, float* __restrict__ out, int M,
             int P, int logr, int m, int n1x, int inverse, int ncols, int sub,
             int bstride, const float2* __restrict__ tw,
             const float2* __restrict__ twn) {
  extern __shared__ float smem[];
  const int C = ncols, R = 1 << logr;
  const int cs = m * sub;
  float* re = smem;                        // C columns of m sub-columns
  float* im = smem + C * cs;
  float2* stw = reinterpret_cast<float2*>(smem + 2 * C * cs);
  float* bre = smem + 2 * C * cs + R;      // mixed inverse: C natural spectra
  float* bim = bre + C * bstride;
  for (int k = threadIdx.x; k < R / 2; k += blockDim.x) stw[k] = tw[k];
  const size_t plane = (size_t)M * P;
  const int c0 = blockIdx.x * C;
  const int n2x = M / n1x;
  // Element i of the block is row i / C of column c0 + i % C; columns past
  // P (a ragged last block) read zeros and are not written.
  auto gidx = [=](int i) {
    const int col = c0 + i % C;
    return col < P ? (long long)(i / C) * P + col : -1LL;
  };

  if (!inverse) {
    load_planar(in, plane, re, C * cs, C * M, gidx, [=](int i) {
      return (i % C) * cs + (kMixed ? sub_slot(i / C, m, sub) : pad(i / C));
    });
    __syncthreads();
    fft_dif(re, im, C * m, sub, logr, stw);
    for (int i = threadIdx.x; i < C * M; i += blockDim.x) {
      const int cc = i % C, s = i / C;
      if (c0 + cc >= P) continue;
      const int f = slot_freq(s, n1x, n2x);
      float2 v;
      if constexpr (kMixed) {
        v = mixed_fwd(re + cc * cs, im + cc * cs, sub, m, M, logr, f, twn);
      } else {
        const int p = cc * cs + pad(bitrev(f, logr));
        v = make_float2(re[p], im[p]);
      }
      const size_t off = (size_t)s * P + c0 + cc;
      out[off] = v.x;
      out[off + plane] = v.y;
    }
    return;
  }
  if constexpr (kMixed) {
    load_planar(in, plane, bre, C * bstride, C * M, gidx, [=](int i) {
      return (i % C) * bstride + pad(slot_freq(i / C, n1x, n2x));
    });
    __syncthreads();
    split_cols(bre, bim, bstride, 0, C, re, im, cs, sub, m, M, logr, twn);
  } else {
    load_planar(in, plane, re, C * cs, C * M, gidx, [=](int i) {
      return (i % C) * cs + pad(bitrev(slot_freq(i / C, n1x, n2x), logr));
    });
    __syncthreads();
  }
  ifft_dit(re, im, C * m, sub, logr, stw);
  const float scale = 1.0f / static_cast<float>(M);   // exact when m = 1
  for (int i = threadIdx.x; i < C * M; i += blockDim.x) {
    const int cc = i % C, n = i / C;
    if (c0 + cc >= P) continue;
    const int p = cc * cs + (kMixed ? sub_slot(n, m, sub) : pad(n));
    const size_t off = (size_t)n * P + c0 + cc;
    out[off] = re[p] * scale;
    out[off + plane] = im[p] * scale;
  }
}

// ---------------------------------------------------------------------------
// K5: the symbol stage and the inverse x-DFT. For a spectrum W in permuted
// order on both axes computes, per y slot a,
//   V = A W + B conj(W(-k)),  out[:, a] = ifft_x(V)   (natural x order),
// the output staying in the permuted y-spectrum for K2^-1.
//
// Replaces tpu_qg/ops/pallas_fft.py PlanarFFT2._call_x_symbols
// (_build_symbol_inv_x_kernel) and the fused streaming form
// _call_x_stream(Z, True, consts) (_build_streaming_x with consts), which
// computes the same for M >= 4608 (see K4).
//
// Bound and design: K3 without its forward stage. A block takes C mirror
// pairs of y slots from K3's task table (each unordered pair once), so W is
// read and psi written once; each value of W is loaded straight to the
// position where the inverse transform expects its x-frequency k (the
// bit-reversed position of k for m = 1, the natural position k in the
// spectrum buffer of a mixed extent), which is where K3's symbol stage finds
// it after its forward pass, so the symbol stage is K3's. A mixed extent
// splits and inverts the own group and then the mirror group through one
// set of sub-column buffers, so that 2C spectra and C sub-column columns fit
// shared memory up to M = 128 * 63.
// ---------------------------------------------------------------------------
template <bool kMixed>
__global__ void __launch_bounds__(512)
x_symbols_inverse_kernel(const float* __restrict__ in, float* __restrict__ out,
                         const int* __restrict__ own_slots,
                         const int* __restrict__ mirror_slots, int M, int P,
                         int logr, int m, int n1x, int n1y, int ncols, int sub,
                         int bstride, SymConsts c,
                         const float2* __restrict__ tw,
                         const float2* __restrict__ twn) {
  extern __shared__ float smem[];
  const int C = ncols, R = 1 << logr;
  const int cs = m * sub;
  const int nsub = kMixed ? C : 2 * C;     // sub-column columns held at once
  float* re = smem;
  float* im = smem + nsub * cs;
  float2* stw = reinterpret_cast<float2*>(smem + 2 * nsub * cs);
  float* bre = smem + 2 * nsub * cs + R;   // mixed: 2C natural-order spectra
  float* bim = bre + 2 * C * bstride;
  for (int k = threadIdx.x; k < R / 2; k += blockDim.x) stw[k] = tw[k];
  const size_t plane = (size_t)M * P;
  const int* own = own_slots + blockIdx.x * C;
  const int* mir = mirror_slots + blockIdx.x * C;
  const int n2x = M / n1x;

  const int col = threadIdx.x % C;        // blockDim is a multiple of C
  for (int g = 0; g < 2; ++g) {
    const int a = (g == 0 ? own : mir)[col];
    float* dst = kMixed ? bre + (g * C + col) * bstride : re + (g * C + col) * cs;
    load_planar(in, plane, dst, kMixed ? 2 * C * bstride : nsub * cs, C * M,
                [=](int idx) { return a < 0 ? -1LL : (long long)(idx / C) * P + a; },
                [=](int idx) {
                  const int f = slot_freq(idx / C, n1x, n2x);
                  return kMixed ? pad(f) : pad(bitrev(f, logr));
                });
  }
  __syncthreads();

  const float scale = 1.0f / static_cast<float>(M);   // exact when m = 1
  if constexpr (kMixed) {
    symbol_stage<true>(bre, bim, bstride, C, own, M, P, logr, n1y, c);
    for (int g = 0; g < 2; ++g) {
      split_cols(bre, bim, bstride, g * C, C, re, im, cs, sub, m, M, logr, twn);
      ifft_dit(re, im, C * m, sub, logr, stw);
      write_group<true>(out, plane, re, im, cs, 0, g, own, mir, C, M, P, m,
                        sub, scale);
      __syncthreads();                     // the next group reuses re/im
    }
  } else {
    symbol_stage<false>(re, im, cs, C, own, M, P, logr, n1y, c);
    ifft_dit(re, im, 2 * C, sub, logr, stw);
    for (int g = 0; g < 2; ++g)
      write_group<false>(out, plane, re, im, cs, g * C, g, own, mir, C, M, P,
                         m, sub, scale);
  }
}

int set_smem(const void* kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

SymConsts sym_consts(const float* consts) {
  SymConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumSymConsts; ++k) dst[k] = consts[k];
  return c;
}

}  // namespace

extern "C" int qg_pair_x_num_consts() { return kNumSymConsts; }

extern "C" int qg_y_dft_launch(const float* in, float* out, int rows, int P,
                               int logr, int m, int n1, int inverse,
                               const void* tw, const void* twn, int threads,
                               void* stream) {
  // m sub-columns (re, im; padded), the radix-2 table (R/2 float2) and, for
  // m > 1, the natural-order spectrum (re, im; padded).
  const int R = 1 << logr;
  const int smem = (2 * m * pad(R) + R + (m > 1 ? 2 * pad(P) : 0)) *
                   static_cast<int>(sizeof(float));
  auto kernel = m > 1 ? y_dft_kernel<true> : y_dft_kernel<false>;
  if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  kernel<<<rows, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, rows, P, logr, m, n1, inverse, static_cast<const float2*>(tw),
      static_cast<const float2*>(twn));
  return static_cast<int>(cudaGetLastError());
}

// consts: host array of kNumSymConsts floats in SymConsts order.
extern "C" int qg_pair_x_launch(const float* in, float* out, const int* own_slots,
                                const int* mirror_slots, int ntasks, int M, int P,
                                int logr, int m, int n1y, int ncols, int sub,
                                int bstride, const float* consts, const void* tw,
                                const void* twn, int threads, void* stream) {
  // 2C columns of m sub-columns (re, im), the radix-2 table (R/2 float2)
  // and, for m > 1, 2C natural-order spectra (re, im).
  const int smem = (4 * ncols * m * sub + (1 << logr) +
                    (m > 1 ? 4 * ncols * bstride : 0)) *
                   static_cast<int>(sizeof(float));
  if (threads % ncols != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m > 1 ? pair_x_kernel<true> : pair_x_kernel<false>;
  if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  kernel<<<ntasks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, own_slots, mirror_slots, M, P, logr, m, n1y, ncols, sub,
      bstride, sym_consts(consts), static_cast<const float2*>(tw),
      static_cast<const float2*>(twn));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qg_x_dft_launch(const float* in, float* out, int M, int P,
                               int logr, int m, int n1x, int inverse, int ncols,
                               int sub, int bstride, const void* tw,
                               const void* twn, int threads, void* stream) {
  // C columns of m sub-columns (re, im), the radix-2 table (R/2 float2)
  // and, for the inverse of m > 1, C natural-order spectra (re, im).
  const int smem = (2 * ncols * m * sub + (1 << logr) +
                    (m > 1 && inverse ? 2 * ncols * bstride : 0)) *
                   static_cast<int>(sizeof(float));
  if (threads % ncols != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m > 1 ? x_dft_kernel<true> : x_dft_kernel<false>;
  if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  kernel<<<(P + ncols - 1) / ncols, threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      in, out, M, P, logr, m, n1x, inverse, ncols, sub, bstride,
      static_cast<const float2*>(tw), static_cast<const float2*>(twn));
  return static_cast<int>(cudaGetLastError());
}

// consts: host array of kNumSymConsts floats in SymConsts order.
extern "C" int qg_x_symbols_launch(const float* in, float* out,
                                   const int* own_slots, const int* mirror_slots,
                                   int ntasks, int M, int P, int logr, int m,
                                   int n1x, int n1y, int ncols, int sub,
                                   int bstride, const float* consts,
                                   const void* tw, const void* twn, int threads,
                                   void* stream) {
  // m = 1: 2C columns (re, im) and the radix-2 table; m > 1: C columns of m
  // sub-columns, the table and 2C natural-order spectra.
  const int nsub = m > 1 ? ncols : 2 * ncols;
  const int smem = (2 * nsub * m * sub + (1 << logr) +
                    (m > 1 ? 4 * ncols * bstride : 0)) *
                   static_cast<int>(sizeof(float));
  if (threads % ncols != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m > 1 ? x_symbols_inverse_kernel<true>
                      : x_symbols_inverse_kernel<false>;
  if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  kernel<<<ntasks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, out, own_slots, mirror_slots, M, P, logr, m, n1x, n1y, ncols, sub,
      bstride, sym_consts(consts), static_cast<const float2*>(tw),
      static_cast<const float2*>(twn));
  return static_cast<int>(cudaGetLastError());
}
