// Device code of the packed inversion, shared by the DFT kernels
// (dft_kernels.cu: K2-K5) and the one-launch kernels (fused_kernels.cu:
// K15-K17): radix-2 FFTs in shared memory, the mixed-radix joins, the
// symbol stage, one y-transform task (y_rows, K2's body) and one
// mirror-pair x-stage task (pair_x_task, K3's body). Conventions and
// design notes are in dft_kernels.cu.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"

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
// each global load before its shared-memory store. kL2: see ld().
constexpr int kBatch = 8;

template <bool kL2 = false, class GIdx, class SIdx>
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
      vr[u] = g >= 0 ? ld<kL2>(src + g) : 0.0f;
      vi[u] = g >= 0 ? ld<kL2>(src + g + src_plane) : 0.0f;
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

// The scalars from which K3 and K5 rebuild the packed-inversion symbols A
// and B (see K3 in dft_kernels.cu).
struct SymConsts {
  float inv_dx2, alpha2;
  float a1r, a1i, a2r, a2i, b1r, b1i, b2r, b2i;
};
constexpr int kNumSymConsts = sizeof(SymConsts) / sizeof(float);

inline SymConsts sym_consts(const float* consts) {
  SymConsts c;
  float* dst = reinterpret_cast<float*>(&c);
  for (int k = 0; k < kNumSymConsts; ++k) dst[k] = consts[k];
  return c;
}

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

// One y-transform task (K2's body): rows row0 .. row0 + nrows - 1 of a
// planar (2, rows, P) field from src to dst, P = R * m. Forward: natural ->
// permuted spectrum; inverse: permuted -> natural, scaled 1/P. src may be
// dst: every value of the task's rows is loaded before any is written.
// Shared memory at smem: the rows' m sub-columns each (re, then im) and,
// for m > 1, the rows' natural-order spectra (re, then im) — y_rows_floats
// floats a row; the radix-2 table at stw. The reorder into permuted order is
// a gather from shared memory, so global reads and writes run along rows.
// Ends with a barrier: the caller may reuse shared memory.
__host__ __device__ __forceinline__ int y_rows_floats(int P, int logr, int m) {
  return 2 * m * pad(1 << logr) + (m > 1 ? 2 * pad(P) : 0);
}

template <bool kMixed, bool kL2>
__device__ void y_rows(const float* src, float* dst, size_t plane, int row0,
                       int nrows, int P, int logr, int m, int n1, bool inverse,
                       const float2* stw, const float2* __restrict__ twn,
                       float* smem) {
  const int R = 1 << logr;
  const int sub = pad(R);
  const int rs = m * sub;                 // floats of a row's sub-columns
  const int bs = pad(P);                  // floats of a row's spectrum
  float* re = smem;
  float* im = smem + nrows * rs;
  float* bre = smem + 2 * nrows * rs;     // mixed: natural-order spectra
  float* bim = bre + nrows * bs;
  const float* in = src + (size_t)row0 * P;
  float* out_r = dst + (size_t)row0 * P;
  float* out_i = out_r + plane;
  const int n2 = P / n1;
  const int count = nrows * P;
  // Element i of the task is column i - r P of row r = i / P.
  auto row_of = [=](int i) { return kMixed ? i / P : i >> logr; };
  auto contiguous = [](int i) { return (long long)i; };

  if (!inverse) {
    load_planar<kL2>(in, plane, re, nrows * rs, count, contiguous, [=](int i) {
      const int r = row_of(i), n = i - r * P;
      return r * rs + (kMixed ? sub_slot(n, m, sub) : pad(n));
    });
    __syncthreads();
    fft_dif(re, im, nrows * m, sub, logr, stw);
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = row_of(i);
      const int f = slot_freq(i - r * P, n1, n2);
      float2 v;
      if constexpr (kMixed) {
        v = mixed_fwd(re + r * rs, im + r * rs, sub, m, P, logr, f, twn);
      } else {
        const int p = r * rs + pad(bitrev(f, logr));
        v = make_float2(re[p], im[p]);
      }
      out_r[i] = v.x;
      out_i[i] = v.y;
    }
  } else {
    if constexpr (kMixed) {
      load_planar<kL2>(in, plane, bre, nrows * bs, count, contiguous, [=](int i) {
        const int r = i / P;
        return r * bs + pad(slot_freq(i - r * P, n1, n2));
      });
      __syncthreads();
      for (int i = threadIdx.x; i < count; i += blockDim.x) {
        const int r = i / P, t = i - r * P;
        const int a = t >> logr, k1 = t & (R - 1);
        const float2 v = mixed_inv(bre + r * bs, bim + r * bs, m, P, logr, a, k1, twn);
        const int p = r * rs + a * sub + pad(bitrev(k1, logr));
        re[p] = v.x;
        im[p] = v.y;
      }
    } else {
      load_planar<kL2>(in, plane, re, nrows * rs, count, contiguous, [=](int i) {
        const int r = i >> logr;
        return r * rs + pad(bitrev(slot_freq(i & (R - 1), n1, n2), logr));
      });
    }
    __syncthreads();
    ifft_dit(re, im, nrows * m, sub, logr, stw);
    const float scale = 1.0f / static_cast<float>(P);   // exact when m = 1
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const int r = row_of(i), n = i - r * P;
      const int p = r * rs + (kMixed ? sub_slot(n, m, sub) : pad(n));
      out_r[i] = re[p] * scale;
      out_i[i] = im[p] * scale;
    }
  }
  __syncthreads();
}

// One mirror-pair x-stage task (K3's body), on local columns:
// `own` holds C columns of src and `mir` the C columns of srcm that hold
// their mirrors (y-frequency negated), each a column of a planar (2, M, W)
// field, M = R * m; gsl holds each own column's global permuted y slot in
// the y extent P, from which the symbols are built. Forward x-DFT of all
// 2C columns, V = A W + B conj(W(-k)), inverse x-DFT, written to the same
// columns of dst: both groups, or (own_only) the own group alone. K3 is
// srcm = src, gsl = own, W = P; K7, K13 and K14 are the other instances
// (dft_kernels.cu). src may be dst: the task loads all 2C columns before it
// writes them, and distinct tasks own disjoint columns. Shared memory at
// smem: nsub columns of m sub-columns (re, then im; cs = m * sub floats
// each) and, for m > 1, 2C natural-order spectra (re, then im; bstride
// floats each); the radix-2 table at stw. nsub is 2C, or C for a mixed
// extent with `seq`: then the own and the mirror group pass through the
// sub-columns in turn, as in K5, so that a pair fits shared memory up to
// M = 128 * 63. blockDim.x must be a multiple of C. Ends with a barrier.
template <bool kL2>
__device__ void pair_cols_task_seq(const float* src, const float* srcm,
                                   float* dst, const int* own, const int* mir,
                                   const int* gsl, int M, int W, int P,
                                   int logr, int m, int n1y, int C, int sub,
                                   int bstride, bool own_only,
                                   const SymConsts& c, const float2* stw,
                                   const float2* __restrict__ twn, float* re,
                                   float* im, float* bre, float* bim) {
  const int cs = m * sub;
  const size_t plane = (size_t)M * W;
  const int col = threadIdx.x % C;
  for (int g = 0; g < 2; ++g) {          // forward, group by group
    const int a = (g == 0 ? own : mir)[col];
    load_planar<kL2>(g == 0 ? src : srcm, plane, re + col * cs, C * cs, C * M,
                     [=](int idx) { return a < 0 ? -1LL : (long long)(idx / C) * W + a; },
                     [=](int idx) { return sub_slot(idx / C, m, sub); });
    __syncthreads();
    fft_dif(re, im, C * m, sub, logr, stw);
    for (int idx = threadIdx.x; idx < C * M; idx += blockDim.x) {
      const int cc = idx / M, k = idx - cc * M;
      const float2 v = mixed_fwd(re + cc * cs, im + cc * cs, sub, m, M, logr, k, twn);
      bre[(g * C + cc) * bstride + pad(k)] = v.x;
      bim[(g * C + cc) * bstride + pad(k)] = v.y;
    }
    __syncthreads();
  }
  symbol_stage<true>(bre, bim, bstride, C, gsl, M, P, logr, n1y, c);
  const float scale = 1.0f / static_cast<float>(M);
  for (int g = 0; g < (own_only ? 1 : 2); ++g) {   // inverse and write
    split_cols(bre, bim, bstride, g * C, C, re, im, cs, sub, m, M, logr, twn);
    ifft_dit(re, im, C * m, sub, logr, stw);
    write_group<true>(dst, plane, re, im, cs, 0, g, own, mir, C, M, W, m, sub,
                      scale);
    __syncthreads();
  }
}

__host__ __device__ __forceinline__ int pair_x_floats(int C, int m, int sub,
                                                      int bstride, bool seq) {
  if (m == 1) return 4 * C * sub;
  return 2 * (seq ? C : 2 * C) * m * sub + 4 * C * bstride;
}

template <bool kMixed, bool kL2>
__device__ void pair_cols_task(const float* src, const float* srcm, float* dst,
                               const int* own, const int* mir, const int* gsl,
                               int M, int W, int P, int logr, int m, int n1y,
                               int C, int sub, int bstride, bool seq,
                               bool own_only, const SymConsts& c,
                               const float2* stw,
                               const float2* __restrict__ twn, float* smem) {
  const int cs = m * sub;                 // column: m sub-columns of R rows
  const int nsub = kMixed && seq ? C : 2 * C;
  float* re = smem;                       // own 0..C-1, then mirror C..2C-1
  float* im = smem + nsub * cs;
  float* bre = smem + 2 * nsub * cs;      // mixed: 2C natural-order spectra
  float* bim = bre + 2 * C * bstride;
  const size_t plane = (size_t)M * W;
  const int nout = own_only ? 1 : 2;      // groups inverted and written

  // Each thread keeps one column: element idx is row idx / C of column
  // threadIdx.x % C.
  const int col = threadIdx.x % C;
  if constexpr (kMixed) {
    if (seq) {
      pair_cols_task_seq<kL2>(src, srcm, dst, own, mir, gsl, M, W, P, logr, m,
                              n1y, C, sub, bstride, own_only, c, stw, twn, re,
                              im, bre, bim);
      return;
    }
  }
  for (int g = 0; g < 2; ++g) {
    const int a = (g == 0 ? own : mir)[col];
    float* to = re + (g * C + col) * cs;
    load_planar<kL2>(g == 0 ? src : srcm, plane, to, nsub * cs, C * M,
                     [=](int idx) { return a < 0 ? -1LL : (long long)(idx / C) * W + a; },
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
    symbol_stage<true>(bre, bim, bstride, C, gsl, M, P, logr, n1y, c);
    split_cols(bre, bim, bstride, 0, nout * C, re, im, cs, sub, m, M, logr,
               twn);
  } else {
    symbol_stage<false>(re, im, cs, C, gsl, M, P, logr, n1y, c);
  }
  ifft_dit(re, im, nout * C * m, sub, logr, stw);

  const float scale = 1.0f / static_cast<float>(M);   // exact when m = 1
  for (int g = 0; g < nout; ++g)
    write_group<kMixed>(dst, plane, re, im, cs, g * C, g, own, mir, C, M, W,
                        m, sub, scale);
  __syncthreads();
}

// K3's task: the C own y slots `own` and their C mirror slots `mir` of a
// y-spectral planar (2, M, P) field, both groups written.
template <bool kMixed, bool kL2>
__device__ void pair_x_task(const float* src, float* dst, const int* own,
                            const int* mir, int M, int P, int logr, int m,
                            int n1y, int C, int sub, int bstride, bool seq,
                            const SymConsts& c, const float2* stw,
                            const float2* __restrict__ twn, float* smem) {
  pair_cols_task<kMixed, kL2>(src, src, dst, own, mir, own, M, P, P, logr, m,
                              n1y, C, sub, bstride, seq, false, c, stw, twn,
                              smem);
}

}  // namespace
