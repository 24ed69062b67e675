// The device code of the redesigned DFT kernels (dft_kernels.cu): the
// cluster kernels' FFT building blocks (il_fft_at, il_fft; the mixed-radix
// sweep mixed_fft_at), K2's factored bodies (y_factored_block,
// y_mixed_group), K4's cluster tile (x_cluster_tile), K5's symbol stage and
// cluster inverse (x_symbols_tile, sym_inverse_half, sym_inverse_mixed) and
// K3's mirror-pair cluster tile (pair_cluster_tile, also K13's and K14's),
// with each design's notes. The kernels of dft_kernels.cu launch them on
// blockIdx; the persistent one-launch kernels of coop_rows.cuh run K2's and
// K3's bodies in loops over the same units.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "fft_device.cuh"

namespace {

// The cluster kernel's block: 256 threads of at most 128 registers, so that
// two blocks share an SM where their shared memory fits.
constexpr int kClusterThreads = 256;

// a * b, or a * conj(b).
__device__ __forceinline__ float2 cmul(float2 a, float2 b, bool conj_b) {
  return conj_b ? make_float2(a.x * b.x + a.y * b.y, a.y * b.x - a.x * b.y)
                : make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// The columns of a pass: 2^lognc of them (an int, shift and mask), or any
// count (NCols: the mixed-extent K2's stage B over Rb N2 p-rows). t is
// column t mod count of group t / count.
struct NCols {
  int n;
};
__device__ __forceinline__ int cols_times(int lognc, int x) { return x << lognc; }
__device__ __forceinline__ int cols_times(NCols c, int x) { return x * c.n; }
__device__ __forceinline__ int cols_group(int lognc, int t) { return t >> lognc; }
__device__ __forceinline__ int cols_group(NCols c, int t) { return t / c.n; }
__device__ __forceinline__ int cols_col(int lognc, int t, int) {
  return t & ((1 << lognc) - 1);
}
__device__ __forceinline__ int cols_col(NCols c, int t, int g) {
  return t - g * c.n;
}

// One radix-2^K pass (K consecutive radix-2 stages, spans 2^(lo+K-1) ..
// 2^lo) over `cols` columns of length 2^logn by a block of kThreads
// threads: thread t takes column t mod (column count) and a group of 2^K
// elements, read through in(pos, col) into registers and written through
// out(pos, col, value), so that a pass can read device memory or a peer's
// shared memory and write either. A warp takes consecutive columns of a
// row. The butterflies and twiddles are group_pass's (fft_device.cuh);
// element j's twiddle index at stage q is written as (g mod 2^lo) +
// (j mod 2^q) 2^lo, so that the compiler loads each of a group's 2^K - 1
// distinct twiddles once, not once a butterfly.
template <int K, bool kInverse, int kThreads, class Cols, class In, class Out>
__device__ __forceinline__ void il_pass(Cols cols, int logn, int lo,
                                        const float2* tw, In in, Out out) {
  constexpr int GS = 1 << K;
  const int s = 1 << lo;
  const int count = cols_times(cols, 1 << (logn - K));   // groups x columns
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const int g = cols_group(cols, t), col = cols_col(cols, t, g);
    const int base = ((g >> lo) << (lo + K)) + (g & (s - 1));
    float2 x[GS];
#pragma unroll
    for (int j = 0; j < GS; ++j) x[j] = in(base + j * s, col);
#pragma unroll
    for (int step = 0; step < K; ++step) {
      const int q = kInverse ? step : K - 1 - step;
      const int lh = lo + q;
      const int tws = logn - 1 - lh;
#pragma unroll
      for (int j = 0; j < GS; ++j) {
        if (j & (1 << q)) continue;
        const int k = j + (1 << q);
        const int pos = (g & (s - 1)) + ((j & ((1 << q) - 1)) << lo);
        const float2 w = tw[pos << tws];
        const float2 u = x[j], v = x[k];
        if (!kInverse) {
          x[j] = make_float2(u.x + v.x, u.y + v.y);
          x[k] = cmul(make_float2(u.x - v.x, u.y - v.y), w, false);
        } else {
          const float2 tv = cmul(v, w, true);
          x[j] = make_float2(u.x + tv.x, u.y + tv.y);
          x[k] = make_float2(u.x - tv.x, u.y - tv.y);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < GS; ++j) out(base + j * s, col, x[j]);
  }
}

template <bool kInverse, int kThreads, class Cols, class In, class Out>
__device__ __forceinline__ void il_pass_k(int k, Cols lognc, int logn, int lo,
                                          const float2* tw, In in, Out out) {
  switch (k) {
    case 4: return il_pass<4, kInverse, kThreads>(lognc, logn, lo, tw, in, out);
    case 3: return il_pass<3, kInverse, kThreads>(lognc, logn, lo, tw, in, out);
    case 2: return il_pass<2, kInverse, kThreads>(lognc, logn, lo, tw, in, out);
    default:
      return il_pass<1, kInverse, kThreads>(lognc, logn, lo, tw, in, out);
  }
}

// Radix-2 DIF (forward: natural in, bit-reversed out) or inverse DIT
// (bit-reversed in, natural out, unscaled) of columns of length 2^logn
// (2^lognc of them, or an NCols count) by a block of kThreads threads
// (il_pass), in passes of at most kGroupStages stages: the first as long
// as leaves the rest at least 2
// each (64 points: 4 + 2, 128: 4 + 3, 32: 3 + 2), so its loads are few,
// long batches. The first pass reads through in(pos, col), the last writes
// through out(pos, col, value); between passes element (pos, col) sits in
// shared memory at at(pos, col), with a barrier after each write.
// after_first() runs after the first pass. No barrier after the last pass.
template <int kThreads, bool kInverse, class Cols, class In, class Out,
          class At, class Mid>
__device__ void il_fft_at(Cols lognc, int logn, const float2* tw, In in,
                          Out out, At at, Mid after_first) {
  auto rd = [=](int pos, int col) { return *at(pos, col); };
  auto wr = [=](int pos, int col, float2 v) { *at(pos, col) = v; };
  const int npass = (logn + kGroupStages - 1) / kGroupStages;
  for (int p = 0, done = 0; p < npass; ++p) {
    const int left = npass - p;
    const int k = p == 0 ? min(kGroupStages, logn - 2 * (left - 1))
                         : (logn - done + left - 1) / left;
    const int lo = kInverse ? done : logn - done - k;
    if (p == 0 && left == 1) {
      il_pass_k<kInverse, kThreads>(k, lognc, logn, lo, tw, in, out);
    } else if (p == 0) {
      il_pass_k<kInverse, kThreads>(k, lognc, logn, lo, tw, in, wr);
    } else if (left == 1) {
      il_pass_k<kInverse, kThreads>(k, lognc, logn, lo, tw, rd, out);
    } else {
      il_pass_k<kInverse, kThreads>(k, lognc, logn, lo, tw, rd, wr);
    }
    if (p == 0) after_first();
    if (left > 1) __syncthreads();
    done += k;
  }
}

// il_fft_at for the cluster kernel's block, the columns (2^lognc, or an
// NCols count) interleaved in buf: element (pos, col) at buf[pos * stride +
// col].
template <bool kInverse, class Cols, class In, class Out, class Mid>
__device__ void il_fft(float2* buf, Cols lognc, int stride, int logn,
                       const float2* tw, In in, Out out, Mid after_first) {
  il_fft_at<kClusterThreads, kInverse>(
      lognc, logn, tw, in, out,
      [=](int pos, int col) { return buf + pos * stride + col; }, after_first);
}

// ---------------------------------------------------------------------------
// K2 on power-of-two extents, P = 128 * 2^b (1 <= b <= 6): the factored row
// kernel. It computes what y_dft_kernel computes, and so replaces the same
// TPU function, tpu_qg/ops/pallas_fft.py PlanarFFT2._call_y (:1100);
// y_dft_mixed_kernel (below) takes the other P = 128 * n, y_dft_kernel keeps
// P <= 128, and y_rows stays the one-launch kernels' row task.
//
// Bound: device-memory bandwidth, one read and one write of the field (2 x
// 537 MB at 8192^2: 0.321 ms at 3.35 TB/s). y_dft_kernel holds a whole row
// in shared memory beside its own copy of the R/2-entry twiddle table (98 KB
// a block at P = 8192: two 256-thread blocks, 16 warps, an SM), loads the
// row, runs its 13 radix-2 stages in four barrier-separated passes and then
// gathers the permuted order, one phase after another.
//
// The transform is factored as K4's cluster kernel's, along y (N1 = 128,
// N2 = P / 128; n = N1 n2 + n1, slot k2 N1 + k1 holding frequency k2 + N2 k1):
//   X[k2 N1 + k1] = sum_n1 W_N1^(n1 k1) W_P^(n1 k2) sum_n2 W_N2^(n2 k2) x[N1 n2 + n1]
// A block takes Rb rows; row r sits in shared memory as N2 p-rows of 128
// float2, element (p, q) at y_fac_at(r N2 + p, q): an odd stride between
// p-rows (stage B's warps take consecutive p) and a pad word every 16 q
// (the bit-reversed sweeps), so every pass and sweep is free of bank
// conflicts for N2 Rb >= 16.
//   forward  stage A: N2-point DIF along n2 for each column n1, its first
//            pass reading device memory straight into registers (a warp
//            reads 128-byte runs of each plane, up to 32 loads a thread in
//            flight), its last pass writing (p, n1) times W_P^(n1 k2), k2 =
//            bitrev(p); stage B: 128-point DIF along n1 for each p, after
//            which (p, q) holds slot bitrev(p) N1 + bitrev7(q); a sweep
//            stores the slots in order, 128-byte runs of each plane a warp.
//   inverse  the mirror image: a sweep loads slot k2 N1 + k1 to (bitrev(k2),
//            bitrev7(k1)) (kBatch loads a thread in flight); 128-point
//            inverse DIT along q, its last pass times conj(W_P^(n1 k2));
//            N2-point inverse DIT along p, its last pass writing
//            x[N1 n2 + n1] / P to device memory.
// Radix-2 passes of up to 4 stages run in registers (il_pass): 8192 takes
// 4 + 2 stages in stage A and 4 + 3 in stage B. The stage tables (W_N2^k,
// N2/2 entries; W_128^k, 64) and the inter-stage twiddle's two factors
// (W_P^(j mod 64), 64 entries, and W_P^(64 floor(j / 64)), P/64; j = n1 k2 <
// P) are read once a block from the P-entry table of W_P^j built in float64
// on the host: 2.25 KB at P = 8192, against y_dft_kernel's 32 KB a row.
// Shared memory: Rb N2 kYRowStride float2 and the tables, 69.75 KB at
// P = 8192, Rb = 1 (dft_kernels.y_dft_factored_layout): three blocks an SM.
// The register budget (y_min_blocks) lets 256-thread blocks fit three to an
// SM and 512-thread blocks two. The grid is ceil(rows / Rb) blocks;
// rows past the field (a ragged last block) are read from the last row and
// not written.
// ---------------------------------------------------------------------------
constexpr int kYRowStride = 135;   // float2 a p-row: y_fac_at(0, 127) = 134

// Blocks an SM that the register budget admits: 256-thread blocks three
// (80 registers a thread), 512-thread blocks two (64).
constexpr int y_min_blocks(int threads) { return threads == 256 ? 3 : 2; }

__device__ __forceinline__ int y_fac_at(int prow, int q) {
  return prow * kYRowStride + q + (q >> 4);
}

// The power-of-two kernel's block on its row group `group` (rows group Rb
// .. group Rb + Rb - 1): the tables W_N2^k (twa, k < N2 / 2), W_128^k (twb,
// k < 64), W_P^j (tlo, j < 64) and W_P^(64 j) (thi, j < P / 64) past the Rb
// N2 p-rows at S, a block barrier, then the group. kL2: the field is read
// through L2 (ldg), as the one-launch kernels read a field written earlier
// in their launch. A group loads all its rows before it stores any, so in
// may be out (the pointers are not restrict: the kernel's own are). Ends
// with the group's last stores: a caller that runs another group puts a
// block barrier between them.
template <int kThreads, bool kInverse, bool kL2 = false>
__device__ __forceinline__ void y_factored_block(const float* in, float* out,
                                                 int rows, int logn2,
                                                 int logrb,
                                                 const float2* wm,
                                                 float2* S, unsigned group) {
  const int n2 = 1 << logn2, logp = logn2 + 7, P = 1 << logp;
  float2* twa = S + (n2 << logrb) * kYRowStride;     // W_N2^k, k < N2 / 2
  float2* twb = twa + n2 / 2;                        // W_128^k, k < 64
  float2* tlo = twb + 64;                            // W_P^j, j < 64
  float2* thi = tlo + 64;                            // W_P^(64 j), j < P / 64
  for (int k = threadIdx.x; k < n2 / 2; k += kThreads) twa[k] = wm[k << 7];
  for (int k = threadIdx.x; k < 64; k += kThreads) {
    twb[k] = wm[k << logn2];
    tlo[k] = wm[k];
  }
  for (int k = threadIdx.x; k < 2 * n2; k += kThreads) thi[k] = wm[k << 6];
  __syncthreads();

  const size_t plane = (size_t)rows * P;
  const int row0 = group << logrb;
  const int nrow = min(1 << logrb, rows - row0);
  const size_t first = (size_t)row0 << logp;
  auto ld = [=](int e) {                   // element e of the block's rows
    return make_float2(ldg<kL2>(in + first + e),
                       ldg<kL2>(in + first + e + plane));
  };
  auto twiddle = [=](int n1, int k2) {
    const int j = n1 * k2;
    return cmul(thi[j >> 6], tlo[j & 63], false);
  };
  // Stage A's column r N1 + n1, position p along n2; stage B's column
  // r N2 + p, position q along n1; the sweeps' element i, slot s of row r.
  auto at_a = [=](int p, int col) {
    return S + y_fac_at(((col >> 7) << logn2) + p, col & 127);
  };
  auto at_b = [=](int q, int col) { return S + y_fac_at(col, q); };
  auto at_slot = [=](int i) {
    const int s = i & (P - 1);
    return S + y_fac_at(((i >> logp) << logn2) + bitrev(s >> 7, logn2),
                        bitrev(s & 127, 7));
  };
  auto rd_b = [=](int q, int col) { return *at_b(q, col); };
  auto none = [] {};
  const int lognc_a = logrb + 7, lognc_b = logrb + logn2;
  const int count = nrow << logp;

  if constexpr (!kInverse) {
    il_fft_at<kThreads, false>(lognc_a, logn2, twa,
        [=](int n, int col) {     // a row past the field reads the last
          return ld((min(col >> 7, nrow - 1) << logp) | (n << 7) |
                    (col & 127));
        },
        [=](int p, int col, float2 v) {
          *at_a(p, col) = cmul(v, twiddle(col & 127, bitrev(p, logn2)), false);
        }, at_a, none);
    __syncthreads();
    il_fft_at<kThreads, false>(lognc_b, 7, twb, rd_b,
        [=](int q, int col, float2 v) { *at_b(q, col) = v; }, at_b, none);
    __syncthreads();
    for (int i = threadIdx.x; i < count; i += kThreads) {
      const float2 v = *at_slot(i);
      out[first + i] = v.x;
      out[first + i + plane] = v.y;
    }
  } else {
    for (int i0 = threadIdx.x; i0 < count; i0 += kBatch * kThreads) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = ld(min(i0 + u * kThreads, count - 1));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0 + u * kThreads < count) *at_slot(i0 + u * kThreads) = v[u];
      }
    }
    __syncthreads();
    il_fft_at<kThreads, true>(lognc_b, 7, twb, rd_b,
        [=](int q, int col, float2 v) {
          *at_b(q, col) = cmul(v, twiddle(q, bitrev(col & (n2 - 1), logn2)),
                               true);
        }, at_b, none);
    __syncthreads();
    const float scale = 1.0f / static_cast<float>(P);    // exact: P = 2^k
    il_fft_at<kThreads, true>(lognc_a, logn2, twa,
        [=](int p, int col) { return *at_a(p, col); },
        [=](int n, int col, float2 v) {
          if ((col >> 7) >= nrow) return;
          const size_t off = first + ((size_t)(col >> 7) << logp) +
                             (n << 7) + (col & 127);
          out[off] = v.x * scale;
          out[off + plane] = v.y * scale;
        }, at_a, none);
  }
}

// ---------------------------------------------------------------------------
// K2 on the mixed extents, P = 128 * N2 with N2 = 2^c m, m odd > 1 (3 <=
// N2 <= 63): the factored row kernel with a mixed-radix stage A. It
// computes what y_dft_kernel computes, and so replaces the same TPU
// function, tpu_qg/ops/pallas_fft.py PlanarFFT2._call_y (:1100), on the
// extents 384, 640, 768, ..., 2432, ..., 8064.
//
// Bound: device-memory bandwidth, one read and one write of the field
// (2 x 47.3 MB at (2, 2432, 2432): 0.0282 ms at 3.35 TB/s; 0.0113 at
// 1536^2, 0.0451 at 3072^2, 0.180 at 6144^2). y_dft_kernel joins the m
// radix-2 sub-transforms of a row with an m-point DFT per output element
// (mixed_fwd: m complex MACs, m reads of each plane and of the P-entry
// table, 19 at 2432; the inverse the same over a second row buffer), and
// loads, transforms and gathers one after another in a block per row.
//
// The design is y_dft_factored_kernel's (N1 = 128, slot k2 N1 + k1 holding
// frequency k2 + N2 k1, the same p-row layout, stage B and sweeps); only
// stage A, the N2-point DFT along n2, changes. It runs as a mixed-radix
// Sande-Tukey sweep over the pass plan r_0 r_1 ... (dft_kernels.
// y_dft_mixed_plan: 2^c as one radix-2^c register pass, then 3s, 5, 7,
// and at most one prime p >= 11, last), so each element pays about the
// sum of N2's prime factors, as tpu_qg's _chunk_dft does:
//   pass t, span L = N2 / (r_0 ... r_t): for each column, block b and j <
//   L, the r_t values at b r_t L + j + a L (a < r_t) are transformed and
//   output k is multiplied by W_(r_t L)^(j k);
//   radix 2, 4, 8, 16: radix-2 DIF in registers on constant weights;
//   radix 3, 5, 7: the paired butterfly (x_j + x_(r-j), x_j - x_(r-j)) on
//   constant weights; a prime p >= 11: the same paired form read from
//   shared memory, each thread taking up to kPrimeOutputs output pairs of
//   one column and reading the weights W_p^(ik) from a (p-1)/2 x (p+1)/2
//   table built once a block (a warp's lanes share k: a broadcast), with a
//   barrier between its reads and its in-place writes.
// After stage A p-row p holds k2 = rho(p), the digit reversal of the plan
// (rho = bitrev when every radix is 2), which both sweeps read from a
// table in shared memory; the last pass multiplies by W_P^(n1 k2) from
// the thi/tlo split (P / 64 = 2 N2 is whole). The inverse is the mirror
// image: the load sweep by rho, the 128-point inverse DIT times
// conj(W_P^(n1 k2)), then the passes in reverse order as DIT passes
// (conj(W) on the inputs, the inverse butterfly), the last writing x / P to
// device memory (1/P a float32 product, not exact for m > 1). Where N2 is
// itself a prime >= 11, the forward loads the rows into shared memory
// first, so that the prime pass reads only shared memory. Index maps go
// through a multiply-shift division by N2 and by each span (exact for the
// small quotients here) in place of y_dft_factored_kernel's shifts.
// Shared memory: Rb N2 p-rows, the N2-, 64-, 64- and 2 N2-entry tables,
// the two N2-entry maps and the prime pass's weights
// (dft_kernels.y_dft_factored_layout), at most 74.5 KB (N2 = 61, Rb = 1):
// three blocks an SM. dft_kernels.y_dft_factored_launched takes Rb N2 >= 32
// (the bank argument above needs 16; 32 was the fastest layout measured).
// ---------------------------------------------------------------------------

// cos and sin of 2 pi k / R for the register radices, 0 <= k <= R / 2
// (R = 16 serves 2, 4 and 8): literals, so that a butterfly unrolled over
// compile-time k multiplies by constants.
__host__ __device__ constexpr float rad_cos(int R, int k) {
  return R == 3   ? (k == 0 ? 1.0f : -0.5f)
         : R == 5 ? (k == 0 ? 1.0f : k == 1 ? 0.309016994f : -0.809016994f)
         : R == 7 ? (k == 0   ? 1.0f
                     : k == 1 ? 0.623489802f
                     : k == 2 ? -0.222520934f
                              : -0.900968868f)
                  : (k == 0   ? 1.0f
                     : k == 1 ? 0.923879533f
                     : k == 2 ? 0.707106781f
                     : k == 3 ? 0.382683432f
                     : k == 4 ? 0.0f
                     : k == 5 ? -0.382683432f
                     : k == 6 ? -0.707106781f
                     : k == 7 ? -0.923879533f
                              : -1.0f);
}
__host__ __device__ constexpr float rad_sin(int R, int k) {
  return R == 3   ? (k == 0 ? 0.0f : 0.866025404f)
         : R == 5 ? (k == 0 ? 0.0f : k == 1 ? 0.951056516f : 0.587785252f)
         : R == 7 ? (k == 0   ? 0.0f
                     : k == 1 ? 0.781831482f
                     : k == 2 ? 0.974927912f
                              : 0.433883739f)
                  : (k == 0 || k == 8 ? 0.0f
                     : k == 1 || k == 7 ? 0.382683432f
                     : k == 2 || k == 6 ? 0.707106781f
                     : k == 3 || k == 5 ? 0.923879533f
                                        : 1.0f);
}

__host__ __device__ constexpr int bitrev_c(int v, int bits) {
  return bits == 0 ? 0 : ((v & 1) << (bits - 1)) | bitrev_c(v >> 1, bits - 1);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

// In-place R-point DFT (R = 2, 4, 8, 16; inverse: conjugate weights,
// unscaled) of x in registers, natural order in and out: radix-2 DIF on
// W_R^e = W_16^(e 16 / R), then the bit-reversed outputs put in order
// (register renaming).
template <int R, bool kInverse>
__device__ __forceinline__ void dft_pow2(float2 (&x)[R]) {
  constexpr int kLog = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (j & h) continue;
      const int k = j + h;
      const int e = (j & (h - 1)) * (8 / h);        // W_2h^(j mod h) = W_16^e
      const float2 d = csub(x[j], x[k]);
      x[j] = cadd(x[j], x[k]);
      if (e == 0) {
        x[k] = d;
      } else if (e == 4) {                        // times -i (inverse: +i)
        x[k] = kInverse ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
      } else {
        const float c = rad_cos(16, e);
        const float s = kInverse ? rad_sin(16, e) : -rad_sin(16, e);
        x[k] = make_float2(d.x * c - d.y * s, d.x * s + d.y * c);
      }
    }
  }
  float2 y[R];
#pragma unroll
  for (int b = 0; b < R; ++b) y[b] = x[bitrev_c(b, kLog)];
#pragma unroll
  for (int b = 0; b < R; ++b) x[b] = y[b];
}

// In-place R-point DFT (R = 3, 5, 7; inverse: conjugate weights,
// unscaled) of x in registers, in the paired form: with s_j = x_j +
// x_(R-j), d_j = x_j - x_(R-j), A_k = x_0 + sum_j cos(2 pi jk/R) s_j and
// B_k = sum_j sin(2 pi jk/R) d_j, X_k = A_k -+ i B_k and X_(R-k) = A_k +- i
// B_k (forward upper sign), so a pair of outputs costs (R-1)/2 multiplies
// of each kind.
template <int R, bool kInverse>
__device__ __forceinline__ void dft_odd(float2 (&x)[R]) {
  constexpr int H = R / 2;
  float2 s[H], d[H];
  float2 sum = x[0];
#pragma unroll
  for (int j = 1; j <= H; ++j) {
    s[j - 1] = cadd(x[j], x[R - j]);
    d[j - 1] = csub(x[j], x[R - j]);
    sum = cadd(sum, s[j - 1]);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 a = x[0], b = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 1; j <= H; ++j) {
      const int t = (j * k) % R;
      const float c = rad_cos(R, t <= H ? t : R - t);
      const float sn = t <= H ? rad_sin(R, t) : -rad_sin(R, R - t);
      a = make_float2(a.x + c * s[j - 1].x, a.y + c * s[j - 1].y);
      b = make_float2(b.x + sn * d[j - 1].x, b.y + sn * d[j - 1].y);
    }
    const float2 lo = make_float2(a.x + b.y, a.y - b.x);   // A - i B
    const float2 hi = make_float2(a.x - b.y, a.y + b.x);   // A + i B
    x[k] = kInverse ? hi : lo;
    x[R - k] = kInverse ? lo : hi;
  }
  x[0] = sum;
}

template <int R, bool kInverse>
__device__ __forceinline__ void dft_reg(float2 (&x)[R]) {
  if constexpr ((R & (R - 1)) == 0) {
    dft_pow2<R, kInverse>(x);
  } else {
    dft_odd<R, kInverse>(x);
  }
}

// Radix t of a pass plan packed one byte a radix (0: no more passes).
__host__ __device__ __forceinline__ int plan_radix(int plan, int t) {
  return (plan >> (8 * t)) & 255;
}
__host__ __device__ __forceinline__ bool reg_radix(int r) {
  return r == 2 || r == 3 || r == 4 || r == 5 || r == 7 || r == 8 || r == 16;
}
// The prime >= 11 of N2 <= 63 (what is left after 2, 3, 5 and 7), or 0.
__host__ __device__ __forceinline__ int y_mixed_prime(int n2) {
  const int small[4] = {2, 3, 5, 7};
  for (int t = 0; t < 4; ++t)
    while (n2 % small[t] == 0) n2 /= small[t];
  return n2 > 1 ? n2 : 0;
}
// x / d for 0 <= x < 65536 / d: (x * div_magic(d)) >> 16.
__host__ __device__ __forceinline__ int div_magic(int d) {
  return (65536 + d - 1) / d;
}

// True iff the radices of a packed plan multiply out to n, each a register
// radix or n's prime (dft_kernels.y_dft_mixed_plan): the launchers' check.
inline bool plan_fits(int plan, int n) {
  int prod = 1;
  for (int t = 0; t < 4 && plan_radix(plan, t); ++t) {
    const int r = plan_radix(plan, t);
    if (!reg_radix(r) && r != y_mixed_prime(n)) return false;
    prod *= r;
  }
  return prod == n;
}

// One register pass of radix R of the mixed-radix sweep over 2^lognc
// columns of length n, span L (see y_dft_mixed_kernel): thread t takes
// column t mod 2^lognc and butterfly g = t / 2^lognc, block g / L, j = g
// mod L, its R values read through in(pos, col) and written through
// out(pos, col, value). Forward (DIF): the DFT, then output k times W_(R
// L)^(j k) = tw[j k n / (R L)] (tw: W_n^e, e < n). Inverse (DIT): input k
// times its conjugate, then the inverse DFT. The 2^c factor runs here, not
// in il_pass: il_pass addresses a group as base + j 2^lo with shifts and
// takes its per-stage twiddles from a 2^(logn-1)-entry table, but the 2^c
// pass's span L is the odd cofactor of n and its twiddles are W_(R L)^(j k)
// on the n-entry table, applied once after the whole R-point DFT.
template <int R, bool kInverse, int kThreads, class In, class Out>
__device__ __forceinline__ void radix_pass(int lognc, int n, int L,
                                           const float2* tw, In in, Out out) {
  const int NR = R * L, stride = n / NR, magic = div_magic(L);
  const int count = (n / R) << lognc;
  for (int t = threadIdx.x; t < count; t += kThreads) {
    const int g = t >> lognc, col = t & ((1 << lognc) - 1);
    const int blk = (g * magic) >> 16, j = g - blk * L;
    const int base = blk * NR + j, js = j * stride;
    float2 x[R];
    if constexpr (!kInverse) {
#pragma unroll
      for (int a = 0; a < R; ++a) x[a] = in(base + a * L, col);
      dft_reg<R, false>(x);
#pragma unroll
      for (int k = 0; k < R; ++k)
        out(base + k * L, col,
            k && js ? cmul(x[k], tw[js * k], false) : x[k]);
    } else {
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const float2 v = in(base + k * L, col);
        x[k] = k && js ? cmul(v, tw[js * k], true) : v;
      }
      dft_reg<R, true>(x);
#pragma unroll
      for (int a = 0; a < R; ++a) out(base + a * L, col, x[a]);
    }
  }
}

// Output pairs of a prime pass a thread keeps in registers (4 floats each):
// 4 leaves the kernel fewer spills than 8, and ran faster at 2432^2 and
// 7808^2 on an H100.
constexpr int kPrimeOutputs = 4;

// The prime pass (p >= 11) of the mixed-radix sweep: radix_pass's function,
// in dft_odd's paired form with the weights W_p^(ik) read from the table
// wp[(i - 1) (p + 1) / 2 + k], 1 <= i, k <= (p - 1) / 2 (k = 0 too), built
// once a block. The (p + 1) / 2 output pairs k, p - k of a column's
// butterfly are cut into nch chunks (a power of two) of at most
// kPrimeOutputs; a round takes kThreads / nch butterflies, thread t chunk t
// / (kThreads / nch), and each thread reads its butterfly's p inputs
// through rd (shared memory), then, after a barrier that every thread
// reaches, writes its outputs through out, so that a pass may run in
// place: distinct butterflies touch distinct elements.
template <bool kInverse, int kThreads, class Rd, class Out>
__device__ __forceinline__ void prime_pass(int p, int lognc, int n, int L,
                                           const float2* tw, const float2* wp,
                                           Rd rd, Out out) {
  constexpr int T = kPrimeOutputs;
  const int NR = p * L, stride = n / NR, magic = div_magic(L);
  const int half = (p + 1) / 2;
  int nch = 1;
  while (nch * T < half) nch *= 2;
  const int tc = (half + nch - 1) / nch;
  const int per = kThreads / nch;
  const int ch = threadIdx.x / per, ul = threadIdx.x - ch * per;
  const int k0 = ch * tc, nk = min(tc, half - k0);
  const int units = (n / p) << lognc;
  for (int u0 = 0; u0 < units; u0 += per) {
    const int u = u0 + ul;
    const bool active = u < units;
    const int g = u >> lognc, col = u & ((1 << lognc) - 1);
    const int blk = (g * magic) >> 16, j = g - blk * L;
    const int base = blk * NR + j, js = j * stride;
    float2 x0 = make_float2(0.0f, 0.0f);
    float2 A[T], B[T];
#pragma unroll
    for (int v = 0; v < T; ++v) A[v] = B[v] = make_float2(0.0f, 0.0f);
    if (active) {
      x0 = rd(base, col);
      for (int i = 1; i < half; ++i) {
        float2 xa = rd(base + i * L, col), xb = rd(base + (p - i) * L, col);
        if (kInverse && js) {
          xa = cmul(xa, tw[js * i], true);
          xb = cmul(xb, tw[js * (p - i)], true);
        }
        const float2 s = cadd(xa, xb), d = csub(xa, xb);
        const float2* wrow = wp + (i - 1) * half + k0;
#pragma unroll
        for (int v = 0; v < T; ++v) {
          if (v < nk) {
            const float2 w = wrow[v];        // (cos, -sin)(2 pi i k / p)
            A[v] = make_float2(A[v].x + w.x * s.x, A[v].y + w.x * s.y);
            B[v] = make_float2(B[v].x + w.y * d.x, B[v].y + w.y * d.y);
          }
        }
      }
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int v = 0; v < T; ++v) {
      if (v >= nk) continue;
      const int k = k0 + v;
      const float2 a = cadd(x0, A[v]), b = B[v];   // b = -sum sin d
      const float2 lo = make_float2(a.x - b.y, a.y + b.x);   // A + i b
      const float2 hi = make_float2(a.x + b.y, a.y - b.x);   // A - i b
      float2 xk = kInverse ? hi : lo, xm = kInverse ? lo : hi;
      if (!kInverse && js) {
        xk = cmul(xk, tw[js * k], false);
        xm = cmul(xm, tw[js * (p - k)], false);
      }
      out(base + k * L, col, xk);
      if (k) out(base + (p - k) * L, col, xm);
    }
  }
}

template <bool kInverse, int kThreads, class In, class Out>
__device__ __forceinline__ void mixed_pass(int r, int lognc, int n, int L,
                                           const float2* tw, In in, Out out) {
  switch (r) {
    case 2: return radix_pass<2, kInverse, kThreads>(lognc, n, L, tw, in, out);
    case 4: return radix_pass<4, kInverse, kThreads>(lognc, n, L, tw, in, out);
    case 8: return radix_pass<8, kInverse, kThreads>(lognc, n, L, tw, in, out);
    case 16: return radix_pass<16, kInverse, kThreads>(lognc, n, L, tw, in, out);
    case 3: return radix_pass<3, kInverse, kThreads>(lognc, n, L, tw, in, out);
    case 5: return radix_pass<5, kInverse, kThreads>(lognc, n, L, tw, in, out);
    default: return radix_pass<7, kInverse, kThreads>(lognc, n, L, tw, in, out);
  }
}

// The mixed-radix sweep over 2^lognc columns of length n (the plan's
// product): forward the passes in plan order (DIF), inverse in reverse
// order (DIT), wp the prime pass's weights. As il_fft_at: the first pass
// reads through in, the last writes through out, and between passes
// element (pos, col) sits at at(pos, col) with a barrier after each pass
// but the last; after_first() runs after the first pass. A prime pass
// reads at() even when it comes first (the caller puts the data there).
template <int kThreads, bool kInverse, class In, class Out, class At,
          class Mid>
__device__ void mixed_fft_at(int lognc, int n, int plan, const float2* tw,
                             const float2* wp, In in, Out out, At at,
                             Mid after_first) {
  auto rd = [=](int pos, int col) { return *at(pos, col); };
  auto wr = [=](int pos, int col, float2 v) { *at(pos, col) = v; };
  int npass = 0;
  while (npass < 4 && plan_radix(plan, npass)) ++npass;
  for (int i = 0; i < npass; ++i) {
    const int t = kInverse ? npass - 1 - i : i;
    int L = n;
    for (int u = 0; u <= t; ++u) L /= plan_radix(plan, u);
    const int r = plan_radix(plan, t);
    const bool first = i == 0, last = i == npass - 1;
    if (!reg_radix(r)) {
      if (last) {
        prime_pass<kInverse, kThreads>(r, lognc, n, L, tw, wp, rd, out);
      } else {
        prime_pass<kInverse, kThreads>(r, lognc, n, L, tw, wp, rd, wr);
      }
    } else if (first && last) {
      mixed_pass<kInverse, kThreads>(r, lognc, n, L, tw, in, out);
    } else if (first) {
      mixed_pass<kInverse, kThreads>(r, lognc, n, L, tw, in, wr);
    } else if (last) {
      mixed_pass<kInverse, kThreads>(r, lognc, n, L, tw, rd, out);
    } else {
      mixed_pass<kInverse, kThreads>(r, lognc, n, L, tw, rd, wr);
    }
    if (first) after_first();
    if (!last) __syncthreads();
  }
}

// The digit reversal of a pass plan over n points: after the plan's DIF
// passes position p = sum_t b_t L_t (L_t = n / (r_0 ... r_t), b_t < r_t)
// holds k = sum_t b_t r_0 ... r_(t-1) (bitrev when every radix is 2).
__device__ __forceinline__ int plan_rho(int plan, int n, int p) {
  int rem = p, k = 0, mul = 1, span = n;
  for (int t = 0; t < 4 && plan_radix(plan, t); ++t) {
    const int r = plan_radix(plan, t);
    span /= r;
    const int b = rem / span;
    rem -= b * span;
    k += b * mul;
    mul *= r;
  }
  return k;
}

// The mixed kernel's tables in shared memory, past the Rb N2 p-rows at S:
// W_N2^k (twa, k < N2), W_128^k (twb), W_P^j (tlo), W_P^(64 j) (thi), the
// maps p-row -> k2 (rho) and k2 -> p-row (pos) and the prime pass's
// weights (wp), filled by the block's kThreads threads (the caller puts a
// block barrier before their first use).
template <int kThreads>
__device__ __forceinline__ void y_mixed_tables(float2* S, int n2, int logrb,
                                               int plan, const float2* wm) {
  const int P = n2 << 7, rb = 1 << logrb;
  float2* twa = S + rb * n2 * kYRowStride;           // W_N2^k, k < N2
  float2* twb = twa + n2;                            // W_128^k, k < 64
  float2* tlo = twb + 64;                            // W_P^j, j < 64
  float2* thi = tlo + 64;                            // W_P^(64 j), j < P / 64
  int* rho = reinterpret_cast<int*>(thi + 2 * n2);   // p-row -> k2
  int* pos = rho + n2;                               // k2 -> p-row
  // The prime pass's weights W_p^(ik), i = 1 .. (p - 1) / 2, k = 0 ..
  // (p - 1) / 2, from the P-entry table at stride P / p.
  float2* wp = reinterpret_cast<float2*>(pos + n2);
  const int prime = y_mixed_prime(n2), half = (prime + 1) / 2;
  for (int e = threadIdx.x; e < (half - 1) * half; e += kThreads) {
    const int i = e / half + 1, k = e - (i - 1) * half;
    wp[e] = wm[(i * k % prime) * (P / prime)];
  }
  for (int k = threadIdx.x; k < n2; k += kThreads) {
    twa[k] = wm[k << 7];
    const int k2 = plan_rho(plan, n2, k);
    rho[k] = k2;
    pos[k2] = k;
  }
  for (int k = threadIdx.x; k < 64; k += kThreads) {
    twb[k] = wm[k * n2];
    tlo[k] = wm[k];
  }
  for (int k = threadIdx.x; k < 2 * n2; k += kThreads) thi[k] = wm[k << 6];
}

// The mixed kernel on its row group `group` (its tables, y_mixed_tables, in
// place past the p-rows at S), as y_factored_block's group.
template <int kThreads, bool kInverse, bool kL2 = false>
__device__ __forceinline__ void y_mixed_group(const float* in, float* out,
                                              int rows, int n2, int logrb,
                                              int plan, float2* S,
                                              unsigned group) {
  const int P = n2 << 7, rb = 1 << logrb;
  const float2* twa = S + rb * n2 * kYRowStride;
  const float2* twb = twa + n2;
  const float2* tlo = twb + 64;
  const float2* thi = tlo + 64;
  const int* rho = reinterpret_cast<const int*>(thi + 2 * n2);
  const int* pos = rho + n2;
  const float2* wp = reinterpret_cast<const float2*>(pos + n2);
  const size_t plane = (size_t)rows * P;
  const int row0 = group << logrb;
  const int nrow = min(rb, rows - row0);
  const size_t first = (size_t)row0 * P;
  const int magic = div_magic(n2);        // c / N2 for c < Rb N2
  auto ld = [=](int e) {                   // element e of the block's rows
    return make_float2(ldg<kL2>(in + first + e),
                       ldg<kL2>(in + first + e + plane));
  };
  auto twiddle = [=](int n1, int k2) {
    const int j = n1 * k2;
    return cmul(thi[j >> 6], tlo[j & 63], false);
  };
  // As y_dft_factored_kernel's, with row r's p-rows at r N2.
  auto at_a = [=](int p, int col) {
    return S + y_fac_at((col >> 7) * n2 + p, col & 127);
  };
  auto at_b = [=](int q, int col) { return S + y_fac_at(col, q); };
  auto at_slot = [=](int i) {
    const int c = i >> 7, r = (c * magic) >> 16;
    return S + y_fac_at(r * n2 + pos[c - r * n2], bitrev(i & 127, 7));
  };
  auto at_elem = [=](int i) {              // element n2 N1 + n1 of row r
    const int c = i >> 7, r = (c * magic) >> 16;
    return at_a(c - r * n2, (r << 7) + (i & 127));
  };
  // Loads the block's rows to at(i), kBatch loads a thread in flight.
  auto load_rows = [=](auto at) {
    const int count = nrow * P;
    for (int i0 = threadIdx.x; i0 < count; i0 += kBatch * kThreads) {
      float2 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = ld(min(i0 + u * kThreads, count - 1));
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (i0 + u * kThreads < count) *at(i0 + u * kThreads) = v[u];
      }
    }
    __syncthreads();
  };
  auto rd_b = [=](int q, int col) { return *at_b(q, col); };
  auto none = [] {};
  const int lognc_a = logrb + 7;
  const NCols cols_b{rb * n2};

  if constexpr (!kInverse) {
    if (!reg_radix(plan_radix(plan, 0))) load_rows(at_elem);
    mixed_fft_at<kThreads, false>(lognc_a, n2, plan, twa, wp,
        [=](int n, int col) {     // a row past the field reads the last
          return ld(min(col >> 7, nrow - 1) * P + (n << 7) + (col & 127));
        },
        [=](int p, int col, float2 v) {
          *at_a(p, col) = cmul(v, twiddle(col & 127, rho[p]), false);
        }, at_a, none);
    __syncthreads();
    il_fft_at<kThreads, false>(cols_b, 7, twb, rd_b,
        [=](int q, int col, float2 v) { *at_b(q, col) = v; }, at_b, none);
    __syncthreads();
    for (int i = threadIdx.x; i < nrow * P; i += kThreads) {
      const float2 v = *at_slot(i);
      out[first + i] = v.x;
      out[first + i + plane] = v.y;
    }
  } else {
    load_rows(at_slot);
    il_fft_at<kThreads, true>(cols_b, 7, twb, rd_b,
        [=](int q, int col, float2 v) {
          const int p = col - ((col * magic) >> 16) * n2;
          *at_b(q, col) = cmul(v, twiddle(q, rho[p]), true);
        }, at_b, none);
    __syncthreads();
    const float scale = 1.0f / static_cast<float>(P);
    mixed_fft_at<kThreads, true>(lognc_a, n2, plan, twa, wp,
        [=](int p, int col) { return *at_a(p, col); },
        [=](int n, int col, float2 v) {
          if ((col >> 7) >= nrow) return;
          const size_t off = first + (size_t)(col >> 7) * P + (n << 7) +
                             (col & 127);
          out[off] = v.x * scale;
          out[off + plane] = v.y * scale;
        }, at_a, none);
  }
}

// ---------------------------------------------------------------------------
// K4 on M = 128 * N2 with N2 >= G: the one-pass cluster kernel, two instances
// of one body (x_cluster_tile): x_dft_cluster_kernel for N2 = 2^a and
// x_dft_cluster_mixed_kernel for N2 not a power of two (N2 <= 63). It
// computes what x_dft_kernel computes, and so replaces the same TPU
// functions, tpu_qg/ops/pallas_fft.py PlanarFFT2._call_x (:1153) and
// _call_x_stream(z, inverse) with no consts (:1122); x_dft_kernel keeps
// M < 128 * G.
//
// Bound: device-memory bandwidth, one read and one write of the field (2 x
// 537 MB at 8192^2: 0.321 ms at 3.35 TB/s; 2 x 37.7 MB at 3072^2, 0.045
// ms). x_dft_kernel reaches 11% of it at 8192^2: a block holds whole
// columns of M values (64 KB each at M = 8192), so at most C = 2 fit and a
// warp reads and writes runs of 8 bytes a row, a quarter of a 32-byte
// sector; on a mixed extent it also joins its m radix-2 sub-transforms with
// an m-point DFT per output element. A tile wide enough to fill sectors (Cw
// >= 8 columns) of whole columns would need 512 KB; a cluster of G blocks on
// neighbouring SMs holds it, each block 1/G of it, and the blocks trade
// their halves of the transform through distributed shared memory (the
// SM-to-SM network, not device memory).
//
// The transform is factored as tpu_qg/ops/matmul_fft.py FactoredFFT (N1 =
// 128, N2 = M / 128; x = N1 n2 + n1, permuted slot k2 N1 + k1 holding
// frequency k2 + N2 k1):
//   X[k2 N1 + k1] = sum_n1 W_N1^(n1 k1) W_M^(n1 k2) sum_n2 W_N2^(n2 k2) x[N1 n2 + n1]
// so the permuted spectrum comes out of stage B as whole rows, no gather.
// A cluster takes a tile of Cw adjacent y slots (all M rows of them) at a
// time; block r:
//   forward  1. loads rows N1 n2 + n1 for its n1 in [r L1, (r+1) L1), L1 =
//               N1 / G: runs of Cw floats, natural n2 at row n2 of buffer A;
//            2. stage A: N2-point DIF along n2 (row p then holds k2 =
//               rho(p), below);
//            3. cluster barrier; pulls its p-rows [s_r, s_(r+1)) of every
//               block's A, times W_M^(n1 k2), into buffer B (row n1,
//               natural): block r owns k2 = rho(p) for its p, so it reads
//               the same rows of every peer's A;
//            4. stage B: 128-point DIF along n1 (row p' holds k1 =
//               bitrev(p')), then writes rows k2 N1 + bitrev(p');
//   inverse  the mirror image: loads rows k2 N1 + k1 of its k2 into B at row
//            bitrev(k1), 128-point inverse DIT, cluster barrier, pulls its
//            n1 rows of every block's B times conj(W_M^(n1 k2)) into A at the
//            position p of k2 (from the block that owns p), N2-point inverse
//            DIT, scales 1/M and writes rows N1 n2 + n1.
// The reordering of each DIF output is absorbed into the indices of the
// pull and of the store, never a reorder pass. Buffers hold float2, element
// (row, column) at row * columns + column, and a warp's loads, pulls and
// butterfly passes touch consecutive words. The inter-stage twiddle comes
// from the M-entry float32 table of W_M^j built in float64 on the host (n1
// k2 < M), as do the stage tables. The first pass of a stage reads straight
// from device memory or the peers' buffers, the last pass of stage 2 writes
// device memory, so a stage of two passes makes one round trip through
// shared memory and a thread has up to 16 loads in flight.
//
// The power-of-two instance: stages of radix-2 passes of up to 4 stages in
// registers (il_fft, group_pass's butterflies, tables of N2/2 and 64
// entries); rho = bitrev; block r owns p-rows [r L2, (r+1) L2), L2 = N2 / G,
// all index maps shifts.
// The mixed instance (N2 = 2^c m, m odd > 1): stage A is y_dft_mixed_kernel's
// sweep over the plan dft_kernels.y_dft_mixed_plan(N2) (mixed_fft_at:
// radix 2^c, 3, 5 and 7 register passes and at most one prime pass, its
// weights from a table built once a block), so p-row p holds k2 = rho(p),
// the plan's digit reversal (plan_rho, a table in shared memory). N2 is a
// multiple of G only for a few N2 (24, 40, 48 and 56 of G = 8; N2 is prime
// for 23, 29, 31, ...), so stage B's split rounds: block r owns p-rows
// [s_r, s_(r+1)), s_r = floor(r N2 / G), floor(N2 / G) or ceil(N2 / G) of
// them (at least one, N2 >= G); it runs the 128-point pass over that count
// of Cw columns (NCols) and keeps buffer B at a row stride of ceil(N2 / G)
// Cw. The inverse's pull finds p-row p's block and local row in an N2-entry
// map. A pass's barriers depend on its length alone, never on its column
// count, so blocks that own different counts reach the same barriers. A
// prime pass reads only shared memory: where the plan is one prime (N2 a
// prime), the forward loads the block's rows into A before it; where the
// plan ends in a prime (its DIT order runs that pass first), the inverse
// pulls its rows from the peers into A first. 1/M is a float32 product,
// not exact for m > 1.
//
// Cluster barriers: one after stage 1 (the peers' buffers are ready), one
// split around stage 2 (arrive after the pull, wait before exit), so no
// block leaves while a peer may still read its buffer. stage_a: writes the
// twiddled intermediate Y[k2, n1] (forward) or conj(W_M^(n1 k2)) sum_k1
// W_N1^(-n1 k1) X[k2 N1 + k1] (inverse, unscaled) at row k2 N1 + n1 and
// stops, so that the first half can be checked alone
// (dft_kernels.x_dft_stage_a_plain). Shared memory: A (M Cw / G float2), B
// (128 ceil(N2 / G) Cw float2) and the tables, 64.75 KB at M = 8192, G =
// 16, Cw = 8, 48.9 KB at M = 3072, G = 8, Cw = 8
// (dft_kernels.x_dft_cluster_layout). The grid is G ceil(P / Cw) blocks.
//
// Measured (chip_smoke.py, PERF.md): stage A alone takes most of the
// power-of-two kernel's time, against a plain copy of the field at 0.36 ms;
// nor did persistent clusters loading the next tile by cp.async beside the
// transforms (tried) speed it up: the narrow column tiles' device-memory
// access, 32-byte runs over all M rows, is what holds it. The mixed
// instance runs at 20-32% of its bound, 1.6-5.1 times faster than
// x_dft_kernel at M = 2560 ... 7808 (chip_smoke.py's k4_mixed).
// ---------------------------------------------------------------------------

// Copies count elements into buf, element i read as ld(i >> lognc, i mod
// 2^lognc) (row and column of 2^lognc columns), kBatch reads a thread in
// flight: the rows that a prime pass, which reads only shared memory,
// finds there when it comes first.
template <class Ld>
__device__ __forceinline__ void fill_rows(float2* buf, int count, int lognc,
                                          Ld ld) {
  for (int i0 = threadIdx.x; i0 < count; i0 += kBatch * kClusterThreads) {
    float2 v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(i0 + u * kClusterThreads, count - 1);
      v[u] = ld(i >> lognc, i & ((1 << lognc) - 1));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (i0 + u * kClusterThreads < count) buf[i0 + u * kClusterThreads] = v[u];
    }
  }
}

// The cluster kernels' body (see above): kMixed selects the mixed instance,
// which takes N2 = n2m and the plan; the power-of-two one takes N2 =
// 2^logn2.
template <bool kMixed>
__device__ __forceinline__ void x_cluster_tile(
    const float* __restrict__ in, float* __restrict__ out, int P, int logn2,
    int n2m, int logg, int logcw, int inverse, int stage_a, int plan,
    const float2* __restrict__ wm) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  const int r = static_cast<int>(cg::this_cluster().block_rank());
  const int n2 = kMixed ? n2m : 1 << logn2, cw = 1 << logcw, M = n2 << 7;
  const int logl1 = 7 - logg, logl2 = kMixed ? 0 : logn2 - logg;
  const int logna = logl1 + logcw, lognb = logl2 + logcw;
  const int na = 1 << logna, nb = 1 << lognb;
  // Stage B: block r's first p-row, its column count (p-rows times Cw) and
  // buffer B's row stride.
  const int s0 = kMixed ? (r * n2) >> logg : r << logl2;
  const int cnt = kMixed ? ((((r + 1) * n2) >> logg) - s0) << logcw : nb;
  const int bs = kMixed ? ((n2 + (1 << logg) - 1) >> logg) << logcw : nb;
  float2* A = reinterpret_cast<float2*>(smem);      // n2 rows of na columns
  float2* B = A + (n2 << logna);                    // 128 rows of bs columns
  // W_N2^k, k < N2 / 2 (mixed: k < N2); W_128^k, k < 64.
  float2* twa = B + (kMixed ? 128 * bs : 128 << lognb);
  float2* twb = twa + (kMixed ? n2 : n2 / 2);
  // Mixed: the prime pass's weights W_p^(ik), i = 1 .. (p - 1) / 2, k = 0
  // .. (p - 1) / 2; rho; p-row -> (block << 8) | its row in the block.
  const int prime = kMixed ? y_mixed_prime(n2) : 0, half = (prime + 1) / 2;
  float2* wp = twb + 64;
  int* rho = reinterpret_cast<int*>(wp + (half - 1) * half);
  int* own = rho + n2;
  if constexpr (kMixed) {
    for (int e = threadIdx.x; e < (half - 1) * half; e += kClusterThreads) {
      const int i = e / half + 1, k = e - (i - 1) * half;
      wp[e] = wm[(i * k % prime) * (M / prime)];
    }
    for (int k = threadIdx.x; k < n2; k += kClusterThreads) {
      twa[k] = wm[k << 7];
      rho[k] = plan_rho(plan, n2, k);
      const int b = (((k + 1) << logg) - 1) / n2;  // the b with s_b <= k < s_(b+1)
      own[k] = (b << 8) | (k - ((b * n2) >> logg));
    }
  } else {
    for (int k = threadIdx.x; k < n2 / 2; k += kClusterThreads) twa[k] = wm[k << 7];
  }
  for (int k = threadIdx.x; k < 64; k += kClusterThreads)
    twb[k] = wm[kMixed ? k * n2 : k << logn2];
  __syncthreads();
  const size_t plane = (size_t)M * P;
  const int c0 = (blockIdx.x >> logg) << logcw;     // the cluster's y slots
  const int ncol = min(cw, P - c0);                 // ragged last tile
  const int r1 = r << logl1;                        // first n1
  // Element (row, y slot c0 + col) of a planar field: a zero (read) or
  // nothing (write) for a slot past P.
  auto get = [=](int row, int col) {
    const size_t off = (size_t)row * P + c0 + min(col, ncol - 1);
    return col < ncol ? make_float2(__ldg(in + off), __ldg(in + off + plane))
                      : make_float2(0.f, 0.f);
  };
  auto put = [=](int row, int col, float2 v) {
    if (col >= ncol) return;
    const size_t off = (size_t)row * P + c0 + col;
    out[off] = v.x;
    out[off + plane] = v.y;
  };
  auto none = [] {};
  auto arrive = [] { asm volatile("barrier.cluster.arrive.aligned;" ::: "memory"); };
  // k2 of p-row p, and the block that owns p-row p in stage B and its row
  // there.
  auto k2_of = [=](int p) { return kMixed ? rho[p] : bitrev(p, logn2); };
  auto owner = [=](int p) { return kMixed ? own[p] >> 8 : p >> logl2; };
  auto local = [=](int p) {
    return kMixed ? own[p] & 255 : p & ((1 << logl2) - 1);
  };
  auto brow = [=](int row) { return kMixed ? row * bs : row << lognb; };
  const auto bcols = [=] {
    if constexpr (kMixed) {
      return NCols{cnt};
    } else {
      return lognb;
    }
  }();
  // Column a of A is (n1 - r1) cw + col, column b of B is (p - s0) cw + col.
  auto wr_a = [=](int row, int a, float2 v) { A[(row << logna) + a] = v; };
  auto wr_b = [=](int row, int b, float2 v) { B[brow(row) + b] = v; };
  auto at_a = [=](int row, int a) { return A + (row << logna) + a; };
  // The block's rows into A where a prime pass comes first.
  auto fill_a = [=](auto ld) { fill_rows(A, n2 << logna, logna, ld); };

  if (!inverse) {
    // Stage A: A row n2 <- x[N1 n2 + n1]; DIF leaves k2 = rho(row).
    auto ld_a = [=](int row, int a) {
      return get((row << 7) + r1 + (a >> logcw), a & (cw - 1));
    };
    if constexpr (kMixed) {
      if (!reg_radix(plan_radix(plan, 0))) {
        fill_a(ld_a);
        __syncthreads();
      }
      mixed_fft_at<kClusterThreads, false>(logna, n2, plan, twa, wp, ld_a,
                                           wr_a, at_a, none);
    } else {
      il_fft<false>(A, logna, na, logn2, twa, ld_a, wr_a, none);
    }
    if (stage_a) {
      __syncthreads();
      for (int i = threadIdx.x; i < n2 << logna; i += kClusterThreads) {
        const int a = i & (na - 1);
        const int n1 = r1 + (a >> logcw), k2 = k2_of(i >> logna);
        put((k2 << 7) + n1, a & (cw - 1), cmul(A[i], wm[n1 * k2], false));
      }
      return;
    }
    cg::this_cluster().sync();
    // Stage B: row n1 <- block n1 / L1's A at row p (k2 = rho(p)), times
    // W_M^(n1 k2); DIF, then row p' (k1 = bitrev(p')) -> slot row
    // k2 N1 + k1.
    il_fft<false>(B, bcols, bs, 7, twb,
        [=](int n1, int b) {
          const int p = s0 + (b >> logcw);
          const float2 v = cg::this_cluster().map_shared_rank(
              static_cast<const float2*>(A), n1 >> logl1)[
                  (p << logna) + ((n1 & ((1 << logl1) - 1)) << logcw) +
                  (b & (cw - 1))];
          return cmul(v, __ldg(wm + n1 * k2_of(p)), false);
        },
        [=](int pp, int b, float2 v) {
          put((k2_of(s0 + (b >> logcw)) << 7) + bitrev(pp, 7), b & (cw - 1),
              v);
        }, arrive);
  } else {
    // Stage B^-1: B row p' <- X[k2 N1 + k1], k1 = bitrev(p'); DIT leaves
    // n1 = row.
    il_fft<true>(B, bcols, bs, 7, twb,
        [=](int pp, int b) {
          return get((k2_of(s0 + (b >> logcw)) << 7) + bitrev(pp, 7),
                     b & (cw - 1));
        }, wr_b, none);
    if (stage_a) {
      __syncthreads();
      if constexpr (kMixed) {
        for (int e = threadIdx.x; e < 128 * cnt; e += kClusterThreads) {
          const int n1 = e / cnt, b = e - n1 * cnt;
          const int k2 = k2_of(s0 + (b >> logcw));
          put((k2 << 7) + n1, b & (cw - 1),
              cmul(B[brow(n1) + b], wm[n1 * k2], true));
        }
      } else {
        for (int e = threadIdx.x; e < 128 << lognb; e += kClusterThreads) {
          const int n1 = e >> lognb, b = e & (nb - 1);
          const int k2 = bitrev(s0 + (b >> logcw), logn2);
          put((k2 << 7) + n1, b & (cw - 1), cmul(B[e], wm[n1 * k2], true));
        }
      }
      return;
    }
    cg::this_cluster().sync();
    // Stage A^-1: row p <- its owner's B at row n1, times conj(W_M^(n1
    // k2)); DIT, then row n2 -> x row N1 n2 + n1, scaled 1/M.
    const float scale = 1.0f / static_cast<float>(M);   // exact when M = 2^k
    auto pull = [=](int p, int a) {
      const int n1 = r1 + (a >> logcw);
      const float2 v = cg::this_cluster().map_shared_rank(
          static_cast<const float2*>(B), owner(p))[
              brow(n1) + (local(p) << logcw) + (a & (cw - 1))];
      return cmul(v, __ldg(wm + n1 * k2_of(p)), true);
    };
    auto st = [=](int row, int a, float2 v) {
      put((row << 7) + r1 + (a >> logcw), a & (cw - 1),
          make_float2(v.x * scale, v.y * scale));
    };
    if constexpr (kMixed) {
      int last = 0;
      for (int t = 0; t < 4 && plan_radix(plan, t); ++t)
        last = plan_radix(plan, t);
      if (!reg_radix(last)) {
        fill_a(pull);
        arrive();
        __syncthreads();
        mixed_fft_at<kClusterThreads, true>(logna, n2, plan, twa, wp, pull,
                                            st, at_a, none);
      } else {
        mixed_fft_at<kClusterThreads, true>(logna, n2, plan, twa, wp, pull,
                                            st, at_a, arrive);
      }
    } else {
      il_fft<true>(A, logna, na, logn2, twa, pull, st, arrive);
    }
  }
  // No block leaves while a peer may still read its buffer.
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// ---------------------------------------------------------------------------
// K5 on M = 128 * N2 with ceil(N2 / 2) >= G: the one-pass cluster kernels,
// x_symbols_cluster_kernel for N2 = 2^a and x_symbols_cluster_mixed_kernel
// for the other N2 <= 63 (one body, x_symbols_tile<kMixed>). They compute
// what x_symbols_inverse_kernel computes, and so replace the same TPU
// functions, tpu_qg/ops/pallas_fft.py PlanarFFT2._call_x_symbols (:1176;
// builder _build_symbol_inv_x_kernel, :429) and _call_x_stream(Z, True,
// consts) (:1122; _build_streaming_x, :922); x_symbols_inverse_kernel keeps
// the smaller M.
//
// Bound: device-memory bandwidth, one read and one write of the field (2 x
// 537 MB at 8192^2: 0.321 ms at 3.35 TB/s). x_symbols_inverse_kernel holds
// whole columns (64 KB each at M = 8192), so one slot pair fits a block and
// a warp moves 4-byte runs a row, an eighth of a sector. This kernel is K4's
// cluster inverse (x_dft_cluster_kernel) with the symbol stage in front: a
// cluster of G blocks takes an own tile of Cw y slots and its mirror tile
// (the y-negated slots), all M rows of both, from a host-built table
// (dft_kernels.x_symbols_cluster_tiles: every unordered pair {a, sigma(a)}
// once, strip by strip, so that own tiles are Cw adjacent slots and mirror
// tiles Cw adjacent slots in reverse; strip 0's are off by one slot and
// hold the self-mirror slots 0 and 64, and its last tile is ragged, -1
// padding). Block r:
//   1. loads its L2 = N2 / G k2 rows (rows k2 N1 + k1) of both tiles straight
//      from device memory, Cw floats a row and plane a tile (32 bytes at Cw =
//      8), and applies the symbol stage, V = A W + B conj(W(-k)), on the way
//      into buffer B (k1 at row bitrev7(k1));
//   2. stage B^-1: 128-point inverse DIT along k1 (row n1 natural);
//   3. cluster barrier; stage A^-1, the own tile and then the mirror tile
//      through buffer A: pulls its n1 rows [r L1, (r+1) L1) of every peer's
//      B times conj(W_M^(n1 k2)) into A at the DIT position of k2, N2-point
//      inverse DIT, scales 1/M and stores rows N1 n2 + n1; a split cluster
//      barrier (arrive after the last pull, wait before exit), as in K4.
//      Holding both tiles in A at once (tried) needs a third more shared
//      memory, leaves one block an SM at (G, Cw) = (16, 8) at M = 8192, and
//      was the fastest layout at neither 4096 nor 8192 (PERF.md).
// The mirror row. W(-k) at permuted x slot k2 N1 + k1 sits at slot
// ((N2 - k2) mod N2) N1 + k1', k1' = 127 - k1 (k1' = (128 - k1) mod 128 for
// k2 = 0), in the mirror tile. K4 gives block r the k2 at its DIF positions
// [r L2, (r+1) L2), so the mirror row would live in another block for all r
// but two. Here block r owns the k2 = sym_k2(i) of the rows i in [r L2,
// (r+1) L2) of an ordering that lists 0, N2/2 and then each pair m, N2 - m
// side by side: a block holds every pair whole (L2 >= 2, even), each thread
// of step 1 loads one own value and its partner in the mirror tile and
// writes both results, and no value crosses the cluster before stage A^-1,
// whose pull looks the owner up through sym_row. The other way, reading the
// mirror from the peer through distributed shared memory after a cluster
// barrier, costs a barrier and a second copy of the tile. A self-mirror
// slot (own = mirror, y-frequency 0 or P/2) pairs rows within its own
// column: the thread of the lower row of each pair loads and writes both, the
// mirror column stays zero, and only the own column is stored, so each
// input value is loaded once and each output value stored once (what
// write_group does for the other kernels). The symbols are symbol_stage's:
// the same SymConsts, the cancellation-free lambda = -4/dx^2 (sin^2(pi
// kx'/M) + sin^2(pi ky'/P)), inv1 = 0 at (0, 0).
// Shared memory: B, 2 M Cw / G float2 (both tiles), A, M Cw / G, the
// N2/2- and 64-entry tables (0.75 KB at M = 8192) and the tile's 2 Cw
// slots: 96.8 KB at M = 8192, G = 16, Cw = 8, two blocks an SM
// (dft_kernels.x_symbols_cluster_layout). The symbol stage's per-column
// terms are computed once a thread; a per-block table of the rows'
// sin^2(pi kx'/M) (tried) was slower. The grid is G blocks a tile of the
// table.
//
// The mixed instance (N2 = 2^c m, m odd > 1; the 3072^2 path's N2 = 24):
// stage A^-1 is K4's mixed one, the inverse sweep over the plan
// dft_kernels.y_dft_mixed_plan(N2) (mixed_fft_at: radix 2^c, 3, 5 and 7
// register passes and at most one prime pass on a weight table built once a
// block), DIT position p holding k2 = rho(p) (plan_rho). The ordering is
// sym_k2_any's: k2 = 0, for even N2 then N2/2, then each pair m, N2 - m side
// by side (odd N2 has no N2/2). Its units, the rows {0, N2/2} (even N2) or
// {0} (odd) and each pair, U = ceil(N2 / 2) of them, split over the blocks
// as K4 mixed's p-rows do: block r owns units [floor(r U / G), floor((r+1)
// U / G)), at least one (U >= G), so a pair never straddles two blocks and
// step 1 stays each thread's own pair of loads. A block owns nr rows, nr
// between 1 and L = 2 ceil(U / G): buffer B keeps a row stride of 2 L Cw,
// the own tile's nr rows in its first nr Cw columns and the mirror tile's
// in the next nr Cw, and stage B^-1 runs over those 2 nr Cw columns (NCols);
// step 1 splits an item's index by nr with div_magic (exact: nr <= 16 for G
// >= 4, N2 <= 63). The pull of stage A^-1 finds DIT position p's owner
// block and its own- and mirror-tile rows there in an N2-entry map, so
// blocks of unequal row counts pull from each other; a pass's barriers
// depend on its length alone, so they meet the same barriers. Where the plan
// ends in a prime (its DIT runs that pass first, from shared memory), each
// tile's pull fills A before the first pass, and the mirror tile's arrives
// at the split cluster barrier after it, as K4 mixed's inverse does. 1/M is
// a float32 product, not exact for m > 1. Shared memory: B (128 rows of 2 L
// Cw float2), A (M Cw / G), the N2- and 64-entry tables, the prime pass's
// weights, the 2 Cw slots and three N2-entry maps (k2 of a row, rho and the
// owner map): 88.8 KB at M = 3072, G = 8, Cw = 8
// (dft_kernels.x_symbols_cluster_layout).
// ---------------------------------------------------------------------------

// Rows i of a cluster's ordering and their k2: 0, N2/2, then 1, N2 - 1, 2,
// N2 - 2, ...; the partner of row i (k2 -> (N2 - k2) mod N2) is i ^ 1 for
// i >= 2 and i itself for i < 2.
__device__ __forceinline__ int sym_k2(int i, int n2) {
  return i < 2 ? i * (n2 >> 1) : (i & 1) ? n2 - (i >> 1) : i >> 1;
}

__device__ __forceinline__ int sym_row(int k2, int n2) {
  const int h = n2 >> 1;
  return k2 == 0 ? 0 : k2 == h ? 1 : k2 < h ? 2 * k2 : 2 * (n2 - k2) + 1;
}

// sin(pi k'/N), k' = min(k, N - k): symbol_stage's factor of lambda.
__device__ __forceinline__ float sym_sin(int k, int N) {
  return sinpif(static_cast<float>(min(k, N - k)) / static_cast<float>(N));
}

// V = A W + B conj(Wn) at x-frequency kx of M and y-frequency fy (sy =
// sym_sin(fy, P)), with symbol_stage's symbols (fft_device.cuh), written
// out for one element here so that the kernels built on symbol_stage (K3,
// K7, K13, K14, K16, K17) keep their code as it is.
__device__ __forceinline__ void sym_apply(int kx, int fy, float sy, int M,
                                          const SymConsts& c, float2 w,
                                          float2 wn, float2* v, float2* vn) {
  const float sx = sym_sin(kx, M);
  const float lam = (-4.0f * c.inv_dx2) * (sx * sx + sy * sy);
  const float inv1 = (kx == 0 && fy == 0) ? 0.0f : 1.0f / lam;
  const float inv2 = 1.0f / (lam + c.alpha2);
  const float ar = c.a1r * inv1 + c.a2r * inv2, ai = c.a1i * inv1 + c.a2i * inv2;
  const float br = c.b1r * inv1 + c.b2r * inv2, bi = c.b1i * inv1 + c.b2i * inv2;
  auto sym = [&](float2 x, float2 n) {
    return make_float2(ar * x.x - ai * x.y + br * n.x + bi * n.y,
                       ai * x.x + ar * x.y + bi * n.x - br * n.y);
  };
  *v = sym(w, wn);          // at (kx, fy)
  *vn = sym(wn, w);         // at (-kx, -fy): the same symbols
}

// Items of step 1 a thread loads before it computes any: 2 kSymBatch
// complex loads in flight.
constexpr int kSymBatch = 8;

// Steps 2 and 3 below, which K3's, K13's and K14's cluster kernels share:
// stage B^-1 in place on B (both tiles; k1 at row bitrev7(k1), the k2 rows
// of block r in the sym_k2 order), a cluster barrier, then stage A^-1 of
// the own and then the mirror tile through A (one tile) and the stores of
// rows N1 n2 + n1, row stride W (a padding slot, and a self-mirror slot's
// mirror column, are not stored); a split cluster barrier around the last
// pull. kOwnOnly (K13): stage B^-1 and A^-1 of the own tile alone, the same
// barriers on every block. The tile's columns (own cw, then mirror cw) are
// in `slot`.
template <bool kOwnOnly = false>
__device__ __forceinline__ void sym_inverse_half(
    float2* B, float2* A, const float2* twa, const float2* twb,
    const int* slot, const float2* __restrict__ wm, float* __restrict__ out,
    int W, int logn2, int logg, int logcw, int r) {
  namespace cg = cooperative_groups;
  const int n2 = 1 << logn2, cw = 1 << logcw, M = n2 << 7;
  const int logl1 = 7 - logg, logl2 = logn2 - logg;
  const int logtb = logl2 + logcw, lognb = logtb + 1;
  const int logna = logl1 + logcw;
  const size_t plane = (size_t)M * W;
  const int r1 = r << logl1;
  constexpr int ng = kOwnOnly ? 1 : 2;                 // tiles inverted

  // 2. Stage B^-1 in place: row q (k1 = bitrev7(q)) -> row n1.
  auto rd_b = [=](int q, int b) { return B[(q << lognb) + b]; };
  auto wr_b = [=](int q, int b, float2 v) { B[(q << lognb) + b] = v; };
  il_fft<true>(B, kOwnOnly ? logtb : lognb, 1 << lognb, 7, twb, rd_b, wr_b,
               [] {});
  cg::this_cluster().sync();

  // 3. Stage A^-1, tile g (0 own, 1 mirror) in turn: column a of A is n1 =
  // r1 + (a >> logcw), column (a mod cw) of the tile; row p <- the owner of
  // k2 = bitrev(p) (row i = sym_row(k2) of the ordering), times
  // conj(W_M^(n1 k2)); DIT, then row n2 -> x row N1 n2 + n1, scaled 1/M.
  const float scale = 1.0f / static_cast<float>(M);    // exact: M = 2^k
  for (int g = 0; g < ng; ++g) {
    il_fft<true>(A, logna, 1 << logna, logn2, twa,
        [=](int p, int a) {
          const int n1 = r1 + (a >> logcw);
          const int k2 = bitrev(p, logn2), i = sym_row(k2, n2);
          const int b = (g << logtb) + ((i & ((1 << logl2) - 1)) << logcw) +
                        (a & (cw - 1));
          const float2 v = cg::this_cluster().map_shared_rank(
              static_cast<const float2*>(B), i >> logl2)[(n1 << lognb) + b];
          return cmul(v, __ldg(wm + n1 * k2), true);
        },
        [=](int row, int a, float2 v) {
          const int s = slot[(g << logcw) + (a & (cw - 1))];
          if (s < 0 || (g == 1 && s == slot[a & (cw - 1)])) return;
          const size_t off = (size_t)((row << 7) + r1 + (a >> logcw)) * W + s;
          out[off] = v.x * scale;
          out[off + plane] = v.y * scale;
        },
        [=] {
          if (g == ng - 1) asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
        });
    if (g + 1 < ng) __syncthreads();        // the mirror tile reuses A
  }
  // No block leaves while a peer may still read its buffer.
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The mixed instance's ordering for any N2 (sym_k2's for a power of two):
// row 0 holds k2 = 0, for even N2 row 1 holds N2/2, then rows 2m - odd and
// 2m + 1 - odd hold the pair m, N2 - m (odd = N2 mod 2, m >= 1).
__device__ __forceinline__ int sym_k2_any(int i, int n2) {
  const int j = i + (n2 & 1);
  return i == 0 ? 0 : j == 1 ? n2 >> 1 : (j & 1) ? n2 - (j >> 1) : j >> 1;
}

// The row of k2 in sym_k2_any's ordering.
__device__ __forceinline__ int sym_row_any(int k2, int n2) {
  return k2 == 0       ? 0
         : 2 * k2 == n2 ? 1
                        : (2 * k2 < n2 ? 2 * k2 : 2 * (n2 - k2) + 1) - (n2 & 1);
}

// The row of the partner of row i (k2 -> (N2 - k2) mod N2): i itself for
// k2 = 0 and N2/2.
__device__ __forceinline__ int sym_partner(int i, int n2) {
  const int odd = n2 & 1, j = i + odd;
  return (j < 2 ? j : j ^ 1) - odd;
}

// The first row of unit u of the ordering: unit 0 is the rows {0, 1}
// (k2 = 0 and N2/2) for even N2 and the row {0} for odd N2, unit u >= 1 a
// pair; unit (N2 + 1) / 2 starts past the last row.
__device__ __forceinline__ int sym_unit_row(int u, int n2) {
  return u == 0 ? 0 : 2 * u - (n2 & 1);
}

// The mixed cluster kernels' tables (x_symbols_tile's, pair_cluster_tile's),
// built once a block: the prime pass's weights W_p^(ik) (wp), W_N2^k, k <
// N2 (twa); k2 of each row of the ordering (krow); for DIT position p, k2 =
// rho(p) (kpos) and (owner block << 16) | (its mirror-tile row << 8) | its
// own-tile row (own); and, where kinv is given, the DIF position
// rho^-1(k2) of each k2.
__device__ __forceinline__ void sym_mixed_tables(
    const float2* __restrict__ wm, int n2, int plan, int logg, float2* twa,
    float2* wp, int* krow, int* kpos, int* own, int* kinv) {
  const int M = n2 << 7, units = (n2 + 1) >> 1;
  const int prime = y_mixed_prime(n2), half = (prime + 1) / 2;
  for (int e = threadIdx.x; e < (half - 1) * half; e += kClusterThreads) {
    const int i = e / half + 1, k = e - (i - 1) * half;
    wp[e] = wm[(i * k % prime) * (M / prime)];
  }
  for (int k = threadIdx.x; k < n2; k += kClusterThreads) {
    twa[k] = wm[k << 7];
    krow[k] = sym_k2_any(k, n2);
    const int k2 = plan_rho(plan, n2, k), i = sym_row_any(k2, n2);
    const int u = (i + (n2 & 1)) >> 1;                // i's unit
    const int b = (((u + 1) << logg) - 1) / units;    // the block that owns u
    const int b0 = sym_unit_row((b * units) >> logg, n2);
    const int b1 = sym_unit_row(((b + 1) * units) >> logg, n2);
    kpos[k] = k2;
    own[k] = (b << 16) | ((i - b0 + b1 - b0) << 8) | (i - b0);
    if (kinv) kinv[k2] = k;
  }
}

// Steps 2 and 3 of K5's mixed cluster kernel: sym_inverse_half's, on block
// r's nr rows of the ordering (see above): stage B^-1 in place on the 2 nr
// Cw columns of B (row stride bs: the own tile's rows, then the mirror
// tile's), a cluster barrier, then stage A^-1 of the own and then the mirror
// tile through A, the inverse sweep over the plan with DIT position p
// pulled from block own[p] >> 16 (k2 = kpos[p]; its own-tile row own[p] &
// 255, its mirror-tile row (own[p] >> 8) & 255) times conj(W_M^(n1 k2)),
// and the stores of rows N1 n2 + n1 (a padding slot, and a self-mirror
// slot's mirror column, are not stored); a split cluster barrier around the
// last pull. kOwnOnly (K13 mixed), as sym_inverse_half's: stage B^-1 and
// A^-1 of the own tile alone (its nr Cw columns of B), the split barrier's
// arrive in the own tile's pass, so that every block meets the same
// barriers.
template <bool kOwnOnly = false>
__device__ __forceinline__ void sym_inverse_mixed(
    float2* B, float2* A, const float2* twa, const float2* twb,
    const float2* wp, const int* slot, const int* kpos, const int* own,
    const float2* __restrict__ wm, float* __restrict__ out, int W, int n2,
    int plan, int logg, int logcw, int r, int nr, int bs) {
  namespace cg = cooperative_groups;
  const int cw = 1 << logcw, M = n2 << 7;
  const int logl1 = 7 - logg, logna = logl1 + logcw;
  const size_t plane = (size_t)M * W;
  const int r1 = r << logl1;
  constexpr int ng = kOwnOnly ? 1 : 2;                 // tiles inverted

  // 2. Stage B^-1 in place: row q (k1 = bitrev7(q)) -> row n1.
  auto rd_b = [=](int q, int b) { return B[q * bs + b]; };
  auto wr_b = [=](int q, int b, float2 v) { B[q * bs + b] = v; };
  il_fft<true>(B, NCols{(ng * nr) << logcw}, bs, 7, twb, rd_b, wr_b, [] {});
  cg::this_cluster().sync();

  // 3. Stage A^-1, tile g (0 own, 1 mirror) in turn: column a of A is n1 =
  // r1 + (a >> logcw), column (a mod cw) of the tile; DIT, then row n2 -> x
  // row N1 n2 + n1, scaled 1/M.
  int last = 0;
  for (int t = 0; t < 4 && plan_radix(plan, t); ++t) last = plan_radix(plan, t);
  const float scale = 1.0f / static_cast<float>(M);
  auto arrive = [] { asm volatile("barrier.cluster.arrive.aligned;" ::: "memory"); };
  auto at_a = [=](int row, int a) { return A + (row << logna) + a; };
  for (int g = 0; g < ng; ++g) {
    auto pull = [=](int p, int a) {
      const int n1 = r1 + (a >> logcw), o = own[p];
      const int row = g ? (o >> 8) & 255 : o & 255;
      const float2 v = cg::this_cluster().map_shared_rank(
          static_cast<const float2*>(B), o >> 16)[
              n1 * bs + (row << logcw) + (a & (cw - 1))];
      return cmul(v, __ldg(wm + n1 * kpos[p]), true);
    };
    auto st = [=](int row, int a, float2 v) {
      const int s = slot[(g << logcw) + (a & (cw - 1))];
      if (s < 0 || (!kOwnOnly && g == 1 && s == slot[a & (cw - 1)])) return;
      const size_t off = (size_t)((row << 7) + r1 + (a >> logcw)) * W + s;
      out[off] = v.x * scale;
      out[off + plane] = v.y * scale;
    };
    if (!reg_radix(last)) {      // the DIT's first pass is the prime pass
      fill_rows(A, n2 << logna, logna, pull);
      if (g == ng - 1) arrive();
      __syncthreads();
      mixed_fft_at<kClusterThreads, true>(logna, n2, plan, twa, wp, pull, st,
                                          at_a, [] {});
    } else {
      mixed_fft_at<kClusterThreads, true>(logna, n2, plan, twa, wp, pull, st,
                                          at_a, [=] {
                                            if (g == ng - 1) arrive();
                                          });
    }
    if (g + 1 < ng) __syncthreads();    // the mirror tile reuses A
  }
  // No block leaves while a peer may still read its buffer.
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// The cluster kernels' body (see above): kMixed selects the mixed instance,
// which takes N2 = n2m and the plan; the power-of-two one takes N2 =
// 2^logn2.
template <bool kMixed>
__device__ __forceinline__ void x_symbols_tile(
    const float* __restrict__ in, float* __restrict__ out,
    const int* __restrict__ own_slots, const int* __restrict__ mirror_slots,
    int P, int logn2, int n2m, int logg, int logcw, int n1y,
    const SymConsts& c, int plan, const float2* __restrict__ wm) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  const int r = static_cast<int>(cg::this_cluster().block_rank());
  const int n2 = kMixed ? n2m : 1 << logn2, cw = 1 << logcw, M = n2 << 7;
  const int logl1 = 7 - logg, logl2 = kMixed ? 0 : logn2 - logg;
  const int logtb = logl2 + logcw, lognb = logtb + 1;    // B: one tile, both
  const int logna = logl1 + logcw;                       // A: one tile
  // Block r's rows [r2, r2 + nr) of the ordering (mixed: those of its units
  // [floor(r U / G), floor((r+1) U / G))) and B's row stride bs (mixed: 2 L
  // Cw, L = 2 ceil(U / G) the most rows a block owns).
  const int units = (n2 + 1) >> 1;
  const int r2 = kMixed ? sym_unit_row((r * units) >> logg, n2) : r << logl2;
  const int nr =
      kMixed ? sym_unit_row(((r + 1) * units) >> logg, n2) - r2 : 1 << logl2;
  const int bs =
      kMixed ? ((units + (1 << logg) - 1) >> logg) << (logcw + 2) : 1 << lognb;
  float2* B = reinterpret_cast<float2*>(smem);      // 128 rows of bs
  float2* A = B + (kMixed ? 128 * bs : 128 << lognb);   // n2 rows of 2^logna
  // W_N2^k, k < N2 / 2 (mixed: k < N2); W_128^k, k < 64.
  float2* twa = A + (n2 << logna);
  float2* twb = twa + (kMixed ? n2 : n2 / 2);
  // Mixed: the prime pass's weights W_p^(ik), i = 1 .. (p - 1) / 2, k = 0
  // .. (p - 1) / 2.
  const int prime = kMixed ? y_mixed_prime(n2) : 0, half = (prime + 1) / 2;
  float2* wp = twb + 64;
  int* slot = reinterpret_cast<int*>(wp + (half - 1) * half);   // own cw, then mirror cw
  // Mixed: k2 of each row of the ordering; k2 = rho(p) of DIT position p;
  // p -> (owner block << 16) | (its mirror-tile row << 8) | its own-tile row.
  int* krow = slot + 2 * cw;
  int* kpos = krow + n2;
  int* own = kpos + n2;
  const int tile = blockIdx.x >> logg;
  if constexpr (kMixed) {
    sym_mixed_tables(wm, n2, plan, logg, twa, wp, krow, kpos, own, nullptr);
  } else {
    for (int k = threadIdx.x; k < n2 / 2; k += kClusterThreads) twa[k] = wm[k << 7];
  }
  for (int k = threadIdx.x; k < 64; k += kClusterThreads)
    twb[k] = wm[kMixed ? k * n2 : k << logn2];
  for (int k = threadIdx.x; k < 2 * cw; k += kClusterThreads)
    slot[k] = (k < cw ? own_slots : mirror_slots)[(tile << logcw) + (k & (cw - 1))];
  __syncthreads();
  const size_t plane = (size_t)M * P;
  const int n2y = P / n1y;
  auto ld2 = [=](int row, int a) {
    const size_t off = (size_t)row * P + a;
    return make_float2(__ldg(in + off), __ldg(in + off + plane));
  };
  // Item e's k1 and its row il of the block: e = (k1 nr + il) Cw + cc.
  const int magic = kMixed ? div_magic(nr) : 0;
  auto k1_of = [=](int e) {
    return kMixed ? ((e >> logcw) * magic) >> 16 : e >> logtb;
  };
  auto il_of = [=](int e, int k1) {
    return kMixed ? (e >> logcw) - k1 * nr : (e >> logcw) & ((1 << logl2) - 1);
  };
  // The k2 of row i and the row of its partner.
  auto k2_of = [=](int i) { return kMixed ? krow[i] : sym_k2(i, n2); };
  auto partner = [=](int i) {
    return kMixed ? sym_partner(i, n2) : i < 2 ? i : i ^ 1;
  };

  // 1. Item e: column cc, row i = r2 + il of the ordering, k1; its partner
  // row i' (k2' = (N2 - k2) mod N2) and k1' in the mirror tile. A thread's
  // items share their column (cw divides kClusterThreads).
  const int count = kMixed ? (nr << 7) << logcw : 128 << logtb;
  const int mo = kMixed ? nr << logcw : 1 << logtb;    // the mirror tile's column 0
  const int cc = threadIdx.x & (cw - 1), a = slot[cc], b = slot[cw + cc];
  const int fy = a >= 0 ? slot_freq(a, n1y, n2y) : 0;
  const float sy = sym_sin(fy, P);
  for (int e0 = threadIdx.x; e0 < count; e0 += kSymBatch * kClusterThreads) {
    float2 w[kSymBatch], wn[kSymBatch];
#pragma unroll
    for (int u = 0; u < kSymBatch; ++u) {
      const int e = e0 + u * kClusterThreads;
      w[u] = wn[u] = make_float2(0.f, 0.f);
      if (e >= count) continue;
      const int k1 = k1_of(e);
      const int i = r2 + il_of(e, k1);
      const int k2 = k2_of(i);
      const int k2p = k2_of(partner(i));
      const int k1p = k2 == 0 ? (128 - k1) & 127 : 127 - k1;
      const int s = (k2 << 7) + k1, sp = (k2p << 7) + k1p;
      if (a == b && s > sp) continue;     // self-mirror: the lower row's item
      if (a >= 0) w[u] = ld2(s, a);
      if (b >= 0) wn[u] = a == b && s == sp ? w[u] : ld2(sp, b);
    }
#pragma unroll
    for (int u = 0; u < kSymBatch; ++u) {
      const int e = e0 + u * kClusterThreads;
      if (e >= count) continue;
      const int k1 = k1_of(e), il = il_of(e, k1);
      const int i = r2 + il, ip = partner(i);
      const int k2 = k2_of(i);
      const int k1p = k2 == 0 ? (128 - k1) & 127 : 127 - k1;
      const int s = (k2 << 7) + k1, sp = (k2_of(ip) << 7) + k1p;
      const int q = kMixed ? bitrev(k1, 7) * bs : bitrev(k1, 7) << lognb;
      const int qp = kMixed ? bitrev(k1p, 7) * bs : bitrev(k1p, 7) << lognb;
      const int own_i = (il << logcw) + cc, own_ip = ((ip - r2) << logcw) + cc;
      float2 v, vn;
      sym_apply(k2 + (kMixed ? k1 * n2 : k1 << logn2), fy, sy, M, c, w[u],
                wn[u], &v, &vn);
      if (a != b) {
        B[q + own_i] = v;
        B[qp + mo + own_ip] = vn;
      } else {                            // self-mirror or padding
        B[qp + mo + own_ip] = make_float2(0.f, 0.f);
        if (s <= sp) {
          B[q + own_i] = v;
          B[qp + own_ip] = vn;
        }
      }
    }
  }
  __syncthreads();

  // 2 and 3.
  if constexpr (kMixed) {
    sym_inverse_mixed(B, A, twa, twb, wp, slot, kpos, own, wm, out, P, n2,
                      plan, logg, logcw, r, nr, bs);
  } else {
    sym_inverse_half(B, A, twa, twb, slot, wm, out, P, logn2, logg, logcw, r);
  }
}

// ---------------------------------------------------------------------------
// K3 on M = 128 * N2 with ceil(N2 / 2) >= G: the one-launch cluster
// kernels, pair_x_cluster_kernel for N2 = 2^a and
// pair_x_cluster_mixed_kernel for the other N2 <= 63 (one body,
// pair_cluster_tile<kPairWhole, kMixed>). They compute what pair_x_kernel
// computes, per y slot a, W = fft_x(Zy[:, a]), V = A W + B conj(W(-k)),
// out[:, a] = ifft_x(V) (natural x order, the y-spectrum still permuted),
// and so replace the same TPU function, tpu_qg/ops/pallas_fft.py
// PlanarFFT2.pair_x_symbols (:1270; builder _build_pair_x_kernel, :498);
// pair_x_kernel keeps the smaller M (384, 640, 768; 256 and 512).
//
// Bound: device-memory bandwidth, one read and one write of the field (2 x
// 33.5 MB at 2048^2: 0.020 ms at 3.35 TB/s). pair_x_kernel holds whole
// columns of C slot pairs (C = 4 at M = 2048, 141 KB: one 512-thread block
// an SM), so a warp moves runs of 4 floats, 16 bytes, a row and plane: half
// a sector. This kernel is K4's cluster forward half in front of K5's
// cluster kernel, with nothing between them in device memory: a cluster of
// G blocks takes an own tile of Cw y slots and its mirror tile from K5's
// table (dft_kernels.x_symbols_cluster_tiles), and block r
//   1. stage A: loads rows N1 n2 + n1, n1 in [r L1, (r+1) L1), L1 = 128 /
//      G, of the tile's Cw slots into buffer A (runs of Cw floats a row and
//      plane, 32 bytes at Cw = 8; a padding slot, and the mirror column of a
//      self-mirror slot, read zeros), and runs the N2-point DIF along n2:
//      row p then holds k2 = bitrev(p);
//   2. cluster barrier; stage B: for each k2 = sym_k2(i) of its rows i in
//      [r L2, (r+1) L2), L2 = N2 / G, of K5's ordering (k2 beside N2 - k2),
//      pulls row bitrev(k2) of every peer's A times W_M^(n1 k2) into buffer
//      B (row n1) and runs the 128-point DIF along n1: row p' then holds
//      k1 = bitrev7(p'), which is where K5's step 1 puts the spectrum, so
//      no reorder pass is needed. Steps 1 and 2 run for the own tile and
//      then for the mirror tile through A, with a split cluster barrier
//      between them (arrive after the own tile's pull, wait before A is
//      written again);
//   3. the symbol stage in place on B: K5's items, an own value and its
//      partner in the mirror tile (a self-mirror slot's rows paired within
//      its own column), through sym_apply;
//   4. K5's steps 2 and 3 (sym_inverse_half): stage B^-1, cluster barrier,
//      stage A^-1 of each tile through A and the stores of rows N1 n2 + n1,
//      a split cluster barrier before exit.
// Each input value is loaded once and each output value stored once.
// Shared memory: K5's, B (2 M Cw / G float2), A (M Cw / G), the N2/2- and
// 64-entry tables and the tile's 2 Cw slots: 96.7 KB at M = 2048, (G, Cw) =
// (8, 16), two blocks an SM (dft_kernels.pair_x_cluster_layout). A holding
// both tiles, so that steps 1 and 2 and stage A^-1 take both at once
// (tried: faster at (8, 8), slower at (4, 8) and (8, 16)), was in no layout
// faster than (8, 16) with one tile at M = 2048 (PERF.md). The grid is G
// blocks a tile of the table.
//
// The mixed instance (N2 = 2^c m, m odd > 1; the 1536^2 path's N2 = 12) is
// K4 mixed's forward half in front of K5 mixed's symbol stage and inverse
// half. Stage A is K4 mixed's, the DIF sweep over the plan
// dft_kernels.y_dft_mixed_plan(N2) (mixed_fft_at; a plan that starts with a
// prime pass, which reads only shared memory, loads A first), after which A
// row p holds k2 = rho(p). Block r owns K5 mixed's rows: those of its units
// of the ordering sym_k2_any, [floor(r U / G), floor((r+1) U / G)), U =
// ceil(N2 / 2), nr rows; stage B pulls, for row i with k2 = sym_k2_any(i),
// the A row p = rho^-1(k2) of every peer (an N2-entry map built once a
// block beside x_symbols_tile's three), times W_M^(n1 k2), and runs the
// 128-point DIF over its nr Cw columns (NCols) into B at K5 mixed's row
// stride 2 L Cw (L = 2 ceil(U / G)), the own tile at column 0 and the
// mirror tile at column nr Cw, k1 at row bitrev7(k1): where K5 mixed's step
// 1 writes, so its symbol stage (here in place, items split by div_magic)
// and steps 2 and 3 (sym_inverse_mixed) run unchanged. The barriers are the
// power-of-two instance's. Shared memory: K5 mixed's and the N2-entry map,
// 91.0 KB at M = 1536, (G, Cw) = (4, 8) (dft_kernels.pair_x_cluster_layout).
// ---------------------------------------------------------------------------
// The three forms of the mirror-pair cluster tile (pair_cluster_tile):
//   kPairWhole      K3: the whole (2, M, P) field; a tile's slots are the
//                   columns loaded and stored and the symbols' y slots;
//   kPairBlock      K14: a (2, M, W) block of local columns (row stride W),
//                   the symbols at each own column's global y slot in P
//                   (a third table); both tiles stored, as K3;
//   kPairCompanion  K13: as kPairBlock, the mirror tile read from a second
//                   operand (the companion), so no column is its own mirror
//                   and a padding-free tile pairs distinct values; only the
//                   own tile inverted and stored.
// Each form has a mixed instance (kMixed): K3 mixed's body on the form's
// tile table; the block forms' int maps follow their Cw global slots, and
// K13's inverse half is sym_inverse_mixed<true>.
enum PairForm { kPairWhole, kPairBlock, kPairCompanion };

// The cluster's tile pair is row blockIdx.x / G of the tables, or, in the
// one-launch kernels' form (kOneLaunch), whose clusters loop over the
// table, row `tile_arg`; that form also reads the field through L2
// (ldg<true>), as a field written earlier in the launch must be. Each block
// loads all it reads of both tiles before a cluster barrier that precedes
// its first store, and stores only the rows and slots it loaded, so the
// one-launch kernels run it in place (in = out).
template <int kForm, bool kMixed = false, bool kOneLaunch = false>
__device__ __forceinline__ void pair_cluster_tile(
    const float* __restrict__ in, const float* __restrict__ inm,
    float* __restrict__ out, const int* __restrict__ own_slots,
    const int* __restrict__ mirror_slots, const int* __restrict__ global_slots,
    int W, int P, int logn2, int logg, int logcw, int n1y, const SymConsts& c,
    const float2* __restrict__ wm, float* smem, int n2m = 0, int plan = 0,
    int tile_arg = 0) {
  namespace cg = cooperative_groups;
  constexpr bool kBlock = kForm != kPairWhole;
  constexpr bool kCompanion = kForm == kPairCompanion;
  const int r = static_cast<int>(cg::this_cluster().block_rank());
  const int n2 = kMixed ? n2m : 1 << logn2, cw = 1 << logcw, M = n2 << 7;
  const int logl1 = 7 - logg, logl2 = kMixed ? 0 : logn2 - logg;
  const int logtb = logl2 + logcw, lognb = logtb + 1;    // B: both tiles
  const int logna = logl1 + logcw;                       // A: one tile
  // Mixed: block r's rows [r2, r2 + nr) of the ordering, those of its
  // units [floor(r U / G), floor((r+1) U / G)), and B's row stride bs = 2 L
  // Cw, L = 2 ceil(U / G), as in x_symbols_tile.
  const int units = (n2 + 1) >> 1;
  const int r2m = kMixed ? sym_unit_row((r * units) >> logg, n2) : 0;
  const int nr = kMixed ? sym_unit_row(((r + 1) * units) >> logg, n2) - r2m
                        : 1 << logl2;
  const int bs =
      kMixed ? ((units + (1 << logg) - 1) >> logg) << (logcw + 2) : 1 << lognb;
  float2* B = reinterpret_cast<float2*>(smem);      // 128 rows of bs
  float2* A = B + (kMixed ? 128 * bs : 128 << lognb);   // n2 rows of 2^logna
  // W_N2^k, k < N2 / 2 (mixed: k < N2); W_128^k, k < 64.
  float2* twa = A + (n2 << logna);
  float2* twb = twa + (kMixed ? n2 : n2 / 2);
  // Mixed: the prime pass's weights W_p^(ik), i = 1 .. (p - 1) / 2, k = 0
  // .. (p - 1) / 2.
  const int prime = kMixed ? y_mixed_prime(n2) : 0, half = (prime + 1) / 2;
  float2* wp = twb + 64;
  int* slot = reinterpret_cast<int*>(wp + (half - 1) * half);   // own cw, then mirror cw
  int* gsl = kBlock ? slot + 2 * cw : slot;         // own columns' y slots
  // Mixed: x_symbols_tile's three maps (k2 of each row of the ordering; k2
  // = rho(p) of DIT position p; p -> (owner block << 16) | (its mirror-tile
  // row << 8) | its own-tile row) and the forward pull's: the DIF position
  // p = rho^-1(k2) at which a peer's A holds k2; the block forms' after the
  // Cw global slots.
  int* krow = slot + 2 * cw + (kBlock && kMixed ? cw : 0);
  int* kpos = krow + n2;
  int* owner = kpos + n2;
  int* kinv = owner + n2;
  const int tile = kOneLaunch ? tile_arg : blockIdx.x >> logg;
  if constexpr (kMixed) {
    sym_mixed_tables(wm, n2, plan, logg, twa, wp, krow, kpos, owner, kinv);
  } else {
    for (int k = threadIdx.x; k < n2 / 2; k += kClusterThreads) twa[k] = wm[k << 7];
  }
  for (int k = threadIdx.x; k < 64; k += kClusterThreads)
    twb[k] = wm[kMixed ? k * n2 : k << logn2];
  for (int k = threadIdx.x; k < 2 * cw; k += kClusterThreads)
    slot[k] = (k < cw ? own_slots : mirror_slots)[(tile << logcw) + (k & (cw - 1))];
  if constexpr (kBlock) {
    for (int k = threadIdx.x; k < cw; k += kClusterThreads)
      gsl[k] = global_slots[(tile << logcw) + k];
  }
  __syncthreads();
  const size_t plane = (size_t)M * W;
  const int n2y = P / n1y;
  const int r1 = r << logl1, r2 = kMixed ? r2m : r << logl2;

  // 1 and 2, tile g (0 own, 1 mirror) in turn: column a of A is n1 = r1 +
  // (a >> logcw), column (a mod cw) of the tile; column b of tile g's half
  // of B is row i = r2 + (b >> logcw) of the ordering, column (b mod cw).
  for (int g = 0; g < 2; ++g) {
    // A is free again once every peer has pulled the own tile.
    if (g == 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    const float* src = kCompanion && g == 1 ? inm : in;
    auto ld_a = [=](int row, int a) {
      const int col = a & (cw - 1), s = slot[(g << logcw) + col];
      if (s < 0 || (!kCompanion && g == 1 && s == slot[col]))
        return make_float2(0.f, 0.f);
      const size_t off = (size_t)((row << 7) + r1 + (a >> logcw)) * W + s;
      return make_float2(ldg<kOneLaunch>(src + off),
                         ldg<kOneLaunch>(src + off + plane));
    };
    auto wr_a = [=](int row, int a, float2 v) { A[(row << logna) + a] = v; };
    auto arrive_own = [=] {
      if (g == 0) asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
    };
    if constexpr (kMixed) {
      // Stage A over the plan, row p then holding k2 = rho(p); a plan that
      // starts with a prime pass (which reads only shared memory) first
      // finds the rows in A.
      if (!reg_radix(plan_radix(plan, 0))) {
        fill_rows(A, n2 << logna, logna, ld_a);
        __syncthreads();
      }
      mixed_fft_at<kClusterThreads, false>(
          logna, n2, plan, twa, wp, ld_a, wr_a,
          [=](int row, int a) { return A + (row << logna) + a; }, [] {});
      cg::this_cluster().sync();
      float2* Bg = B + (g ? nr << logcw : 0);   // the mirror tile at nr Cw
      // Stage B over the block's nr Cw columns: row n1 <- block n1 / L1's A
      // at row rho^-1(k2), k2 that of row i, times W_M^(n1 k2).
      il_fft<false>(Bg, NCols{nr << logcw}, bs, 7, twb,
          [=](int n1, int b) {
            const int k2 = krow[r2 + (b >> logcw)];
            const float2 v = cg::this_cluster().map_shared_rank(
                static_cast<const float2*>(A), n1 >> logl1)[
                    (kinv[k2] << logna) +
                    ((n1 & ((1 << logl1) - 1)) << logcw) + (b & (cw - 1))];
            return cmul(v, __ldg(wm + n1 * k2), false);
          },
          [=](int pp, int b, float2 v) { Bg[pp * bs + b] = v; }, arrive_own);
    } else {
      il_fft<false>(A, logna, 1 << logna, logn2, twa, ld_a, wr_a, [] {});
      cg::this_cluster().sync();
      float2* Bg = B + (g << logtb);
      il_fft<false>(Bg, logtb, 1 << lognb, 7, twb,
          [=](int n1, int b) {
            const int k2 = sym_k2(r2 + (b >> logcw), n2);
            const float2 v = cg::this_cluster().map_shared_rank(
                static_cast<const float2*>(A), n1 >> logl1)[
                    (bitrev(k2, logn2) << logna) +
                    ((n1 & ((1 << logl1) - 1)) << logcw) + (b & (cw - 1))];
            return cmul(v, __ldg(wm + n1 * k2), false);
          },
          [=](int pp, int b, float2 v) { Bg[(pp << lognb) + b] = v; },
          arrive_own);
    }
  }
  __syncthreads();

  // 3. The symbol stage in place: item e is column cc, row i = r2 + il of
  // the ordering, k1 (at B row bitrev7(k1); mixed: e = (k1 nr + il) Cw + cc,
  // split by div_magic as in x_symbols_tile); its partner row i' (k2' = (N2
  // - k2) mod N2) and k1' in the mirror tile, or in the own column for a
  // self-mirror slot (or padding), whose lower row's item takes both: the
  // words K5's step 1 writes for the same spectrum. A thread's items share
  // their column (cw divides kClusterThreads). The companion form keeps
  // only V: its mirror tile is not inverted.
  const int count = kMixed ? (nr << 7) << logcw : 128 << logtb;
  const int cc = threadIdx.x & (cw - 1), a = slot[cc], b = slot[cw + cc];
  const bool self = !kCompanion && a == b;
  const int fy = a >= 0 ? slot_freq(kBlock ? gsl[cc] : a, n1y, n2y) : 0;
  const float sy = sym_sin(fy, P);
  const int moff = self ? 0 : kMixed ? nr << logcw : 1 << logtb;
  const int magic = kMixed ? div_magic(nr) : 0;
  for (int e = threadIdx.x; e < count; e += kClusterThreads) {
    const int k1 = kMixed ? ((e >> logcw) * magic) >> 16 : e >> logtb;
    const int il =
        kMixed ? (e >> logcw) - k1 * nr : (e >> logcw) & ((1 << logl2) - 1);
    const int i = r2 + il;
    const int ip = kMixed ? sym_partner(i, n2) : i < 2 ? i : i ^ 1;
    const int k2 = kMixed ? krow[i] : sym_k2(i, n2);
    const int k1p = k2 == 0 ? (128 - k1) & 127 : 127 - k1;
    const int s = (k2 << 7) + k1;
    const int sp = ((kMixed ? krow[ip] : sym_k2(ip, n2)) << 7) + k1p;
    if (self && s > sp) continue;
    const int own = (kMixed ? bitrev(k1, 7) * bs : bitrev(k1, 7) << lognb) +
                    (il << logcw) + cc;
    const int mir = (kMixed ? bitrev(k1p, 7) * bs : bitrev(k1p, 7) << lognb) +
                    moff + ((ip - r2) << logcw) + cc;
    float2 v, vn;
    sym_apply(k2 + (kMixed ? k1 * n2 : k1 << logn2), fy, sy, M, c, B[own],
              B[mir], &v, &vn);
    B[own] = v;
    if constexpr (!kCompanion) B[mir] = vn;   // the same word when s = sp
  }
  __syncthreads();

  // 4.
  if constexpr (kMixed) {
    sym_inverse_mixed<kCompanion>(B, A, twa, twb, wp, slot, kpos, owner, wm,
                                  out, W, n2, plan, logg, logcw, r, nr, bs);
  } else {
    sym_inverse_half<kCompanion>(B, A, twa, twb, slot, wm, out, W, logn2,
                                 logg, logcw, r);
  }
}

// Host side of the cluster kernels' launches (dft_kernels.cu,
// pair_cols_mixed.cu).

// Sets a cluster kernel's attributes (shared memory; a cluster of more
// than 8 is non-portable) and fills a launch of `clusters` clusters of
// 2^logg blocks of kClusterThreads.
inline int fill_cluster_launch(const void* fn, int smem, int logg,
                               int clusters, cudaStream_t stream,
                               cudaLaunchConfig_t& cfg,
                               cudaLaunchAttribute& attr) {
  if (int err = set_smem(fn, smem)) return err;
  if (logg > 3) {
    if (int err = static_cast<int>(cudaFuncSetAttribute(
            fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
      return err;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(clusters << logg);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1 << logg;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return 0;
}

// K5's mixed cluster kernel's shared memory: B (128 rows of 2 L Cw float2,
// L = 2 ceil(U / G) the most rows a block owns, U = ceil(N2 / 2) units), A
// (N2 rows of 128 Cw / G), the N2- and 64-entry tables, the prime pass's
// (p - 1) / 2 x (p + 1) / 2 weights (float2), then the tile's 2 Cw slots
// and three N2-entry maps (int).
inline int x_symbols_cluster_mixed_smem(int n2, int logg, int logcw) {
  const int h = y_mixed_prime(n2) / 2, units = (n2 + 1) / 2;
  const int lb = (units + (1 << logg) - 1) >> logg;     // ceil(U / G)
  return ((128 * lb << (logcw + 2)) + (n2 << (7 - logg + logcw)) + n2 + 64 +
          h * (h + 1)) * static_cast<int>(sizeof(float2)) +
         ((2 << logcw) + 3 * n2) * static_cast<int>(sizeof(int));
}

// K3's mixed cluster kernel's shared memory: K5 mixed's and the N2-entry
// map k2 -> rho^-1(k2) of the forward pull (int).
inline int pair_x_cluster_mixed_smem(int n2, int logg, int logcw) {
  return x_symbols_cluster_mixed_smem(n2, logg, logcw) +
         n2 * static_cast<int>(sizeof(int));
}

}  // namespace
