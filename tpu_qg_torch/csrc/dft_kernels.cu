// K2 (the y-DFT), K3 (the mirror-pair x-kernel), K4 (the x-DFT) and K5
// (symbols + inverse x-DFT) of the packed modal inversion, and K7, K13 and
// K14, the x-stages of the sharded inversions (K3's function on local
// columns, below). Two routes:
// psi = K2^-1(K3(K2(zeta))), three passes over device memory, and the
// four-pass psi = K2^-1(K5(K4(K2(zeta)))) that tpu_qg takes for M > 2432.
//
// Conventions shared with tpu_qg/ops/matmul_fft.py and pallas_fft.py:
//   * complex fields are planar: (2, rows, N) float32, plane 0 = re, 1 = im;
//   * the y-spectrum is kept in PERMUTED order: with N = N1 * N2 (N1 the
//     largest divisor <= 128), slot k2*N1 + k1 holds frequency k2 + N2*k1;
//     so is the x-spectrum between K4 and K5.
//
// K4 has three kernels chosen by shape: x_dft_cluster_kernel, a
// thread-block cluster that runs the factored transform in one pass over
// the field, for M = 128 * 2^a, its mixed-radix form
// x_dft_cluster_mixed_kernel for the other M = 128 * n (n <= 63), both for
// M >= 128 G, and x_dft_kernel for the rest. K2 has three:
// y_dft_factored_kernel, the same factoring along the rows, for P = 128 *
// 2^b (256 <= P <= 8192), its mixed-radix form y_dft_mixed_kernel for the
// other P = 128 * n (3 <= n <= 63), and y_dft_kernel for the rest (P <= 128
// and P not a multiple of 128). K5 has three:
// x_symbols_cluster_kernel, K4's cluster inverse behind the symbol stage,
// for M = 128 * 2^a, its mixed-radix form x_symbols_cluster_mixed_kernel
// for the other M = 128 * n (n <= 63), both for ceil(n / 2) >= G, and
// x_symbols_inverse_kernel for the rest. K3 has three:
// pair_x_cluster_kernel, K4's cluster forward half in front of K5's
// cluster kernel, for M = 128 * 2^a, its mixed-radix form
// pair_x_cluster_mixed_kernel for the other M = 128 * n (n <= 63), both for
// ceil(n / 2) >= G, and pair_x_kernel for the rest. K13 and K14 have three:
// pair_cols_cluster_kernel, K3's cluster kernel on the columns of a block,
// for M = 128 * 2^a, its mixed-radix form pair_cols_cluster_mixed_kernel
// for the other M = 128 * n (n <= 63), both for ceil(n / 2) >= G and whole
// 128-column strips, and pair_cols_kernel for the rest; K7 takes K3's
// cluster kernels (pair_x_cluster_kernel, pair_x_cluster_mixed_kernel)
// where they take M and pair_cols_kernel for the rest.
//
// Every kernel transforms with an in-place radix-2 FFT in shared memory:
// the forward pass is decimation in frequency (natural order in, bit-reversed
// out), the inverse pass decimation in time (bit-reversed in, natural out),
// so no reorder pass is needed between them. Up to four consecutive radix-2
// stages run in registers per shared-memory round trip (group_pass), so a
// 2048-point transform takes 3 barriers instead of 11. Twiddles come from a
// float32 table of exp(-2 pi i k/R), k < R/2, built in float64 on the host.
//
// In the whole-row and whole-column kernels, an extent N = R * m with R =
// 2^logr and m odd (the reference's 128 * n, e.g. 384 = 128 * 3 or 1536 =
// 512 * 3) runs the radix-2 passes on m sub-columns of length R, sub-column
// q holding x[m r + q] at q * sub + pad(r), and joins them with an m-point
// DFT (mixed_fwd / mixed_inv, on a second float32 table of exp(-2 pi i j/N),
// j < N). The power-of-two case (m = 1) is a separate template instance
// with no joining stage. K2's mixed-radix factored kernel instead runs a
// mixed-radix sweep of register butterflies (radix 2^c, 3, 5, 7) and one
// direct prime pass, so an element pays about the sum of n's prime factors.
//
// The whole-row and whole-column bodies (y_rows, pair_x_task) and their FFT
// building blocks live in fft_device.cuh, which the first one-launch
// kernels of fused_kernels.cu share; the redesigned kernels' bodies and
// design notes live in dft_device.cuh, which the persistent one-launch
// kernels of coop_rows.cuh share. This file holds the kernels that launch
// them and their C entry points.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dft_device.cuh"

namespace {

// ---------------------------------------------------------------------------
// K2: 1-D DFT along y (the contiguous axis) of a planar (2, rows, P) field.
//
// Replaces tpu_qg/ops/pallas_fft.py PlanarFFT2._call_y (_build_kernel(axis=
// "y"), _plan, _chunk_dft, _cdot). Forward: natural -> permuted order.
// Inverse: permuted -> natural order, scaled 1/P.
//
// Bound: device-memory bandwidth (one read and one write of the field,
// 2 x 33.5 MB at 2048^2, against ~5 P log2 P flops per row). Since the
// factored kernels below took every P = 128 * n, 2 <= n <= 64, this one
// runs P <= 128 and P not a multiple of 128. Design: one block per row; the row's P complex values (16 KB at P = 2048) sit in
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
  float2* stw = reinterpret_cast<float2*>(smem + y_rows_floats(P, logr, m));
  for (int k = threadIdx.x; k < (1 << logr) / 2; k += blockDim.x) stw[k] = tw[k];
  y_rows<kMixed, false>(in, out, (size_t)rows * P, blockIdx.x, 1, P, logr, m,
                        n1, inverse != 0, stw, twn, smem);
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
// both buffers fit. Since the cluster kernels below took M = 128 * n
// with ceil(n / 2) >= G (the power-of-two extents M >= 256 G and the mixed
// ones), this one runs the smaller M.
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
  const int C = ncols;
  float2* stw = reinterpret_cast<float2*>(
      smem + pair_x_floats(C, m, sub, bstride, false));
  for (int k = threadIdx.x; k < (1 << logr) / 2; k += blockDim.x) stw[k] = tw[k];
  pair_x_task<kMixed, false>(in, out, own_slots + blockIdx.x * C,
                             mirror_slots + blockIdx.x * C, M, P, logr, m, n1y,
                             C, sub, bstride, false, c, stw, twn, smem);
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
// every M: a column of M = 8192 values is 64 KB of shared memory. Since the
// cluster kernels below took every M = 128 * n >= 128 * G (n <= 63 or a
// power of two), this one runs M < 128 * G.
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
// passes (inverse). Timed beside the mixed cluster kernel by chip_smoke.py's
// k4_mixed (PERF.md).
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

// K2's factored kernel (y_dft_factored_kernel): design and body
// (y_factored_block) in dft_device.cuh.

template <int kThreads, bool kInverse>
__global__ void __launch_bounds__(kThreads, y_min_blocks(kThreads))
y_dft_factored_kernel(const float* __restrict__ in, float* __restrict__ out,
                      int rows, int logn2, int logrb,
                      const float2* __restrict__ wm) {
  extern __shared__ float smem[];
  float2* S = reinterpret_cast<float2*>(smem);
  y_factored_block<kThreads, kInverse>(in, out, rows, logn2, logrb, wm, S,
                                       blockIdx.x);
}

// K2's mixed-radix factored kernel (y_dft_mixed_kernel): design and body
// (y_mixed_tables, y_mixed_group) in dft_device.cuh.

template <int kThreads, bool kInverse>
__global__ void __launch_bounds__(kThreads, y_min_blocks(kThreads))
y_dft_mixed_kernel(const float* __restrict__ in, float* __restrict__ out,
                   int rows, int n2, int logrb, int plan,
                   const float2* __restrict__ wm) {
  extern __shared__ float smem[];
  float2* S = reinterpret_cast<float2*>(smem);
  y_mixed_tables<kThreads>(S, n2, logrb, plan, wm);
  __syncthreads();
  y_mixed_group<kThreads, kInverse>(in, out, rows, n2, logrb, plan, S,
                                    blockIdx.x);
}

// K4's cluster kernels: design and body (x_cluster_tile) in
// dft_device.cuh.

__global__ void __launch_bounds__(kClusterThreads, 2)
x_dft_cluster_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int P, int logn2, int logg, int logcw, int inverse,
                     int stage_a, const float2* __restrict__ wm) {
  x_cluster_tile<false>(in, out, P, logn2, 0, logg, logcw, inverse, stage_a,
                        0, wm);
}

__global__ void __launch_bounds__(kClusterThreads, 2)
x_dft_cluster_mixed_kernel(const float* __restrict__ in,
                           float* __restrict__ out, int P, int n2, int logg,
                           int logcw, int inverse, int stage_a, int plan,
                           const float2* __restrict__ wm) {
  x_cluster_tile<true>(in, out, P, 0, n2, logg, logcw, inverse, stage_a, plan,
                       wm);
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
// shared memory up to M = 128 * 63. Since the cluster kernels below took
// M = 128 * n with ceil(n / 2) >= G (the power-of-two extents M >= 256 G
// and the mixed ones), this one runs the smaller M.
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

// K5's cluster kernels: design and body (x_symbols_tile) in
// dft_device.cuh.

__global__ void __launch_bounds__(kClusterThreads, 2)
x_symbols_cluster_kernel(const float* __restrict__ in, float* __restrict__ out,
                         const int* __restrict__ own_slots,
                         const int* __restrict__ mirror_slots, int P,
                         int logn2, int logg, int logcw, int n1y,
                         SymConsts c, const float2* __restrict__ wm) {
  x_symbols_tile<false>(in, out, own_slots, mirror_slots, P, logn2, 0, logg,
                        logcw, n1y, c, 0, wm);
}

__global__ void __launch_bounds__(kClusterThreads, 2)
x_symbols_cluster_mixed_kernel(const float* __restrict__ in,
                               float* __restrict__ out,
                               const int* __restrict__ own_slots,
                               const int* __restrict__ mirror_slots, int P,
                               int n2, int logg, int logcw, int n1y,
                               SymConsts c, int plan,
                               const float2* __restrict__ wm) {
  x_symbols_tile<true>(in, out, own_slots, mirror_slots, P, 0, n2, logg,
                       logcw, n1y, c, plan, wm);
}

// K3's cluster kernels (and K13's and K14's, below): design and body
// (pair_cluster_tile) in dft_device.cuh.

__global__ void __launch_bounds__(kClusterThreads, 2)
pair_x_cluster_kernel(const float* __restrict__ in, float* __restrict__ out,
                      const int* __restrict__ own_slots,
                      const int* __restrict__ mirror_slots, int P, int logn2,
                      int logg, int logcw, int n1y, SymConsts c,
                      const float2* __restrict__ wm) {
  extern __shared__ float smem[];
  pair_cluster_tile<kPairWhole>(in, in, out, own_slots, mirror_slots,
                                own_slots, P, P, logn2, logg, logcw, n1y, c,
                                wm, smem);
}

__global__ void __launch_bounds__(kClusterThreads, 2)
pair_x_cluster_mixed_kernel(const float* __restrict__ in,
                            float* __restrict__ out,
                            const int* __restrict__ own_slots,
                            const int* __restrict__ mirror_slots, int P,
                            int n2, int logg, int logcw, int n1y, SymConsts c,
                            int plan, const float2* __restrict__ wm) {
  extern __shared__ float smem[];
  pair_cluster_tile<kPairWhole, true>(in, in, out, own_slots, mirror_slots,
                                      own_slots, P, P, 0, logg, logcw, n1y, c,
                                      wm, smem, n2, plan);
}

// ---------------------------------------------------------------------------
// K13, K7 and K14, the x-stages of the sharded inversions: K3's function on
// the columns of a planar (2, M, W) block, W <= P, with the symbols at each
// column's global permuted y slot in the y extent P.
//
//   * K13 replaces tpu_qg/ops/pallas_fft.py
//     PlanarFFT2._call_x_fwd_symbols_offset (:1204): its BlockSpec kernel
//     (_build_fwd_symbol_inv_x_kernel_offset, :739) and its manual-DMA
//     streaming form (_build_streaming_fwd_sym_inv_x_pair, :819), which
//     exists only because (2, M, 128) strips at M = 8192 outgrow a TPU
//     core's VMEM; on Hopper one kernel covers both. The block holds global
//     strips offset .. offset + W/128 - 1 of the y-spectrum (in) and,
//     column by column, their mirror strips (inm, the companion); only the
//     own columns are inverted and written.
//   * K7 replaces PlanarFFT2.stream_pair_symbols (:1304), the same builder
//     with mirror_from_self=True: K13 at offset 0 on the whole field with
//     the mirror read from the same operand, which is K3's function.
//   * K14 replaces tpu_qg/parallel/paired.py
//     PairedDistributedInverter._call_paired_kernel (:226; BlockSpec form
//     _build_paired_kernel :131, streaming form :154): the block's strips in
//     mirror-pair order with their global indices `groups_idx`; each pair of
//     columns lies in one group (the self-mirror group 0 pairs each strip
//     with itself), both columns written.
//
// Kernels by shape, as K3's: on M = 128 * 2^a (N2 = M / 128 >= 2 G) with W
// whole 128-column strips, pair_cols_cluster_kernel takes K13 (kCompanion)
// and K14, on the other M = 128 * n (n <= 63, ceil(n / 2) >= G) its mixed
// instance pair_cols_cluster_mixed_kernel, and K7 is K3's cluster kernel
// (pair_x_cluster_kernel or pair_x_cluster_mixed_kernel) on the whole field
// (K3's canonical tiles: each column read once and written once);
// pair_cols_kernel keeps all three at 384, 640, 768 and M < 256 G.
//
// Bound: device-memory bandwidth: K13 reads two blocks and writes one (3 x
// 8 M W bytes: 0.120 ms at (2, 8192, 2048) at 3.35 TB/s), K7 and K14 read
// one and write one. pair_cols_kernel is pair_x_kernel's whole-column
// design: at M = 8192 one slot pair fits a block, so a warp reads one
// scattered 4-byte word a row and plane, and K13 and K7 forward-transform
// each mirror column once per own column. pair_cols_cluster_kernel is K3's cluster
// kernel (pair_cluster_tile above) on a tile table of the block's local
// columns, built by tpu_qg_torch/ops/dft_kernels.py: the loads and stores
// run at row stride W, a third table holds each own column's global y slot
// for the symbols, and
//   * K14 (paired_cluster_tiles): every unordered pair {c, mirror(c)} of
//     local columns once, strip by strip, as K3's x_symbols_cluster_tiles; a self-mirror slot (global y-frequency 0 or
//     P/2, lanes 0 and 64 of global strip 0) is its own mirror column;
//   * K13 (offset_cluster_tiles): every column of the block in tiles of Cw
//     adjacent columns, the mirror tile their companion columns (reversed
//     runs within a strip; lane 0 of strip 0 its own lane) read from inm.
//     The companion's column holds the mirror's value even where it is the
//     own value, so every item pairs an own row with a mirror row and
//     computes V once; the mirror tile is forward-transformed for the
//     symbols and dropped (stage B^-1 and A^-1 of the own tile alone, the
//     same cluster barriers on every block).
// Shared memory: K3's, and the Cw global slots. The grid is G blocks a tile.
//
// The mixed instance, pair_cols_cluster_mixed_kernel, is in
// pair_cols_mixed.cu, a source of its own so that it compiles beside this
// one.
// ---------------------------------------------------------------------------
template <bool kCompanion>
__global__ void __launch_bounds__(kClusterThreads, 2)
pair_cols_cluster_kernel(const float* __restrict__ in,
                         const float* __restrict__ inm,
                         float* __restrict__ out,
                         const int* __restrict__ own_cols,
                         const int* __restrict__ mirror_cols,
                         const int* __restrict__ global_slots, int W, int P,
                         int logn2, int logg, int logcw, int n1y, SymConsts c,
                         const float2* __restrict__ wm) {
  extern __shared__ float smem[];
  pair_cluster_tile<kCompanion ? kPairCompanion : kPairBlock>(
      in, inm, out, own_cols, mirror_cols, global_slots, W, P, logn2, logg,
      logcw, n1y, c, wm, smem);
}

// pair_cols_kernel: the pair task (pair_cols_task) a block, C pairs of
// whole columns from a task table (own column, its mirror's column in inm,
// own column's global slot); own_only (K13, K7): only the own columns are
// inverted and written.
template <bool kMixed>
__global__ void __launch_bounds__(512)
pair_cols_kernel(const float* __restrict__ in, const float* __restrict__ inm,
                 float* __restrict__ out, const int* __restrict__ own_cols,
                 const int* __restrict__ mirror_cols,
                 const int* __restrict__ global_slots, int M, int W, int P,
                 int logr, int m, int n1y, int ncols, int sub, int bstride,
                 int own_only, SymConsts c, const float2* __restrict__ tw,
                 const float2* __restrict__ twn) {
  extern __shared__ float smem[];
  const int C = ncols;
  float2* stw = reinterpret_cast<float2*>(
      smem + pair_x_floats(C, m, sub, bstride, false));
  for (int k = threadIdx.x; k < (1 << logr) / 2; k += blockDim.x) stw[k] = tw[k];
  const int t = blockIdx.x * C;
  pair_cols_task<kMixed, false>(in, inm, out, own_cols + t, mirror_cols + t,
                                global_slots + t, M, W, P, logr, m, n1y, C,
                                sub, bstride, false, own_only != 0, c, stw,
                                twn, smem);
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

namespace {

// Buffers A and B, M Cw / G float2 each, and the N2/2- and 64-entry tables.
int cluster_smem(int logn2, int logg, int logcw) {
  const int tile = 1 << (logn2 + 7 - logg + logcw);
  return (2 * tile + (1 << logn2) / 2 + 64) * static_cast<int>(sizeof(float2));
}

// K4's cluster kernel's launch.
int cluster_config(int logn2, int logg, int logcw, int clusters,
                   cudaStream_t stream, cudaLaunchConfig_t& cfg,
                   cudaLaunchAttribute& attr) {
  if (logg < 3 || logg > 4 || logn2 < logg)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(x_dft_cluster_kernel),
      cluster_smem(logn2, logg, logcw), logg, clusters, stream, cfg, attr);
}

// The mixed instance's shared memory: buffer A (N2 rows of 128 Cw / G
// float2), buffer B (128 rows of ceil(N2 / G) Cw float2), the N2- and
// 64-entry tables and the prime pass's (p - 1) / 2 x (p + 1) / 2 weights
// (float2), then rho and the p-row map (N2 int each).
int cluster_mixed_smem(int n2, int logg, int logcw) {
  const int h = y_mixed_prime(n2) / 2;
  const int rows_b = (n2 + (1 << logg) - 1) >> logg;
  return ((n2 << (7 - logg + logcw)) + ((128 * rows_b) << logcw) + n2 + 64 +
          h * (h + 1)) * static_cast<int>(sizeof(float2)) +
         2 * n2 * static_cast<int>(sizeof(int));
}

// K4's mixed cluster kernel's launch: N2 not a power of two, G <= N2 <= 63.
int cluster_mixed_config(int n2, int logg, int logcw, int clusters,
                         cudaStream_t stream, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute& attr) {
  if (logg < 3 || logg > 4 || n2 < (1 << logg) || n2 > 63 ||
      (n2 & (n2 - 1)) == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(x_dft_cluster_mixed_kernel),
      cluster_mixed_smem(n2, logg, logcw), logg, clusters, stream, cfg, attr);
}

}  // namespace

// The most clusters of the cluster kernel's layout that the card holds at
// once (cudaOccupancyMaxActiveClusters): 0 means the layout cannot run.
extern "C" int qg_x_dft_cluster_occupancy(int logn2, int logg, int logcw,
                                          int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = cluster_config(logn2, logg, logcw, 1, nullptr, cfg, attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, reinterpret_cast<const void*>(x_dft_cluster_kernel),
      &cfg));
}

// K4's cluster kernel on a planar (2, 128 * 2^logn2, P) field: a cluster of
// 2^logg blocks a tile of 2^logcw y slots; wm: the M-entry float2 table.
extern "C" int qg_x_dft_cluster_launch(const float* in, float* out, int P,
                                       int logn2, int logg, int logcw,
                                       int inverse, int stage_a,
                                       const void* wm, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int clusters = (P + (1 << logcw) - 1) >> logcw;
  if (int err = cluster_config(logn2, logg, logcw, clusters,
                               static_cast<cudaStream_t>(stream), cfg, attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, x_dft_cluster_kernel, in, out, P, logn2, logg, logcw, inverse,
          stage_a, static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of the mixed cluster kernel's layout (M = 128 n2) that
// the card holds at once: 0 means the layout cannot run.
extern "C" int qg_x_dft_cluster_mixed_occupancy(int n2, int logg, int logcw,
                                                int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = cluster_mixed_config(n2, logg, logcw, 1, nullptr, cfg, attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, reinterpret_cast<const void*>(x_dft_cluster_mixed_kernel),
      &cfg));
}

// K4's mixed cluster kernel on a planar (2, 128 n2, P) field; plan: the
// radices of stage A in DIF order, one byte each (dft_kernels.
// y_dft_mixed_plan), whose product must be n2; wm: the M-entry float2 table.
extern "C" int qg_x_dft_cluster_mixed_launch(const float* in, float* out,
                                             int P, int n2, int logg,
                                             int logcw, int inverse,
                                             int stage_a, int plan,
                                             const void* wm, void* stream) {
  if (!plan_fits(plan, n2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const int clusters = (P + (1 << logcw) - 1) >> logcw;
  if (int err = cluster_mixed_config(n2, logg, logcw, clusters,
                                     static_cast<cudaStream_t>(stream), cfg,
                                     attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, x_dft_cluster_mixed_kernel, in, out, P, n2, logg, logcw,
          inverse, stage_a, plan, static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Rb N2 p-rows and the four tables (N2/2, 64, 64 and 2 N2 float2).
int y_factored_smem(int logn2, int logrb) {
  const int n2 = 1 << logn2;
  return ((n2 << logrb) * kYRowStride + n2 / 2 + 128 + 2 * n2) *
         static_cast<int>(sizeof(float2));
}

using YFactoredFn = void (*)(const float*, float*, int, int, int,
                             const float2*);

template <int kThreads>
YFactoredFn y_factored_instance(int inverse) {
  return inverse ? y_dft_factored_kernel<kThreads, true>
                 : y_dft_factored_kernel<kThreads, false>;
}

// The instance of a block size and direction (nullptr: no such instance),
// its shared memory attribute set.
YFactoredFn y_factored_fn(int logn2, int logrb, int threads, int inverse,
                          int* err) {
  YFactoredFn fn = threads == 256   ? y_factored_instance<256>(inverse)
                   : threads == 512 ? y_factored_instance<512>(inverse)
                                    : nullptr;
  *err = fn == nullptr || logn2 < 1 || logn2 > 6 || logrb < 0
             ? static_cast<int>(cudaErrorInvalidValue)
             : set_smem(reinterpret_cast<const void*>(fn),
                        y_factored_smem(logn2, logrb));
  return fn;
}

}  // namespace

// The most blocks of the factored K2's layout (P = 128 * 2^logn2, 2^logrb
// rows a block, `threads` threads) that one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, the instance of direction
// `inverse`): 0 means the layout cannot run.
extern "C" int qg_y_dft_factored_occupancy(int logn2, int logrb, int threads,
                                           int inverse, int* blocks) {
  int err = 0;
  YFactoredFn fn = y_factored_fn(logn2, logrb, threads, inverse, &err);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(fn), threads,
      y_factored_smem(logn2, logrb)));
}

// The factored K2 on a planar (2, rows, 128 * 2^logn2) field; wm: the
// P-entry float2 table of W_P^j.
extern "C" int qg_y_dft_factored_launch(const float* in, float* out, int rows,
                                        int logn2, int logrb, int threads,
                                        int inverse, const void* wm,
                                        void* cuda_stream) {
  int err = 0;
  YFactoredFn fn = y_factored_fn(logn2, logrb, threads, inverse, &err);
  if (err) return err;
  fn<<<(rows + (1 << logrb) - 1) >> logrb, threads,
       y_factored_smem(logn2, logrb),
       static_cast<cudaStream_t>(cuda_stream)>>>(
      in, out, rows, logn2, logrb, static_cast<const float2*>(wm));
  return static_cast<int>(cudaGetLastError());
}

namespace {

// Rb N2 p-rows, the four tables (N2, 64, 64 and 2 N2 float2), the two
// N2-entry maps (int) and the prime pass's (p - 1) / 2 x (p + 1) / 2
// weights (float2).
int y_mixed_smem(int n2, int logrb) {
  const int h = y_mixed_prime(n2) / 2;
  return ((n2 << logrb) * kYRowStride + 3 * n2 + 128 + h * (h + 1)) *
             static_cast<int>(sizeof(float2)) +
         2 * n2 * static_cast<int>(sizeof(int));
}

using YMixedFn = void (*)(const float*, float*, int, int, int, int,
                          const float2*);

template <int kThreads>
YMixedFn y_mixed_instance(int inverse) {
  return inverse ? y_dft_mixed_kernel<kThreads, true>
                 : y_dft_mixed_kernel<kThreads, false>;
}

// The mixed instance of a block size and direction (nullptr: no such
// instance), its shared memory attribute set.
YMixedFn y_mixed_fn(int n2, int logrb, int threads, int inverse, int* err) {
  YMixedFn fn = threads == 256   ? y_mixed_instance<256>(inverse)
                : threads == 512 ? y_mixed_instance<512>(inverse)
                                 : nullptr;
  *err = fn == nullptr || n2 < 3 || n2 > 63 || (n2 & (n2 - 1)) == 0 ||
                 logrb < 0
             ? static_cast<int>(cudaErrorInvalidValue)
             : set_smem(reinterpret_cast<const void*>(fn),
                        y_mixed_smem(n2, logrb));
  return fn;
}

}  // namespace

// The most blocks of the mixed K2's layout (P = 128 * n2, 2^logrb rows a
// block, `threads` threads) that one SM holds, the instance of direction
// `inverse`: 0 means the layout cannot run.
extern "C" int qg_y_dft_mixed_occupancy(int n2, int logrb, int threads,
                                        int inverse, int* blocks) {
  int err = 0;
  YMixedFn fn = y_mixed_fn(n2, logrb, threads, inverse, &err);
  if (err) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(fn), threads,
      y_mixed_smem(n2, logrb)));
}

// The mixed K2 on a planar (2, rows, 128 * n2) field; plan: the radices of
// stage A in DIF order, one byte each (dft_kernels.y_dft_mixed_plan),
// whose product must be n2; wm: the P-entry float2 table of W_P^j.
extern "C" int qg_y_dft_mixed_launch(const float* in, float* out, int rows,
                                     int n2, int logrb, int threads,
                                     int inverse, int plan, const void* wm,
                                     void* cuda_stream) {
  if (!plan_fits(plan, n2)) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  YMixedFn fn = y_mixed_fn(n2, logrb, threads, inverse, &err);
  if (err) return err;
  fn<<<(rows + (1 << logrb) - 1) >> logrb, threads, y_mixed_smem(n2, logrb),
       static_cast<cudaStream_t>(cuda_stream)>>>(
      in, out, rows, n2, logrb, plan, static_cast<const float2*>(wm));
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

namespace {

// B (both tiles, 2 M Cw / G float2), A (one tile, M Cw / G), the N2/2- and
// 64-entry tables and the tile's 2 Cw slots.
int x_symbols_cluster_smem(int logn2, int logg, int logcw) {
  const int tile = 1 << (logn2 + 7 - logg + logcw);
  return (3 * tile + (1 << logn2) / 2 + 64) *
             static_cast<int>(sizeof(float2)) +
         (2 << logcw) * static_cast<int>(sizeof(int));
}

// K5's cluster kernel's launch: G = 2^logg in {4, 8, 16}, L2 = N2 / G >= 2.
int x_symbols_cluster_config(int logn2, int logg, int logcw, int tiles,
                             cudaStream_t stream, cudaLaunchConfig_t& cfg,
                             cudaLaunchAttribute& attr) {
  if (logg < 2 || logg > 4 || logn2 < logg + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(x_symbols_cluster_kernel),
      x_symbols_cluster_smem(logn2, logg, logcw), logg, tiles, stream, cfg,
      attr);
}

}  // namespace

// The most clusters of K5's cluster kernel's layout that the card holds at
// once (cudaOccupancyMaxActiveClusters): 0 means the layout cannot run.
extern "C" int qg_x_symbols_cluster_occupancy(int logn2, int logg, int logcw,
                                              int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = x_symbols_cluster_config(logn2, logg, logcw, 1, nullptr, cfg,
                                         attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, reinterpret_cast<const void*>(x_symbols_cluster_kernel),
      &cfg));
}

// K5's cluster kernel on a planar (2, 128 * 2^logn2, P) spectrum: a cluster
// of 2^logg blocks a tile of the (tiles, 2^logcw) device tables own_slots
// and mirror_slots (-1 padding); consts: host array of kNumSymConsts floats
// in SymConsts order; wm: the M-entry float2 table of W_M^j.
extern "C" int qg_x_symbols_cluster_launch(const float* in, float* out,
                                           const int* own_slots,
                                           const int* mirror_slots, int tiles,
                                           int P, int logn2, int logg,
                                           int logcw, int n1y,
                                           const float* consts, const void* wm,
                                           void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = x_symbols_cluster_config(logn2, logg, logcw, tiles,
                                         static_cast<cudaStream_t>(stream),
                                         cfg, attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, x_symbols_cluster_kernel, in, out, own_slots, mirror_slots, P,
          logn2, logg, logcw, n1y, sym_consts(consts),
          static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K5's mixed cluster kernel's launch: N2 not a power of two, 3 <= N2 <= 63,
// G = 2^logg in {4, 8, 16} with U = ceil(N2 / 2) >= G (every block owns a
// unit; a block then owns at most 16 rows, which step 1's div_magic takes).
int x_symbols_cluster_mixed_config(int n2, int logg, int logcw, int tiles,
                                   cudaStream_t stream,
                                   cudaLaunchConfig_t& cfg,
                                   cudaLaunchAttribute& attr) {
  if (logg < 2 || logg > 4 || n2 < 3 || n2 > 63 || (n2 & (n2 - 1)) == 0 ||
      (n2 + 1) / 2 < (1 << logg))
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(x_symbols_cluster_mixed_kernel),
      x_symbols_cluster_mixed_smem(n2, logg, logcw), logg, tiles, stream, cfg,
      attr);
}

}  // namespace

// The most clusters of K5's mixed cluster kernel's layout (M = 128 n2) that
// the card holds at once: 0 means the layout cannot run.
extern "C" int qg_x_symbols_cluster_mixed_occupancy(int n2, int logg,
                                                    int logcw,
                                                    int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = x_symbols_cluster_mixed_config(n2, logg, logcw, 1, nullptr,
                                               cfg, attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters,
      reinterpret_cast<const void*>(x_symbols_cluster_mixed_kernel), &cfg));
}

// K5's mixed cluster kernel on a planar (2, 128 n2, P) spectrum, the tile
// tables and consts as qg_x_symbols_cluster_launch's; plan: the radices of
// stage A in DIF order, one byte each (dft_kernels.y_dft_mixed_plan), whose
// product must be n2; wm: the M-entry float2 table of W_M^j.
extern "C" int qg_x_symbols_cluster_mixed_launch(
    const float* in, float* out, const int* own_slots, const int* mirror_slots,
    int tiles, int P, int n2, int logg, int logcw, int n1y,
    const float* consts, int plan, const void* wm, void* stream) {
  if (!plan_fits(plan, n2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = x_symbols_cluster_mixed_config(
          n2, logg, logcw, tiles, static_cast<cudaStream_t>(stream), cfg,
          attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, x_symbols_cluster_mixed_kernel, in, out, own_slots,
          mirror_slots, P, n2, logg, logcw, n1y, sym_consts(consts), plan,
          static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K3's cluster kernel's launch: K5's layouts and buffers.
int pair_x_cluster_config(int logn2, int logg, int logcw, int tiles,
                          cudaStream_t stream, cudaLaunchConfig_t& cfg,
                          cudaLaunchAttribute& attr) {
  if (logg < 2 || logg > 4 || logn2 < logg + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(pair_x_cluster_kernel),
      x_symbols_cluster_smem(logn2, logg, logcw), logg, tiles, stream, cfg,
      attr);
}

}  // namespace

// The most clusters of K3's cluster kernel's layout that the card holds at
// once (cudaOccupancyMaxActiveClusters): 0 means the layout cannot run.
extern "C" int qg_pair_x_cluster_occupancy(int logn2, int logg, int logcw,
                                           int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_x_cluster_config(logn2, logg, logcw, 1, nullptr, cfg,
                                      attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters, reinterpret_cast<const void*>(pair_x_cluster_kernel),
      &cfg));
}

// K3's cluster kernel on a planar (2, 128 * 2^logn2, P) y-spectral field: a
// cluster of 2^logg blocks a tile of the (tiles, 2^logcw) device tables
// own_slots and mirror_slots (K5's, -1 padding); consts: host array of
// kNumSymConsts floats in SymConsts order; wm: the M-entry float2 table of
// W_M^j.
extern "C" int qg_pair_x_cluster_launch(const float* in, float* out,
                                        const int* own_slots,
                                        const int* mirror_slots, int tiles,
                                        int P, int logn2, int logg, int logcw,
                                        int n1y, const float* consts,
                                        const void* wm, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_x_cluster_config(logn2, logg, logcw, tiles,
                                      static_cast<cudaStream_t>(stream), cfg,
                                      attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, pair_x_cluster_kernel, in, out, own_slots, mirror_slots, P,
          logn2, logg, logcw, n1y, sym_consts(consts),
          static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K3's mixed cluster kernel's launch: K5 mixed's layouts (N2 not a power
// of two, 3 <= N2 <= 63, G = 2^logg in {4, 8, 16}, U = ceil(N2 / 2) >= G).
int pair_x_cluster_mixed_config(int n2, int logg, int logcw, int tiles,
                                cudaStream_t stream, cudaLaunchConfig_t& cfg,
                                cudaLaunchAttribute& attr) {
  if (logg < 2 || logg > 4 || n2 < 3 || n2 > 63 || (n2 & (n2 - 1)) == 0 ||
      (n2 + 1) / 2 < (1 << logg))
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(pair_x_cluster_mixed_kernel),
      pair_x_cluster_mixed_smem(n2, logg, logcw), logg, tiles, stream, cfg,
      attr);
}

}  // namespace

// The most clusters of K3's mixed cluster kernel's layout (M = 128 n2) that
// the card holds at once: 0 means the layout cannot run.
extern "C" int qg_pair_x_cluster_mixed_occupancy(int n2, int logg, int logcw,
                                                 int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_x_cluster_mixed_config(n2, logg, logcw, 1, nullptr, cfg,
                                            attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters,
      reinterpret_cast<const void*>(pair_x_cluster_mixed_kernel), &cfg));
}

// K3's mixed cluster kernel on a planar (2, 128 n2, P) y-spectral field,
// the tile tables and consts as qg_pair_x_cluster_launch's; plan: the
// radices of stage A in DIF order, one byte each
// (dft_kernels.y_dft_mixed_plan), whose product must be n2; wm: the
// M-entry float2 table of W_M^j.
extern "C" int qg_pair_x_cluster_mixed_launch(
    const float* in, float* out, const int* own_slots, const int* mirror_slots,
    int tiles, int P, int n2, int logg, int logcw, int n1y,
    const float* consts, int plan, const void* wm, void* stream) {
  if (!plan_fits(plan, n2)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_x_cluster_mixed_config(n2, logg, logcw, tiles,
                                            static_cast<cudaStream_t>(stream),
                                            cfg, attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, pair_x_cluster_mixed_kernel, in, out, own_slots, mirror_slots,
          P, n2, logg, logcw, n1y, sym_consts(consts), plan,
          static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K13's and K14's cluster kernel: K3's buffers and the tile's Cw global
// slots.
int pair_cols_cluster_smem(int logn2, int logg, int logcw) {
  return x_symbols_cluster_smem(logn2, logg, logcw) +
         (1 << logcw) * static_cast<int>(sizeof(int));
}

using PairColsClusterFn = void (*)(const float*, const float*, float*,
                                   const int*, const int*, const int*, int,
                                   int, int, int, int, int, SymConsts,
                                   const float2*);

// The instance: own_only (K13, the mirror tile from the companion) or both
// tiles stored (K14).
PairColsClusterFn pair_cols_cluster_fn(int own_only) {
  return own_only ? pair_cols_cluster_kernel<true>
                  : pair_cols_cluster_kernel<false>;
}

// The launch: K3's layouts, G = 2^logg in {4, 8, 16}, L2 = N2 / G >= 2.
int pair_cols_cluster_config(int logn2, int logg, int logcw, int own_only,
                             int tiles, cudaStream_t stream,
                             cudaLaunchConfig_t& cfg,
                             cudaLaunchAttribute& attr) {
  if (logg < 2 || logg > 4 || logn2 < logg + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return fill_cluster_launch(
      reinterpret_cast<const void*>(pair_cols_cluster_fn(own_only)),
      pair_cols_cluster_smem(logn2, logg, logcw), logg, tiles, stream, cfg,
      attr);
}

}  // namespace

// The most clusters of the K13 (own_only) or K14 instance of
// pair_cols_cluster_kernel in a layout that the card holds at once
// (cudaOccupancyMaxActiveClusters): 0 means the layout cannot run.
extern "C" int qg_pair_cols_cluster_occupancy(int logn2, int logg, int logcw,
                                              int own_only,
                                              int* max_clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_cols_cluster_config(logn2, logg, logcw, own_only, 1,
                                         nullptr, cfg, attr))
    return err;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      max_clusters,
      reinterpret_cast<const void*>(pair_cols_cluster_fn(own_only)), &cfg));
}

// K13 (own_only: the mirror tile from inm) or K14 (inm = in) on a planar
// (2, 128 * 2^logn2, W) block of a y extent P: a cluster of 2^logg blocks a
// tile of the (tiles, 2^logcw) device tables own_cols, mirror_cols (local
// columns, -1 padding) and global_slots (each own column's permuted y slot
// in P); consts: host array of kNumSymConsts floats in SymConsts order; wm:
// the M-entry float2 table of W_M^j.
extern "C" int qg_pair_cols_cluster_launch(
    const float* in, const float* inm, float* out, const int* own_cols,
    const int* mirror_cols, const int* global_slots, int tiles, int W, int P,
    int logn2, int logg, int logcw, int n1y, int own_only,
    const float* consts, const void* wm, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (int err = pair_cols_cluster_config(logn2, logg, logcw, own_only, tiles,
                                         static_cast<cudaStream_t>(stream),
                                         cfg, attr))
    return err;
  if (cudaError_t err = cudaLaunchKernelEx(
          &cfg, pair_cols_cluster_fn(own_only), in, inm, out, own_cols,
          mirror_cols, global_slots, W, P, logn2, logg, logcw, n1y,
          sym_consts(consts), static_cast<const float2*>(wm)))
    return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// pair_cols_kernel: K13, K7, K14. in, inm, out: planar (2, M, W) fields
// (inm may be in); the task tables are (ntasks, ncols) device ints, -1
// padding; consts: host array of kNumSymConsts floats in SymConsts order.
extern "C" int qg_pair_cols_launch(const float* in, const float* inm,
                                   float* out, const int* own_cols,
                                   const int* mirror_cols,
                                   const int* global_slots, int ntasks, int M,
                                   int W, int P, int logr, int m, int n1y,
                                   int ncols, int sub, int bstride,
                                   int own_only, const float* consts,
                                   const void* tw, const void* twn,
                                   int threads, void* stream) {
  const int smem = (4 * ncols * m * sub + (1 << logr) +
                    (m > 1 ? 4 * ncols * bstride : 0)) *
                   static_cast<int>(sizeof(float));
  if (threads % ncols != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = m > 1 ? pair_cols_kernel<true> : pair_cols_kernel<false>;
  if (int err = set_smem(reinterpret_cast<const void*>(kernel), smem)) return err;
  kernel<<<ntasks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, inm, out, own_cols, mirror_cols, global_slots, M, W, P, logr, m,
      n1y, ncols, sub, bstride, own_only, sym_consts(consts),
      static_cast<const float2*>(tw), static_cast<const float2*>(twn));
  return static_cast<int>(cudaGetLastError());
}
