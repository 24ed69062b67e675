// K2 (the y-DFT), K3 (the mirror-pair x-kernel), K4 (the x-DFT) and K5
// (symbols + inverse x-DFT) of the packed modal inversion, and K7, K13 and
// K14, the x-stages of the sharded inversions (K3's task on local columns,
// pair_cols_kernel below). Two routes:
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
//
// K2's and K3's bodies (y_rows, pair_x_task) and the FFT building blocks
// live in fft_device.cuh, which the one-launch kernels of fused_kernels.cu
// share.

#include <cuda_runtime.h>

#include "fft_device.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// K13, K7 and K14: K3's mirror-pair task (pair_cols_task) on the columns of a
// planar (2, M, W) block, W <= P, with the symbols at each column's global
// permuted y slot `gsl` in the y extent P. One kernel, three task tables
// (built by tpu_qg_torch/ops/dft_kernels.py):
//
//   * K13 replaces tpu_qg/ops/pallas_fft.py
//     PlanarFFT2._call_x_fwd_symbols_offset (:1204): its BlockSpec kernel
//     (_build_fwd_symbol_inv_x_kernel_offset, :739) and its manual-DMA
//     streaming form (_build_streaming_fwd_sym_inv_x_pair, :819), which
//     exists only because (2, M, 128) strips at M = 8192 outgrow a TPU
//     core's VMEM; on Hopper one column of M = 8192 is 64 KB of shared
//     memory, so one kernel covers both. The block holds global strips
//     offset .. offset + W/128 - 1 of the y-spectrum (in) and, column by
//     column, their mirror strips (inm, the companion); own_only: only the
//     own columns are inverted and written.
//   * K7 replaces PlanarFFT2.stream_pair_symbols (:1304), the same builder
//     with mirror_from_self=True: K13 at offset 0 on the whole field with
//     the mirror read from the same operand (inm = in).
//   * K14 replaces tpu_qg/parallel/paired.py
//     PairedDistributedInverter._call_paired_kernel (:226; BlockSpec form
//     _build_paired_kernel :131, streaming form :154): the block's strips in
//     mirror-pair order with their global indices `groups_idx`; each task
//     pairs columns of one group (the self-mirror group 0 pairs each strip
//     with itself), both groups written (inm = in).
//
// Bound: device-memory bandwidth, as K3: K13 reads two blocks and writes
// one (3 x 8 M W bytes), K7 and K14 read one and write one. Design: K3's
// (see above); K13 and K7 forward-transform each mirror column once per own
// column, as the TPU kernels do, because the mirror lives in another array
// (K13) or that is what K7 computes.
// ---------------------------------------------------------------------------
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

// K13, K7, K14. in, inm, out: planar (2, M, W) fields (inm may be in); the
// task tables are (ntasks, ncols) device ints, -1 padding; consts: host
// array of kNumSymConsts floats in SymConsts order.
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
