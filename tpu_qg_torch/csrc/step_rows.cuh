// The row-streaming step (step_rows): K1's and K12's body (step_kernel.cu,
// design in its header), K9's (the tendency alone, step_kernel.cu) and
// K18's (the stencil lab's bodies, lab_kernel.cu), and the step stage of the
// persistent one-launch kernels (coop_rows.cuh), which run it on a unit
// index and with barriers of their own in place of blockIdx and
// __syncthreads.
#pragma once

#include <cuda_runtime.h>

#include "bulk_copy.cuh"
#include "step_device.cuh"

namespace {

// Six values of a ring row around 4 columns: p[-1] .. p[4].
__device__ __forceinline__ void lds6(const float* p, float v[6]) {
  const float4 m = lds4(p);
  v[0] = p[-1];
  v[1] = m.x;
  v[2] = m.y;
  v[3] = m.z;
  v[4] = m.w;
  v[5] = p[4];
}

// The block of a layout (W columns a strip, NT threads, D rows ahead): G
// rows a group, S ring slots of psi and zeta, kRow floats a ring row, and
// the bytes of shared memory (the S mbarriers padded to 16 bytes, the psi
// and zeta rings, the G + 2 lap rows).
template <int W, int NT, int D>
struct RowsLayout {
  static_assert(W % 4 == 0 && NT % (W / 4) == 0, "threads must cover rows");
  static constexpr int kTpr = W / 4;
  static constexpr int G = NT / kTpr;
  static constexpr int S = G + 3 + D;
  static constexpr int kRow = W + 8;
  static constexpr int kBarBytes = (S * 8 + 15) / 16 * 16;
  static constexpr int kSmem = kBarBytes + (2 * S + G + 2) * kRow * 4;
};

// Row x (x0 - 2 <= x <= x_end + 1) of layer l of a field: K1 wraps it
// periodically, K12 reads it from the block, or the top slab above it, or
// the bottom slab below it (H >= 2 rows each; no run reads past row M + 1).
template <bool kSharded>
__device__ __forceinline__ const float* rows_src(const float* field,
                                                 const float* top,
                                                 const float* bot, int l,
                                                 int x, int M, int P, int H) {
  if constexpr (kSharded) {
    if (x < 0) return top + ((size_t)l * H + H + x) * P;
    if (x >= M) return bot + ((size_t)l * H + x - M) * P;
    return field + ((size_t)l * M + x) * P;
  } else {
    return field + ((size_t)l * M + ((x % M) + M) % M) * P;
  }
}

// K1's and K12's unit: blockIdx (.x strip, .y run, .z layer), threadIdx.x,
// the block's dynamic shared memory and __syncthreads, each read where
// step_rows uses it (unsigned, as the built-ins are).
struct BlockUnit {
  __device__ __forceinline__ unsigned strip() const { return blockIdx.x; }
  __device__ __forceinline__ unsigned run() const { return blockIdx.y; }
  __device__ __forceinline__ unsigned layer() const { return blockIdx.z; }
  __device__ __forceinline__ unsigned tid() const { return threadIdx.x; }
  __device__ __forceinline__ unsigned char* smem() const {
    extern __shared__ __align__(16) unsigned char rows_smem[];
    return rows_smem;
  }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// The step of one unit `u`: strip u.strip() (W columns), run u.run() (R
// rows) of layer u.layer(), by NT threads (u.tid() = 0 .. NT-1; thread 0
// the producer) in the Lay::kSmem bytes at u.smem(), with u.sync() a
// barrier of those NT threads (BlockUnit: the block; the one-launch
// kernels of coop_rows.cuh run two units a block). The unit leaves every
// bulk copy it issued waited on; a caller that runs another unit in the
// same shared memory puts a barrier of the NT threads and a proxy fence by
// thread 0 between them.
//
// L is the step's layer count (layer u.layer() of L), kBody the tendency
// body as in step_tile (K18: DX and DY the x and y neighbour offsets, 0
// where the body reads the centre in their place, in lap(psi) too, so each
// body gives step_tile's bits), and kTendOnly (K9) stores the tendency to
// zeta_new with no f1/f2 reads, no update and no carry. The defaults are
// K1's step, which K12 and the one-launch kernels also run.
template <int W, int NT, int D, bool kSharded, int L = 2,
          int kBody = kBodyBase, bool kTendOnly = false, class Unit>
__device__ __forceinline__ void step_rows(
    const float* __restrict__ zeta, const float* __restrict__ psi,
    const float* __restrict__ f1, const float* __restrict__ f2,
    const float* __restrict__ wind, float* __restrict__ zeta_new,
    float* __restrict__ carry, int M, int P, int R, const StepConsts& c,
    int leapfrog, int step, const Slabs& sl, const Unit& u) {
  using Lay = RowsLayout<W, NT, D>;
  constexpr int G = Lay::G, S = Lay::S, kRow = Lay::kRow;
  constexpr int DX = kBody == kBodyNorot || kBody == kBodyNoslice ? 0 : 1;
  constexpr int DY = kBody == kBodyNorot ? 0 : 1;
  unsigned char* smem = u.smem();
  auto* bar = reinterpret_cast<unsigned long long*>(smem);
  float* pring = reinterpret_cast<float*>(smem + Lay::kBarBytes);
  float* zring = pring + S * kRow;
  float* lring = zring + S * kRow;

  const int l = u.layer();
  const int y0 = u.strip() * W;
  const int w = min(W, P - y0);
  const int x0 = u.run() * R;
  const int x_end = min(x0 + R, M);
  const int last = x_end + 1;          // the last psi row the run reads
  const int left = (y0 - 4 + P) % P, right = (y0 + w) % P;
  const size_t plane = (size_t)M * P;
  // Row r lives in ring slot (r - x0 + 2) mod S, filled for the
  // ((r - x0 + 2) / S)-th time (the phase parity its wait reads); its
  // lap(psi) in lap slot (r - x0 + 1) mod (G + 2).
  auto slot = [&](int r) { return (r - x0 + 2) % S; };
  auto lap_row = [&](int r) {
    return lring + ((r - x0 + 1) % (G + 2)) * kRow + 4;
  };

  // Thread 0 fills row r's slot: psi, and zeta on rows x0 - 1 .. x_end.
  auto fill = [&](int r) {
    const int s = slot(r);
    const bool with_zeta = r >= x0 - 1 && r <= x_end;
    const unsigned bytes = static_cast<unsigned>(w + 8) * 4u;
    mbar_expect(&bar[s], with_zeta ? 2u * bytes : bytes);
    const float* src = rows_src<kSharded>(psi, sl.psi_top, sl.psi_bot, l, r,
                                          M, P, sl.H);
    float* dst = pring + s * kRow;
    bulk_copy(dst, src + left, 16u, &bar[s]);
    bulk_copy(dst + 4, src + y0, bytes - 32u, &bar[s]);
    bulk_copy(dst + 4 + w, src + right, 16u, &bar[s]);
    if (with_zeta) {
      src = rows_src<kSharded>(zeta, sl.zeta_top, sl.zeta_bot, l, r, M, P,
                               sl.H);
      dst = zring + s * kRow;
      bulk_copy(dst, src + left, 16u, &bar[s]);
      bulk_copy(dst + 4, src + y0, bytes - 32u, &bar[s]);
      bulk_copy(dst + 4 + w, src + right, 16u, &bar[s]);
    }
  };

  int next = x0 - 2;                   // thread 0: the next row to fill
  if (u.tid() == 0) {
    for (int s = 0; s < S; ++s) mbar_init(&bar[s]);
    for (; next <= min(x0 - 3 + S, last); ++next) fill(next);
  }
  u.sync();

  const int tx = u.tid() % Lay::kTpr, ty = u.tid() / Lay::kTpr;
  const int col = 4 * tx;
  const bool col_ok = col < w;
  const bool wind_on = wind != nullptr && l == 0;
  const float beta_l = l == 0 ? c.beta[0] : c.beta[1];
  const bool rd1 = step_reads_f1(leapfrog, step);
  const bool rd2 = step_reads_f2(leapfrog, step);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 wv = wind_on && col_ok
      ? __ldg(reinterpret_cast<const float4*>(wind + y0 + col)) : zero4;
  int ready = x0 - 3;                  // rows through `ready` waited on
  for (int x = x0; x < x_end; x += G) {
    const int xi = x + ty;
    const bool out_ok = col_ok && xi < x_end;
    const size_t at = l * plane + (size_t)xi * P + y0 + col;
    // f1 and f2 of the thread's row, in flight while it waits and forms
    // lap(psi).
    float4 f1v = zero4, f2v = zero4;
    if constexpr (!kTendOnly) {
      if (out_ok) {
        if (rd1) f1v = __ldg(reinterpret_cast<const float4*>(f1 + at));
        if (rd2) f2v = __ldg(reinterpret_cast<const float4*>(f2 + at));
      }
    }
    const int need = min(x + G + 1, last);
    for (int r = ready + 1; r <= need; ++r) {
      mbar_wait(&bar[slot(r)], static_cast<unsigned>(((r - x0 + 2) / S) & 1));
    }
    ready = need;

    // lap(psi): rows x0 - 1 .. x0 + G in the first group, x + 1 .. x + G
    // after it, at columns -1 .. w.
    if (col_ok) {
      const int hi = min(x + G, x_end);
      for (int r = (x == x0 ? x0 - 1 : x + 1) + ty; r <= hi; r += G) {
        const float* pc = pring + slot(r) * kRow + 4;
        const float* pm = pring + slot(r - 1) * kRow + 4;
        const float* pp = pring + slot(r + 1) * kRow + 4;
        float* lr = lap_row(r);
        // K1's lap(psi) (base's, nojac's) stays its own code, so that K1's
        // instances compile as they did.
        if constexpr (DX == 1 && DY == 1) {
          const float4 c4 = lds4(pc + col), m4 = lds4(pm + col),
                       p4 = lds4(pp + col);
          float4 o;
          o.x = step_lap(c4.x, m4.x, p4.x, pc[col - 1], c4.y, c.inv_dx2);
          o.y = step_lap(c4.y, m4.y, p4.y, c4.x, c4.z, c.inv_dx2);
          o.z = step_lap(c4.z, m4.z, p4.z, c4.y, c4.w, c.inv_dx2);
          o.w = step_lap(c4.w, m4.w, p4.w, c4.z, pc[col + 4], c.inv_dx2);
          *reinterpret_cast<float4*>(lr + col) = o;
          if (tx == 0) {
            lr[-1] = step_lap(pc[-1], pm[-1], pp[-1], pc[-2], pc[0],
                              c.inv_dx2);
          }
          if (col + 4 == w) {
            lr[w] = step_lap(pc[w], pm[w], pp[w], pc[w - 1], pc[w + 1],
                             c.inv_dx2);
          }
        } else {
          // step_tile's lap(psi) of the body: with DX = 0 the x neighbours
          // are the centre row, with DY = 0 the y neighbours the centre.
          const float* qm = DX ? pm : pc;
          const float* qp = DX ? pp : pc;
          const float4 c4 = lds4(pc + col), m4 = lds4(qm + col),
                       p4 = lds4(qp + col);
          float4 o;
          o.x = step_lap(c4.x, m4.x, p4.x, DY ? pc[col - 1] : c4.x,
                         DY ? c4.y : c4.x, c.inv_dx2);
          o.y = step_lap(c4.y, m4.y, p4.y, DY ? c4.x : c4.y, DY ? c4.z : c4.y,
                         c.inv_dx2);
          o.z = step_lap(c4.z, m4.z, p4.z, DY ? c4.y : c4.z, DY ? c4.w : c4.z,
                         c.inv_dx2);
          o.w = step_lap(c4.w, m4.w, p4.w, DY ? c4.z : c4.w,
                         DY ? pc[col + 4] : c4.w, c.inv_dx2);
          *reinterpret_cast<float4*>(lr + col) = o;
          if (tx == 0) {
            lr[-1] = step_lap(pc[-1], qm[-1], qp[-1], pc[-1 - DY],
                              pc[-1 + DY], c.inv_dx2);
          }
          if (col + 4 == w) {
            lr[w] = step_lap(pc[w], qm[w], qp[w], pc[w - DY], pc[w + DY],
                             c.inv_dx2);
          }
        }
      }
    }
    u.sync();

    if (out_ok) {
      // Row a of each ring around the thread's columns: rows xi - 1, xi,
      // xi + 1, columns col - 1 .. col + 4.
      float Z[3][6], Ps[3][6], Lc[6];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        lds6(zring + slot(xi - 1 + a) * kRow + 4 + col, Z[a]);
        lds6(pring + slot(xi - 1 + a) * kRow + 4 + col, Ps[a]);
      }
      lds6(lap_row(xi) + col, Lc);
      const float4 lm = lds4(lap_row(xi - 1) + col);
      const float4 lp = lds4(lap_row(xi + 1) + col);
      const float Lm[4] = {lm.x, lm.y, lm.z, lm.w};
      const float Lp[4] = {lp.x, lp.y, lp.z, lp.w};
      const float F1[4] = {f1v.x, f1v.y, f1v.z, f1v.w};
      const float F2[4] = {f2v.x, f2v.y, f2v.z, f2v.w};
      const float Wd[4] = {wv.x, wv.y, wv.z, wv.w};
      float zn[4], out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = k + 1;       // the point's column in Z, Ps and Lc
        float tend;
        if constexpr (kBody == kBodyBase) {   // K1's body, as it was
          tend = step_tendency<L>(
              c, l,
              [&](int a, int b) {
                return a < 0 ? Lm[k] : a > 0 ? Lp[k] : Lc[j + b];
              },
              [&](int a, int b) {
                // z(0, +-1) times a psi difference is the one product two
                // points of a thread share (point j's z_yp term is point
                // j + 2's z_ym term): opaque keeps it each point's own.
                return a == 0 ? opaque(Z[1][j + b]) : Z[a + 1][j + b];
              },
              [&](int a, int b) { return Ps[a + 1][j + b]; },
              [&] { return beta_l; }, wind_on, [&] { return Wd[k]; });
        } else {
          // noslice reads z(a, +-1) as z(0, +-1) for every a, so point j
          // shares z(0, +1) times a psi difference with point j + 2 as
          // base does: one opaque copy a point keeps it each point's own
          // and still one value within the point, as the tile's one
          // shared-memory read. norot reads only the centre, nojac has no
          // Jacobian: neither shares a product.
          float zo[2] = {0.f, 0.f};
          if constexpr (kBody == kBodyNoslice) {
            zo[0] = opaque(Z[1][j - 1]);
            zo[1] = opaque(Z[1][j + 1]);
          }
          tend = step_tendency<L, kBody>(
              c, l,
              [&](int a, int b) {
                return a * DX < 0 ? Lm[k]
                       : a * DX > 0 ? Lp[k] : Lc[j + b * DY];
              },
              [&](int a, int b) {
                if constexpr (kBody == kBodyNoslice) {
                  if (b != 0) return zo[b > 0];
                }
                return Z[a * DX + 1][j + b * DY];
              },
              [&](int a, int b) { return Ps[a * DX + 1][j + b * DY]; },
              [&] { return beta_l; }, wind_on, [&] { return Wd[k]; });
        }
        if constexpr (kTendOnly) {
          zn[k] = tend;
        } else {
          step_update(c, leapfrog, step, Z[1][j], tend,
                      [&] { return F1[k]; }, [&] { return F2[k]; }, zn[k],
                      out[k]);
        }
      }
      *reinterpret_cast<float4*>(zeta_new + at) =
          make_float4(zn[0], zn[1], zn[2], zn[3]);
      if constexpr (!kTendOnly) {
        *reinterpret_cast<float4*>(carry + at) =
            make_float4(out[0], out[1], out[2], out[3]);
      }
    }
    u.sync();   // the group's slots and lap rows may be refilled

    if (u.tid() == 0) {
      const int upto = min(x + 2 * G + 1 + D, last);
      if (next <= upto) {
        fence_proxy_async();
        for (; next <= upto; ++next) fill(next);
      }
    }
  }
}

}  // namespace
