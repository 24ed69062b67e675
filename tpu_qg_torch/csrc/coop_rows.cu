// K15's persistent kernel (coop_yspec_rows_kernel) and its sharded form
// (coop_yspec_sharded_rows_kernel): design and bodies in coop_rows.cuh;
// K17's entry points in coop_fullstep.cu and coop_fullstep_mixed.cu, K16's
// in coop_mono.cu and coop_mono_mixed.cu.

#include "coop_rows.cuh"

extern "C" int qg_coop_rows_plan_size() { return kNumRowsPlan; }

// K15. psi_ys: psi's permuted y-spectrum; step_c: kNumConsts floats
// (StepConsts); wind: a (P,) row or null; plan: kNumRowsPlan ints
// (RowsPlan); wmy: the P-entry float2 table of W_P^j; smem: bytes of the
// largest stage; info: 4 ints (rows_config's three, and the step units'
// rows, unit_rows).
extern "C" int qg_yspec_rows_launch(const float* zeta, const float* psi_ys,
                                    const float* f1, const float* f2,
                                    const float* wind, float* zeta_new,
                                    float* carry, float* zeta_ys,
                                    const float* step_c, int leapfrog,
                                    int step, const int* plan, const void* wmy,
                                    int smem, int* info, void* stream) {
  const RowsPlan p = rows_plan(plan);
  const RowsOperands s{zeta, psi_ys, f1, f2, wind, zeta_new, carry, leapfrog,
                       step};
  if (!plan_ok(p, false) || !operands_ok(s) || !aligned16(zeta_ys) ||
      (p.yplan != 0 && !plan_fits(p.yplan, p.yn2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p.yplan ? coop_yspec_rows_kernel<true>
                        : coop_yspec_rows_kernel<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  if (int err = rows_config(kernel, smem, 0, stream, cfg, attr, info))
    return err;
  RowsPlan q = p;
  q.R = info[3] = unit_rows(p, info[0]);
  if (int err = cudaLaunchKernelEx(&cfg, kernel, s, step_consts(step_c),
                                   zeta_ys, q,
                                   static_cast<const float2*>(wmy)))
    return err;
  return static_cast<int>(cudaGetLastError());
}

// K15's sharded form on one rank's (2, m, P) row block (the plan's M = m).
// zeta_top, zeta_bot: natural (2, H, P) slabs; psi_top, psi_bot: (2, H, P)
// slabs of psi's y-spectrum; top_nat, bot_nat: (2, H, P) scratch for their
// natural rows; H >= 2; every slab 16-byte aligned; the rest as K15's.
extern "C" int qg_yspec_sharded_rows_launch(
    const float* zeta, const float* psi_ys, const float* f1, const float* f2,
    const float* wind, float* zeta_new, float* carry, float* zeta_ys,
    const float* step_c, int leapfrog, int step, const int* plan,
    const void* wmy, const float* zeta_top, const float* zeta_bot,
    const float* psi_top, const float* psi_bot, int H, float* top_nat,
    float* bot_nat, int smem, int* info, void* stream) {
  const RowsPlan p = rows_plan(plan);
  const RowsOperands s{zeta, psi_ys, f1, f2, wind, zeta_new, carry, leapfrog,
                       step};
  const Slabs sl{zeta_top, zeta_bot, psi_top, psi_bot, H};
  if (!plan_ok(p, false) || !operands_ok(s) || !aligned16(zeta_ys) ||
      H < 2 || !aligned16(zeta_top) || !aligned16(zeta_bot) ||
      !aligned16(psi_top) || !aligned16(psi_bot) || !aligned16(top_nat) ||
      !aligned16(bot_nat) || (p.yplan != 0 && !plan_fits(p.yplan, p.yn2)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = p.yplan ? coop_yspec_sharded_rows_kernel<true>
                        : coop_yspec_sharded_rows_kernel<false>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  if (int err = rows_config(kernel, smem, 0, stream, cfg, attr, info))
    return err;
  RowsPlan q = p;
  q.R = info[3] = unit_rows(p, info[0]);
  if (int err = cudaLaunchKernelEx(&cfg, kernel, s, step_consts(step_c),
                                   zeta_ys, q,
                                   static_cast<const float2*>(wmy), sl,
                                   top_nat, bot_nat))
    return err;
  return static_cast<int>(cudaGetLastError());
}
