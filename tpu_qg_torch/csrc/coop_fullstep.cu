// K17's persistent kernel (coop_fullstep_rows_kernel) with K3's
// power-of-two x stage: design and body in coop_rows.cuh; the mixed x
// stage's instances in coop_fullstep_mixed.cu.

#include "coop_rows.cuh"

extern "C" int qg_fullstep_rows_mixed_launch(
    const float* zeta, const float* psi, const float* f1, const float* f2,
    const float* wind, float* zeta_new, float* carry, float* psi_new,
    const float* step_c, int leapfrog, int step, const int* plan,
    const float* consts, const void* wmy, const void* wmx, const int* own,
    const int* mir, int smem, int* info, void* stream);

// K17. consts: kNumSymConsts floats (SymConsts); wmx: the M-entry float2
// table of W_M^j; own, mir: K3's (xtiles, Cw) tile tables; the rest as
// K15's (coop_rows.cu). A plan with a mixed x stage goes to
// qg_fullstep_rows_mixed_launch.
extern "C" int qg_fullstep_rows_launch(
    const float* zeta, const float* psi, const float* f1, const float* f2,
    const float* wind, float* zeta_new, float* carry, float* psi_new,
    const float* step_c, int leapfrog, int step, const int* plan,
    const float* consts, const void* wmy, const void* wmx, const int* own,
    const int* mir, int smem, int* info, void* stream) {
  auto launch = rows_plan(plan).xplan ? qg_fullstep_rows_mixed_launch
                                      : fullstep_rows_launch<false>;
  return launch(zeta, psi, f1, f2, wind, zeta_new, carry, psi_new, step_c,
                leapfrog, step, plan, consts, wmy, wmx, own, mir, smem, info,
                stream);
}
