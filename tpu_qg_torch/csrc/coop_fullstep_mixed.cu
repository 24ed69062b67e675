// K17's persistent kernel (coop_fullstep_rows_kernel) with K3's mixed x
// stage, M = 128 n, n not a power of two: design and body in
// coop_rows.cuh; reached through qg_fullstep_rows_launch
// (coop_fullstep.cu).

#include "coop_rows.cuh"

extern "C" int qg_fullstep_rows_mixed_launch(
    const float* zeta, const float* psi, const float* f1, const float* f2,
    const float* wind, float* zeta_new, float* carry, float* psi_new,
    const float* step_c, int leapfrog, int step, const int* plan,
    const float* consts, const void* wmy, const void* wmx, const int* own,
    const int* mir, int smem, int* info, void* stream) {
  return fullstep_rows_launch<true>(zeta, psi, f1, f2, wind, zeta_new, carry,
                                    psi_new, step_c, leapfrog, step, plan,
                                    consts, wmy, wmx, own, mir, smem, info,
                                    stream);
}
