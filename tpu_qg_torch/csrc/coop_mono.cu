// K16's persistent kernel (coop_mono_rows_kernel) with K3's power-of-two x
// stage: design and body in coop_rows.cuh; the mixed x stage's instances in
// coop_mono_mixed.cu.

#include "coop_rows.cuh"

extern "C" int qg_mono_rows_mixed_launch(const float* z, float* out,
                                         const int* plan, const float* consts,
                                         const void* wmy, const void* wmx,
                                         const int* own, const int* mir,
                                         int smem, int* info, void* stream);

// K16. z: the packed natural-order (2, M, P) field; out: psi, (2, M, P);
// plan: kNumRowsPlan ints (RowsPlan, R = 0); consts: kNumSymConsts floats
// (SymConsts); wmy, wmx: the P- and M-entry float2 tables of W_P^j and
// W_M^j; own, mir: K3's (xtiles, Cw) tile tables; smem: bytes of the
// larger stage; info: 3 ints (rows_config's). A plan with a mixed x stage
// goes to qg_mono_rows_mixed_launch.
extern "C" int qg_mono_rows_launch(const float* z, float* out,
                                   const int* plan, const float* consts,
                                   const void* wmy, const void* wmx,
                                   const int* own, const int* mir, int smem,
                                   int* info, void* stream) {
  auto launch = rows_plan(plan).xplan ? qg_mono_rows_mixed_launch
                                      : mono_rows_launch<false>;
  return launch(z, out, plan, consts, wmy, wmx, own, mir, smem, info, stream);
}
