// K16's persistent kernel (coop_mono_rows_kernel) with K3's mixed x stage,
// M = 128 n, n not a power of two: design and body in coop_rows.cuh;
// reached through qg_mono_rows_launch (coop_mono.cu).

#include "coop_rows.cuh"

extern "C" int qg_mono_rows_mixed_launch(const float* z, float* out,
                                         const int* plan, const float* consts,
                                         const void* wmy, const void* wmx,
                                         const int* own, const int* mir,
                                         int smem, int* info, void* stream) {
  return mono_rows_launch<true>(z, out, plan, consts, wmy, wmx, own, mir,
                                smem, info, stream);
}
