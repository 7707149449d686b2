// Kernel #8 for fleets: csrc/fused_nonlinear.cu built with DIBS_NL_FLEET 1
// (its kernels read each particle's dataset and key; the launcher is
// dibs_fused_nonlinear_fleet). See the note at the top of that file.
#define DIBS_NL_FLEET 1
#include "fused_nonlinear.cu"
