// Kernel #8 for particle shards: csrc/fused_nonlinear.cu built with
// DIBS_NL_SHARD 1 (its kernels' particle counters start at the launch's
// p0; the launcher is dibs_fused_nonlinear_shard). See the note at the top
// of that file.
#define DIBS_NL_SHARD 1
#include "fused_nonlinear.cu"
