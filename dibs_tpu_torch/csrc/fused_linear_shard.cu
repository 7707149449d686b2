// The fused linear-Gaussian kernels for particle shards: csrc/fused_linear.cu
// built with DIBS_FL_SHARD 1 (its kernels' particle counters start at the
// launch's p0; the launchers are dibs_fused_linear_shard and
// dibs_fused_linear_wide_shard). See the note at the top of that file.
#define DIBS_FL_SHARD 1
#include "fused_linear.cu"
