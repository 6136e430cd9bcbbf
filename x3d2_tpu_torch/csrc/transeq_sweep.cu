// The transport sweeps at x3d2_tpu's default-mode geometry: BS = 64 output
// points per block, band half-width W = 16 (terms = 2,
// pallas_kernels.py:484, :747, :1131), with the reduced-precision
// (bfloat16 history and partials) instances. The kernels are in
// transeq_sweep.cuh.

#include "transeq_sweep.cuh"

TRANSEQ_SWEEP_C_INTERFACE(64, 16, true)
