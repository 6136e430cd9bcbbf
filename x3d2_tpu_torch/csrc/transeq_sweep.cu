// The transport sweeps at x3d2_tpu's default-mode geometry: BS = 64 output
// points per block, band half-width W = 16 (terms = 2,
// pallas_kernels.py:484, :747, :1131), on the SIMT body, with the
// reduced-precision (bfloat16 history and partials) instances: the
// momentum sweep of an axis whose operators are not circulant (a
// non-periodic one) and its halo form, the xdiv variant and the species
// sweep; the momentum sweeps of a uniform periodic axis are
// transeq_sweep_tc.cu's. The kernels are in transeq_sweep.cuh.

#include "transeq_sweep.cuh"

TRANSEQ_SWEEP_C_INTERFACE(64, 16, true)
