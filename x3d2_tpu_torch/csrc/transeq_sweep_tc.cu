// The tensor-core momentum sweeps at x3d2_tpu's default-mode geometry (BS
// = 64 output points per block, band half-width W = 16): every momentum
// sweep of a uniform periodic axis (circulant operators) but the xdiv
// variant and the halo form (the SIMT kernels of transeq_sweep.cu take
// those, and the axes whose operators are not circulant). A library of
// its own, so that nvcc builds it beside transeq_sweep.cu. The kernels are
// in transeq_sweep.cuh.

#include "transeq_sweep.cuh"

TRANSEQ_SWEEP_TC_C_INTERFACE()
