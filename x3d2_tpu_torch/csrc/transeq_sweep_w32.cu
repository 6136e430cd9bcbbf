// The transport sweeps at x3d2_tpu's HIGHEST-mode band: W = 32
// (X3D2_MATMUL_PRECISION=highest, terms = 3: w = 32 on the non-lane axes,
// pallas_kernels.py:484, :747, :1131; the port uses it on z too, where
// the truncation reaches float32 epsilon by w = 32), BS = 32 output points
// per block so that the window stays 96 wide (see transeq_sweep.cuh).
// With the reduced-precision (bfloat16 history and partials) instances of
// the fused AB chains, as at W = 16 (olds_dtype / acc_dtype at w = 32,
// pallas_kernels.py:304-326, :448-460).

#include "transeq_sweep.cuh"

TRANSEQ_SWEEP_C_INTERFACE(32, 32, true)
