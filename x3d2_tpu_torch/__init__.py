"""x3d2_tpu_torch: the PyTorch/CUDA port of x3d2_tpu for NVIDIA Hopper.

An incompressible Navier-Stokes solver in the x3d2 mould: 6th-order compact
finite differences resolved into operator matrices, skew-symmetric
transport of momentum and passive scalars with Adams-Bashforth or
Runge-Kutta stepping, and a spectral projection written as separable
matrix transforms. Module names mirror x3d2_tpu; this package imports
torch, numpy and scipy only, never jax or x3d2_tpu. Input files parse
with ``config.Config.from_file``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no device given they raise. The transport and scalar
sweeps (``csrc/transeq_sweep.cuh``, built at two band widths:
``transeq_sweep.cu`` and, for X3D2_MATMUL_PRECISION=highest,
``transeq_sweep_w32.cu``) and the two pressure projections, the
three-stage pipeline and the slab projection (``csrc/pressure_pipe.cu``),
run hand-written kernels on CUDA tensors and their plain PyTorch versions
on CPU tensors only; on the card a case no ported kernel serves raises
NotImplementedError.

Float32 matrix products run in full float32: TF32 is off for matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``) and the float32
matmul precision is "highest". Both are PyTorch's defaults; the package
sets them on import so that a caller's earlier change cannot put the
projection at the ~1e-3 level of TF32. The x-apply kernel
(``csrc/x_apply_manual.cu``) computes its products as split TF32, three
tensor-core products of hi/lo halves summed in float32, to float32
accuracy: on an H100 its launches read at most 4.0e-7 of max |float64|
from the float64 product (chip_smoke.py); on tools/prof_manual.py's 512^3
operands 1.5-3.0e-7, where plain float32 reads 3.8e-7 to 1.0e-6.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from .common import AXES, BC, DataLoc  # noqa: E402
from .mesh import Mesh  # noqa: E402

__all__ = ["AXES", "BC", "DataLoc", "Mesh"]
