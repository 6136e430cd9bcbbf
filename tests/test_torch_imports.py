"""The port's package rules: it imports neither jax nor x3d2_tpu (nor does
chip_smoke.py), its entry points default to cuda and never fall back to
the CPU, and CPU tensors never count as kernel launches."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from x3d2_tpu_torch.common import BC, resolve_device
from x3d2_tpu_torch.mesh import Mesh
from x3d2_tpu_torch.ops import transeq_sweep as ts
from x3d2_tpu_torch.ops.dirops import build_axis_ops

# one thread for torch and for numpy's BLAS: the suite runs several workers
# on one machine, and multi-threaded BLAS calls in each of them, spinning on
# oversubscribed cores, made these tests many times slower there
torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")


ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "x3d2_tpu")


def _port_files():
    files = sorted((ROOT / "x3d2_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_x3d2_tpu_imports(path):
    assert path.exists(), path
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_default_device_is_cuda_never_cpu():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    from x3d2_tpu_torch.cases import SolverParams, TGVCase
    from x3d2_tpu_torch.solver import NavierStokes
    mesh = Mesh((16,) * 3, (2 * np.pi,) * 3, ((BC.PERIODIC,) * 2,) * 3)
    for make in (lambda: TGVCase(mesh, SolverParams(), monitor_path=None),
                 lambda: NavierStokes.build(mesh, 1e-3),
                 lambda: build_axis_ops(mesh, 0)):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


def test_sweep_device_rules():
    """CPU tensors take the plain version and count no launch; a device
    that is neither CPU nor CUDA raises instead of falling back."""
    shape = (128, 128, 128)
    mesh = Mesh(shape, (2 * np.pi,) * 3, ((BC.PERIODIC,) * 2,) * 3)
    ops = build_axis_ops(mesh, 0, device="cpu")
    blocks = ts.build_sweep_blocks(ops, 0, device="cpu")
    ts.reset_launch_counts()
    f = torch.zeros(shape)
    out = ts.transeq_sweep(f, f, f, blocks, 1e-3)
    assert len(out) == 3 and ts.launch_counts() == {}
    m = torch.empty(shape, device="meta")
    with pytest.raises(ValueError, match="no transeq sweep"):
        ts.transeq_sweep(m, m, m, blocks, 1e-3)
