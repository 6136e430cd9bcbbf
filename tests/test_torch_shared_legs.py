"""The CPU legs that chip_smoke.py's phase 8 shares between chains
(chip_smoke.CPU_SAME): the card leg of one chain is held against the CPU
leg of another, on the grounds that on the CPU the two run the same
operations. Each pair is stepped here on the CPU, in float32 from the
same initial state, and its states must be bit-equal (u, v, w, the
monitor's KE and, where both chains keep the pressure or neither does, p;
phase 8 holds p only where a chain keeps it), 2 steps at the grid phase 8
runs it at: TGV (128, 128, 256), the cylinder (65, 128, 128). The pairs
are in two files, the first three here and the rest in
test_torch_shared_legs_2.py, so that the suite's workers share them.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch
from threadpoolctl import threadpool_limits

from x3d2_tpu_torch import config
from x3d2_tpu_torch.cases import SolverParams, TGVCase
from x3d2_tpu_torch.common import BC, env_set
from x3d2_tpu_torch.mesh import Mesh

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

SWITCHES = ("X3D2_MID_SPLIT", "X3D2_BFLY", "X3D2_XDIV_FUSED", "X3D2_D2C",
            "X3D2_FUSED_AB", "X3D2_MERGED_X", "X3D2_PIPE3", "X3D2_PALLAS",
            "X3D2_MATMUL_PRECISION", "X3D2_BF16_OLDS", "X3D2_BF16_ACC")


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


def _leg(label, steps=2):
    """The CPU leg of the phase 8 chain `label` names: its final state and
    the monitor's last KE."""
    case, env, keep = smoke.chain_switches(label)
    with env_set(env):
        if case == "cylinder":
            cfg = config.Config.from_file(str(ROOT / smoke.CYL_EXAMPLE))
            cfg.domain.dims_global = smoke.CYL_SMALL
            cfg.cylinder.inlet_noise = (0.0, 0.0, 0.0)
            c = config.make_case(cfg, monitor_path=None, verbose=False,
                                 keep_pressure=keep, device="cpu")
        else:
            c = TGVCase(Mesh(smoke.SMALL, (2 * math.pi,) * 3,
                             ((BC.PERIODIC, BC.PERIODIC),) * 3),
                        SolverParams(Re=1600.0, time_intg="AB3",
                                     dt=smoke.DT),
                        dtype=torch.float32, monitor_path=None,
                        verbose=False, keep_pressure=keep, device="cpu")
        st = c.run(n_iters=steps, n_output=steps)
    return st, c.monitor.rows[-1][4]


def test_labels_name_their_switches():
    assert smoke.chain_switches("X3D2_MID_SPLIT=1, X3D2_BFLY=0, "
                                "keep_pressure=True") == (
        "tgv", {"X3D2_MID_SPLIT": "1", "X3D2_BFLY": "0"}, True)
    assert smoke.chain_switches("cylinder, X3D2_MID_SPLIT=1") == (
        "cylinder", {"X3D2_MID_SPLIT": "1"}, False)
    assert smoke.chain_switches("xdiv path") == ("tgv", {}, False)


def check_shared_leg(label, shared):
    got, ke = _leg(label)
    want, ke_want = _leg(shared)
    alike = smoke.chain_switches(label)[2] == smoke.chain_switches(shared)[2]
    for k in ("u", "v", "w") + (("p",) if alike else ()):
        assert torch.equal(got[k], want[k]), k
    assert ke == ke_want


# the first three pairs (the mid's halves against the merged mid); the
# rest in test_torch_shared_legs_2.py
HERE = smoke.CPU_SAME[:3]


@pytest.mark.parametrize("label,shared", HERE, ids=[a for a, _ in HERE])
def test_shared_cpu_leg_is_bit_equal(label, shared):
    check_shared_leg(label, shared)
