"""The port's sharded step with a passive scalar, z decomposed only: TGV
AB3 at (128, 128, 512) on a (1, 4) mesh with one scalar (Pr 0.7), gloo
ranks spawned on the CPU, float64, the plain versions of the kernels,
against x3d2_tpu's single-device TGVCase step.

On (1, 4) the z sweeps of momentum and scalar run in their halo form (the
64-plane lane halo of x3d2_tpu, the port's W = 16), the x and y sweeps as
on one card, and the repencilled projection transposes over z only.
u, v, w and phi after 3 steps within 2e-8 * max |u| (measured 8.3e-10
for the velocities and 1.9e-9 for phi: the band truncation of the sweeps,
as tests/test_torch_sharding.py).
"""

import math

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax
import jax.numpy as jnp

from x3d2_tpu.cases import SolverParams as JSolverParams
from x3d2_tpu.cases import TGVCase as JTGVCase
from x3d2_tpu.common import BC as JBC
from x3d2_tpu.mesh import Mesh as JMesh

from x3d2_tpu_torch.tools import shard_run

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

DIMS = (128, 128, 512)
STEPS = 3


@pytest.fixture(autouse=True)
def _clean_switches(monkeypatch):
    for k in ("X3D2_FUSED_AB", "X3D2_PALLAS", "X3D2_MATMUL_PRECISION"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    case = JTGVCase(JMesh(DIMS, (2 * math.pi,) * 3,
                          ((JBC.PERIODIC, JBC.PERIODIC),) * 3),
                    JSolverParams(Re=1600.0, time_intg="AB3", dt=1e-3,
                                  n_species=1, pr_species=(0.7,)),
                    dtype=jnp.float64, monitor_path=None, verbose=False)
    st = case.initial_state()
    for _ in range(STEPS):
        st = case._step(st)
    ref = {k: np.asarray(st[k]) for k in ("u", "v", "w", "phi")}
    res = shard_run.run({"dims": DIMS, "mesh": (1, 4), "dtype": "float64",
                         "device": "cpu", "steps": STEPS, "n_species": 1,
                         "pr": (0.7,)},
                        workdir=str(tmp_path_factory.mktemp("ranks")))
    return ref, res


def test_branches(runs):
    _, res = runs
    for r in res:
        assert r["solver"] == {"_sharded_transeq": True,
                               "_sharded_species": True,
                               "_repencil_pressure": True,
                               "_halo_mode": True}


@pytest.mark.parametrize("field", ["u", "v", "w", "phi"])
def test_fields(runs, field):
    ref, res = runs
    got = res[0]["state"][field]
    assert got.shape == ref[field].shape
    err = np.abs(got - ref[field]).max() / np.abs(ref["u"]).max()
    assert err < 2e-8, err
