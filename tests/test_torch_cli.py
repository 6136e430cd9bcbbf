"""The port's entry point, ``python -m x3d2_tpu_torch <input.x3d>``, against
x3d2_tpu's (``x3d2_tpu.__main__.main``), both in float64 on the CPU.

- tests/test_cli.py's input (TGV 16^3 AB2, a checkpoint every 2 steps, a
  single-precision vort snapshot at step 4), and the same with the
  pressure and Q-criterion in the snapshot and statistics from step 2
  (which make both packages keep the physical pressure): the monitoring
  rows (time, enstrophy and KE to rtol 1e-12 as test_torch_tgv.py:77; the
  divergence columns, rounding of a divergence-free field at ~1e-15, to
  1e-13 absolute), every checkpoint's arrays (1e-12 of the largest value),
  the snapshot files (float32 within one ulp of each value plus that) and
  the statistics archives (test_torch_io.py's rule) agree.
- A restart prints "Restart from", appends its rows to monitoring.csv
  (x3d2_tpu's CLI opens it anew), and its checkpoints equal x3d2_tpu's
  restart's; the port's restart from x3d2_tpu's checkpoint file writes the
  same checkpoint as x3d2_tpu's own restart.
- The generic case (u = 1) runs through ``python -m x3d2_tpu_torch`` in a
  subprocess, as users run it, and matches x3d2_tpu's series (its
  enstrophy is rounding too, ~1e-32).
- An x-decomposed ``--mesh`` (NX > 1) and the channel on a mesh (an
  nproc_dir of 1, 2, 2) raise NotImplementedError (the CLI on a (y, z)
  mesh runs: tests/test_torch_sharded_io.py), the channel runs
  (tests/test_torch_channel.py holds it against x3d2_tpu); with no GPU and
  no ``--device`` the CLI raises.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from x3d2_tpu.__main__ import main as jmain

from x3d2_tpu_torch.__main__ import main
from test_cli import INPUT
from test_torch_io import _payloads, _same_arrays, _same_stats

torch.set_num_threads(1)
threadpool_limits(1, user_api="blas")

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-12

STATS = INPUT.replace("output_fields = 'vort'",
                      "output_fields = 'vort', 'qcrit', 'pressure'") + """
&stats_params
initstat = 2
istatfreq = 1
istatout = 4
/End
"""

RESTART = ("keep_checkpoint = .true.",
           "keep_checkpoint = .true.\nrestart_from_checkpoint = .true.")


def _rows(path):
    lines = Path(path).read_text().strip().splitlines()
    assert lines[0] == "time,enstrophy,div_u_max,div_u_mean,ke"
    assert all(not ln.startswith("time") for ln in lines[1:])
    return np.array([[float(x) for x in ln.split(",")] for ln in lines[1:]])


def _same_rows(got, want, noise=(2, 3)):
    """Monitoring rows; the columns `noise` (the divergence; with u = 1
    also the enstrophy) are rounding, held to 1e-13 absolute."""
    assert got.shape == want.shape
    for col in range(5):
        if col in noise:
            assert np.abs(got[:, col] - want[:, col]).max() <= 1e-13
        else:
            np.testing.assert_allclose(got[:, col], want[:, col], rtol=RTOL,
                                       atol=0)


def _same_npz(got, want, skip=()):
    zt, zj = np.load(got), np.load(want)
    assert set(zt.files) - set(skip) == set(zj.files) - set(skip)
    for k in zj.files:
        if k not in skip:
            assert zt[k].dtype == zj[k].dtype, k
            _same_arrays(zt[k], zj[k])


def _run(fn, cwd, argv, monkeypatch, capsys):
    monkeypatch.chdir(cwd)
    fn(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("text", [INPUT, STATS], ids=["test_cli", "stats"])
def test_cli_matches_x3d2_tpu(tmp_path, monkeypatch, capsys, text):
    t, j, k = tmp_path / "t", tmp_path / "j", tmp_path / "k"
    for d in (t, j, k):
        d.mkdir()
        (d / "input.x3d").write_text(text)
        (d / "restart.x3d").write_text(text.replace(*RESTART))
    out = _run(main, t, ["input.x3d", "--dtype", "f64", "--device", "cpu"],
               monkeypatch, capsys)
    assert "Flow case: tgv; grid (16, 16, 16); AB2" in out
    assert out.count("Time for this time step") == 2
    _run(jmain, j, ["input.x3d", "--dtype", "f64"], monkeypatch, capsys)
    _same_rows(_rows(t / "monitoring.csv"), _rows(j / "monitoring.csv"))
    ck = ["checkpoint_000002.npz", "checkpoint_000004.npz"]
    for name in ck:
        _same_npz(t / name, j / name, skip=("key", "torch_rng_cpu"))
    snap = ["snapshot_out/step_000004.npz"]
    if text is STATS:
        assert "Statistics written: statistics_000004.npz" in out
        # the checkpoint at step 4 carries the statistics' accumulators
        assert "stats_pmean" in np.load(t / ck[1]).files
        _same_stats(np.load(t / "statistics_000004.npz"),
                    np.load(j / "statistics_000004.npz"))
        assert sorted(np.load(t / snap[0]).files) == [
            "pressure", "qcrit", "time", "timestep", "u", "v", "vort", "w"]
    for name in snap:
        _same_npz(t / name, j / name)
    pt, xt = _payloads(t / "snapshot_out/step_000004.vti")
    pj, xj = _payloads(j / "snapshot_out/step_000004.vti")
    assert xt == xj and sorted(pt) == sorted(pj)
    for name in pt:
        _same_arrays(pt[name], pj[name])
    assert (t / "snapshot.pvd").read_text() == (j / "snapshot.pvd").read_text()

    # restarts: the port's own file, and in k x3d2_tpu's
    shutil.copy(j / ck[1], k / ck[1])
    out = _run(main, t, ["restart.x3d", "--dtype", "f64", "--device", "cpu"],
               monkeypatch, capsys)
    assert "Restart from checkpoint_000004.npz at iteration 4" in out
    _run(main, k, ["restart.x3d", "--dtype", "f64", "--device", "cpu"],
         monkeypatch, capsys)
    _run(jmain, j, ["restart.x3d", "--dtype", "f64"], monkeypatch, capsys)
    rows_t, rows_j = _rows(t / "monitoring.csv"), _rows(j / "monitoring.csv")
    assert len(rows_t) == 5 and len(rows_j) == 2   # appended / anew
    _same_rows(rows_t[3:], rows_j)
    _same_rows(_rows(k / "monitoring.csv"), rows_j)
    for name in ("checkpoint_000006.npz", "checkpoint_000008.npz",
                 "snapshot_out/step_000008.npz"):
        skip = ("key", "torch_rng_cpu")
        _same_npz(t / name, j / name, skip)
        _same_npz(k / name, j / name, skip)


GENERIC = """
&domain_settings
flow_case_name = 'generic'
L_global = 10d0, 10d0, 10d0
dims_global = 16, 16, 16
/End

&solver_params
Re = 1600d0
time_intg = 'AB3'
dt = 0.001d0
n_iters = 1000
n_output = 1
/End
"""


def test_cli_generic_case_as_users_run_it(tmp_path, monkeypatch, capsys):
    t, j = tmp_path / "t", tmp_path / "j"
    for d in (t, j):
        d.mkdir()
        (d / "input.x3d").write_text(GENERIC)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "x3d2_tpu_torch", "input.x3d", "--dtype",
         "f64", "--device", "cpu", "--n-iters", "3"], cwd=t, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Flow case: generic; grid (16, 16, 16); AB3" in proc.stdout
    _run(jmain, j, ["input.x3d", "--dtype", "f64", "--n-iters", "3"],
         monkeypatch, capsys)
    rows = _rows(t / "monitoring.csv")
    assert len(rows) == 4 and (rows[:, 4] == 0.5).all()
    _same_rows(rows, _rows(j / "monitoring.csv"), noise=(1, 2, 3))


@pytest.mark.parametrize("edit, argv, match", [
    (("'generic'", "'channel'"), ["--n-iters", "2"], None),
    (None, ["--mesh", "2", "1", "1"], "x-decomposed"),
    (("'generic'", "'channel'\nnproc_dir = 1, 2, 2"), [], "GSPMD"),
], ids=["channel", "mesh", "nproc_dir"])
def test_cli_refusals(tmp_path, monkeypatch, capsys, edit, argv, match):
    """The CLI's refusals: an x-decomposed mesh (X_MESH_GAP) and the
    channel on a (y, z) mesh from its nproc_dir (GSPMD_GAP: its stretched y
    has no repencilled projection), both before any process group; the
    channel, refused until its stretched-y Poisson solve was ported, now
    runs (match None)."""
    text = GENERIC if edit is None else GENERIC.replace(*edit)
    (tmp_path / "input.x3d").write_text(text)
    monkeypatch.chdir(tmp_path)
    if match is None:
        main(["input.x3d", "--device", "cpu", *argv])
        assert "Flow case: channel; grid (16, 16, 16)" in capsys.readouterr(
        ).out
        assert len(_rows(tmp_path / "monitoring.csv")) == 3
        return
    with pytest.raises(NotImplementedError, match=match):
        main(["input.x3d", "--device", "cpu", *argv])


@pytest.mark.skipif(torch.cuda.is_available(), reason="a GPU is present")
def test_cli_default_device_is_cuda(tmp_path, monkeypatch):
    (tmp_path / "input.x3d").write_text(GENERIC)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["input.x3d"])
    assert not (tmp_path / "monitoring.csv").exists()
