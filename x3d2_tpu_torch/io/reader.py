"""Read-back sessions for snapshot and statistics stores (copy of
x3d2_tpu.io.reader, which needs no JAX).

Equivalent of the reference's reader session API (io_session.f90:57
`reader_session_t`: open -> begin_step/read/end_step -> close over a
persistent ADIOS2 store, used by restart/analysis tooling): downstream
analysis iterates the snapshot time series and fetches fields by name
without hand-globbing the per-step files that SnapshotManager writes
(here each step is a `step_NNNNNN.npz` under `<prefix>_out/`, as in
x3d2_tpu, so either package reads the other's store).

    with SnapshotReader("snapshot") as r:
        for step in r:                       # time-ordered
            e = step["u"] ** 2 + step["v"] ** 2
        last = r.read(r.timesteps[-1], "pressure")

Arrays come back exactly as written (strided extents, f32 when
snapshot_sp). StatsReader does the same for the Welford statistics
archives of io/stats.py.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

_STEP_RE = re.compile(r"step_(\d+)\.npz$")
_META = ("time", "timestep")


class SnapshotStep:
    """One step of the series: lazy, dict-like field access."""

    def __init__(self, path: str, timestep: int):
        self.path = path
        self.timestep = timestep
        self._npz = None

    def _open(self):
        if self._npz is None:
            self._npz = np.load(self.path)
        return self._npz

    @property
    def time(self) -> float:
        return float(self._open()["time"])

    @property
    def fields(self) -> list:
        """Field names stored at this step (menu of
        get_snapshot_fields, snapshot_manager.f90:198-243)."""
        return sorted(k for k in self._open().files if k not in _META)

    def __contains__(self, name) -> bool:
        return name in self._open().files and name not in _META

    def __getitem__(self, name) -> np.ndarray:
        if name in _META:
            raise KeyError(f"{name} is step metadata; use .time")
        return np.asarray(self._open()[name])

    def close(self):
        if self._npz is not None:
            self._npz.close()
            self._npz = None


class SnapshotReader:
    """Session over a snapshot store written by SnapshotManager.

    `prefix` is the case's snapshot_prefix (the store directory is
    `<prefix>_out/`); a direct path to that directory also works.
    """

    def __init__(self, prefix: str):
        d = prefix if os.path.isdir(prefix) else f"{prefix}_out"
        if not os.path.isdir(d):
            raise FileNotFoundError(f"no snapshot store at {d}")
        self.directory = d
        self._paths = {}
        for p in glob.glob(os.path.join(d, "step_*.npz")):
            m = _STEP_RE.search(p)
            if m:
                self._paths[int(m.group(1))] = p
        self.timesteps = sorted(self._paths)
        self._open_steps = []

    def __len__(self):
        return len(self.timesteps)

    def __iter__(self):
        for ts in self.timesteps:
            s = self.step(ts)
            yield s

    def step(self, timestep: int) -> SnapshotStep:
        if timestep not in self._paths:
            raise KeyError(f"no snapshot at timestep {timestep} "
                           f"(have {self.timesteps[:8]}...)")
        s = SnapshotStep(self._paths[timestep], timestep)
        self._open_steps.append(s)
        return s

    def read(self, timestep: int, name: str) -> np.ndarray:
        """One field at one step (reader_session read, io_session.f90)."""
        return self.step(timestep)[name]

    def fields(self, timestep: int | None = None) -> list:
        ts = self.timesteps[0] if timestep is None else timestep
        return self.step(ts).fields

    def _scan(self, get):
        """Visit every step closing each archive immediately — long
        series must not accumulate thousands of open file handles."""
        out = []
        for ts in self.timesteps:
            s = SnapshotStep(self._paths[ts], ts)
            try:
                out.append(get(s))
            finally:
                s.close()
        return out

    def times(self) -> np.ndarray:
        """Physical times of every stored step (time-ordered)."""
        return np.asarray(self._scan(lambda s: s.time))

    def series(self, name: str) -> np.ndarray:
        """Stack one field across all steps -> (nsteps, *shape)."""
        return np.stack(self._scan(lambda s: s[name]))

    def close(self):
        for s in self._open_steps:
            s.close()
        self._open_steps = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StatsReader:
    """Session over the Welford statistics archives of io/stats.py
    (`<stats_prefix>_NNNNNN.npz`; reference io/stats.f90 time-averaged
    fields). `latest()` returns the archive with the most samples —
    the one analysis normally wants."""

    def __init__(self, prefix: str):
        self._paths = {}
        for p in glob.glob(f"{prefix}_*.npz"):
            m = re.search(r"_(\d+)\.npz$", p)
            if m:
                self._paths[int(m.group(1))] = p
        if not self._paths:
            raise FileNotFoundError(f"no stats archives match {prefix}_*")
        self.timesteps = sorted(self._paths)

    def read(self, timestep: int | None = None) -> dict:
        ts = self.timesteps[-1] if timestep is None else timestep
        with np.load(self._paths[ts]) as z:
            return {k: np.asarray(z[k]) for k in z.files}

    def latest(self) -> dict:
        return self.read(None)
