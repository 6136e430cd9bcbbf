"""Snapshot manager: strided, optionally single-precision visualisation
output.

Counterpart of x3d2_tpu.io.snapshot (reference
src/io/snapshot_manager.f90): field menu u,v,w[,pressure,vort,qcrit,ibm,
phi_N] (get_snapshot_fields:198-243), spatial striding (output_stride),
optional downcast (snapshot_sp, the native strided pack). Per step a
``step_NNNNNN.npz`` under ``<snapshot_prefix>_out/`` and a ParaView
VTK XML ImageData (``.vti``; a RectilinearGrid ``.vtr`` with the true
vertex coordinates on a stretched mesh) beside it, plus the ``.pvd``
collection: the same files, names and keys as x3d2_tpu's. The fields are
copied to the host before ``write`` returns, so the next step may write
over the state's buffers. On a process mesh (the case's ``pmesh``) the
fields and the derived ones are formed on the rank's blocks, through the
case's halo solver, and gathered (collective: every rank calls ``write``)
for rank 0 to write (x3d2_tpu snapshot.py:54-58, :86).
"""

from __future__ import annotations

import os

import numpy as np

from . import native
from ..parallel import multihost
from ..postprocess import make_derived_fields_fn, pressure_vert


class SnapshotManager:
    def __init__(self, case, config, verbose=True):
        self.case = case
        self.config = config
        self.verbose = verbose
        self.steps = []
        want = ["u", "v", "w"] + [f for f in config.output_fields if f]
        # 'species' expands to phi_1..phi_N (reference io_field_utils
        # species-name parsing, io_field_utils.f90:29-516)
        if "species" in want:
            want.remove("species")
            want += [f"phi_{i + 1}"
                     for i in range(case.params.n_species)]
        self.fields = want
        self.pmesh = getattr(case, "pmesh", None)
        derived = [f for f in ("vort", "qcrit") if f in want]
        self._derived_fn = None
        if derived:
            self._derived_fn = make_derived_fields_fn(
                case.solver, case.dt, want=tuple(derived))
        if multihost.is_primary():
            os.makedirs(self._dir, exist_ok=True)

    @property
    def _dir(self):
        return f"{self.config.snapshot_prefix}_out"

    def should_snapshot(self, timestep) -> bool:
        f = self.config.snapshot_freq
        return f > 0 and timestep % f == 0

    def write(self, state, timestep, time):
        s = self.config.output_stride

        def stride(t):
            t = multihost.gather_global(t, self.pmesh, self.case.mesh)
            arr = t.detach().cpu().numpy()
            if self.config.snapshot_sp:
                return native.pack_strided(arr, s)
            return arr[tuple(slice(None, None, max(1, int(st)))
                             for st in s)]

        data = {}
        for name in ("u", "v", "w"):
            if name in self.fields:
                data[name] = stride(state[name])
        if "pressure" in self.fields and "p" in state:
            data["pressure"] = stride(pressure_vert(
                self.case.solver, state["p"], self.case.dt))
        if self._derived_fn is not None:
            der = self._derived_fn(state["u"], state["v"], state["w"])
            # in sorted order, as x3d2_tpu's jitted dict comes back: the
            # same order of arrays in the files
            for k in sorted(der):
                data[k] = stride(der[k])
            del der
        if "ibm" in self.fields and getattr(self.case, "ep", None) is not None:
            data["ibm"] = stride(self.case.ep)
        nphi = self.case.params.n_species
        for i in range(nphi):
            name = f"phi_{i + 1}"
            if name in self.fields or "species" in self.fields:
                data[name] = stride(state["phi"][i])

        path = os.path.join(self._dir, f"step_{timestep:06d}.npz")
        if not multihost.is_primary():
            return path
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, time=time, timestep=timestep, **data)
        os.replace(tmp, path)
        # stretched meshes need explicit per-axis coordinates: emit
        # RectilinearGrid (.vtr); uniform meshes keep the lighter .vti
        # (reference generate_vtk_xml, snapshot_manager.f90:245-285)
        if any(self.case.mesh.stretched):
            vtk = self._write_vtr(data, timestep)
        else:
            vtk = self._write_vti(data, timestep)
        self.steps.append((timestep, time, os.path.basename(vtk)))
        self._write_pvd()
        if self.verbose:
            print(f"Snapshot written: {path} fields={sorted(data)}")
        return path

    # -- minimal VTK XML writers (ParaView-compatible) -------------------
    @staticmethod
    def _arrays(data):
        """The point-data arrays: x fastest, float32, base64 payloads."""
        out = []
        for name, arr in data.items():
            a32 = np.ascontiguousarray(np.transpose(arr, (2, 1, 0)),
                                       dtype=np.float32)
            out.append(f'<DataArray type="Float32" Name="{name}" '
                       f'format="binary">{native.vtk_b64(a32)}</DataArray>')
        return out

    def _write_vti(self, data, timestep):
        """VTK XML ImageData with inline base64 point data."""
        mesh = self.case.mesh
        s = self.config.output_stride
        path = os.path.join(self._dir, f"step_{timestep:06d}.vti")
        nx, ny, nz = next(iter(data.values())).shape[:3]
        dx = [mesh.d[a] * s[a] for a in range(3)]
        body = "\n".join(self._arrays(data))
        xml = f"""<?xml version="1.0"?>
<VTKFile type="ImageData" version="1.0" byte_order="LittleEndian" header_type="UInt32">
  <ImageData WholeExtent="0 {nx - 1} 0 {ny - 1} 0 {nz - 1}" Origin="0 0 0" Spacing="{dx[0]} {dx[1]} {dx[2]}">
    <Piece Extent="0 {nx - 1} 0 {ny - 1} 0 {nz - 1}">
      <PointData>
{body}
      </PointData>
    </Piece>
  </ImageData>
</VTKFile>
"""
        with open(path, "w") as fh:
            fh.write(xml)
        return path

    def _write_vtr(self, data, timestep):
        """VTK XML RectilinearGrid with the true (strided) vertex
        coordinates — required for stretched axes, where ImageData's
        uniform Spacing would misplace the clustered wall points."""
        mesh = self.case.mesh
        s = self.config.output_stride
        path = os.path.join(self._dir, f"step_{timestep:06d}.vtr")
        nx, ny, nz = next(iter(data.values())).shape[:3]
        coords = []
        for a, n in enumerate((nx, ny, nz)):
            c = np.asarray(mesh.geo[a].vert_coords,
                           np.float32)[::max(1, int(s[a]))][:n]
            coords.append(
                f'<DataArray type="Float32" Name="{"XYZ"[a]}" '
                f'format="binary">{native.vtk_b64(np.ascontiguousarray(c))}'
                '</DataArray>')
        ext = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
        xml = f"""<?xml version="1.0"?>
<VTKFile type="RectilinearGrid" version="1.0" byte_order="LittleEndian" header_type="UInt32">
  <RectilinearGrid WholeExtent="{ext}">
    <Piece Extent="{ext}">
      <Coordinates>
{coords[0]}
{coords[1]}
{coords[2]}
      </Coordinates>
      <PointData>
{chr(10).join(self._arrays(data))}
      </PointData>
    </Piece>
  </RectilinearGrid>
</VTKFile>
"""
        with open(path, "w") as fh:
            fh.write(xml)
        return path

    def _write_pvd(self):
        path = f"{self.config.snapshot_prefix}.pvd"
        rows = "\n".join(
            f'    <DataSet timestep="{t}" file="{self._dir}/{f}"/>'
            for _, t, f in self.steps)
        with open(path, "w") as fh:
            fh.write(f"""<?xml version="1.0"?>
<VTKFile type="Collection" version="0.1">
  <Collection>
{rows}
  </Collection>
</VTKFile>
""")
