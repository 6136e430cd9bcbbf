"""Per-shard checkpoint IO: no global field materialises on one rank.

Counterpart of x3d2_tpu.io.sharded (reference
checkpoint_manager.f90:223-283, its "_rankNNNNNN" arrays), in x3d2_tpu's
on-disk format, so that either package restores the other's files: every
rank writes its own block of each field (a chunk keyed by its global
offsets) to its own ``.shardsNNNN.npz``, and rank 0 writes a small
manifest (scalars, the fields' global shapes and dtypes). A restore is
the dual: each rank reads just the chunks that overlap its block on the
target mesh (chunk extents from the .npy headers, without reading the
arrays), so a checkpoint written on one mesh shape restores onto any
other, or onto one process.

Format
  {prefix}_{timestep:06d}.manifest.npz   timestep, time, dt,
      n_shard_files, n_olds_vars, n_olds, shape::<name>, dtype::<name>
      (and the port's generator state, torch_rng_<device type>)
  {prefix}_{timestep:06d}.shards{rank:04d}.npz
      keys "<name>@<o0>_<o1>_..." -> the chunk at global offset (o0, ...)

Names as x3d2_tpu's: u, v, w, phi, the history per slot olds_<i>_<j> (not
stacked), the Kahan compensation comp_<i>, the statistics stats_<k>. A 0-d
array (the statistics' sample count) is written as a chunk of one element
at offset 0: x3d2_tpu writes it 0-d, key "stats_sample_count@", which its
own reader cannot parse (int("") in its _parse_key); the port reads both
forms. A bfloat16 history
is archived as float32 (the widening is exact; dtype:: keeps bfloat16) and
cast back to the live history's dtype on restore. A block that several
ranks hold (an axis a field leaves whole, topo.field_spec) is written
once, by the rank at the start of that mesh axis. x3d2_tpu's generator
``key`` is read by neither side: each package ignores the other's entry.
"""

from __future__ import annotations

import glob
import io
import os
import re
import zipfile

import numpy as np
import torch

from . import native


def _chunk_key(name, offsets):
    return name + "@" + "_".join(str(int(o)) for o in offsets)


def _parse_key(key):
    name, offs = key.rsplit("@", 1)
    return name, tuple(int(o) for o in offs.split("_") if o)


def _rng_key(gen):
    return f"torch_rng_{gen.device.type}"


def _dtype_name(t):
    return (str(t.dtype).removeprefix("torch.") if torch.is_tensor(t)
            else str(np.asarray(t).dtype))


def _host(t):
    if not torch.is_tensor(t):
        return np.asarray(t)
    t = t.detach().cpu()
    # numpy has no bfloat16: archive it as float32, exactly
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _field_items(state, stats=None):
    """The checkpointed arrays as (name, array) pairs, x3d2_tpu's names
    (io/sharded.py _field_items) without its generator key."""
    items = [(k, state[k]) for k in ("u", "v", "w", "phi") if k in state]
    for i, o in enumerate(state.get("olds", ())):
        for j, a in enumerate(o):
            items.append((f"olds_{i}_{j}", a))
    for i, c in enumerate(state.get("comp", ())):
        items.append((f"comp_{i}", c))
    for k, v in (stats or {}).items():
        items.append((f"stats_{k}", v))
    return items


def _block(pmesh, mesh, shape):
    """(global shape, this rank's index into it, whether this rank writes
    the block) of an array of local `shape`."""
    if pmesh is None or pmesh.size == 1 or len(shape) < 3:
        return tuple(shape), tuple(slice(0, s) for s in shape), (
            pmesh is None or pmesh.rank == 0)
    from ..parallel.topo import field_spec, global_shape, local_slices
    g = global_shape(pmesh, mesh, shape)
    spec = field_spec(pmesh, g)
    writer = all(pmesh.coords[n] == 0 for n in ("y", "z") if n not in spec)
    index = tuple(slice(s.start or 0, s.stop if s.stop is not None else d)
                  for s, d in zip(local_slices(pmesh, g), g))
    return g, index, writer


def write_sharded(prefix, timestep, state, time, dt, stats=None,
                  pmesh=None, mesh=None, async_write=True):
    """Write this rank's shard file (and, on rank 0, the manifest) of a
    state of the rank's blocks (pmesh: its parallel.topo.ProcessMesh, mesh:
    the case's Mesh; neither for one process). `stats`: the statistics'
    accumulators as the rank's blocks and their sample count. Each array
    is copied to the host before this returns; the files go through the
    native background writer unless async_write is False. Returns the
    manifest's path."""
    rank = 0 if pmesh is None else pmesh.rank
    chunks, meta = {}, {}
    for name, arr in _field_items(state, stats):
        shape = tuple(arr.shape) if hasattr(arr, "shape") else ()
        if not shape:
            arr, shape = np.asarray(arr).reshape(1), (1,)
        g, index, writer = _block(pmesh, mesh, shape)
        meta[f"shape::{name}"] = np.asarray(g)
        meta[f"dtype::{name}"] = np.asarray(_dtype_name(arr))
        if writer:
            chunks[_chunk_key(name, [s.start for s in index])] = _host(arr)
    base = f"{prefix}_{timestep:06d}"
    write = native.async_write if async_write else native.write_atomic_plain
    buf = io.BytesIO()
    np.savez(buf, **chunks)
    del chunks
    write(f"{base}.shards{rank:04d}.npz", buf.getvalue())
    manifest = f"{base}.manifest.npz"
    if rank == 0:
        olds = state.get("olds", ())
        if any(len(o) for o in olds):
            meta["n_olds_vars"] = np.asarray(len(olds))
            meta["n_olds"] = np.asarray(max(len(o) for o in olds))
        if "rng" in state:
            meta[_rng_key(state["rng"])] = state["rng"].get_state().numpy()
        meta["timestep"] = np.asarray(timestep)
        meta["time"] = np.asarray(time)
        meta["dt"] = np.asarray(dt)
        meta["n_shard_files"] = np.asarray(1 if pmesh is None else pmesh.size)
        mbuf = io.BytesIO()
        np.savez(mbuf, **meta)
        write(manifest, mbuf.getvalue())
    return manifest


def _npz_headers(path):
    """{key: (shape, dtype)} of an .npz's arrays, from their .npy headers
    alone."""
    out = {}
    with zipfile.ZipFile(path) as zf:
        for member in zf.namelist():
            with zf.open(member) as fh:
                version = np.lib.format.read_magic(fh)
                read = {(1, 0): np.lib.format.read_array_header_1_0,
                        (2, 0): np.lib.format.read_array_header_2_0}
                if version not in read:
                    raise ValueError(f"{path}: {member} is an .npy of "
                                     f"version {version}")
                shape, _, dtype = read[version](fh)
            out[member.removesuffix(".npy")] = (tuple(shape), dtype)
    return out


class ChunkReader:
    """The chunks of one per-shard checkpoint, read lazily."""

    def __init__(self, manifest_path):
        self.manifest = np.load(manifest_path)
        base = manifest_path[:-len(".manifest.npz")]
        paths = sorted(glob.glob(base + ".shards*.npz"))
        if not paths:
            raise FileNotFoundError(f"no shard files next to "
                                    f"{manifest_path}")
        want = int(self.manifest["n_shard_files"]) \
            if "n_shard_files" in self.manifest.files else len(paths)
        if len(paths) != want:
            raise FileNotFoundError(
                f"{manifest_path}: {len(paths)} shard files, the manifest "
                f"names {want}")
        self.files = [np.load(p) for p in paths]
        self.index = {}     # name -> [(offsets, chunk shape, file, key)]
        for path, f in zip(paths, self.files):
            for key, (shape, _) in _npz_headers(path).items():
                name, offs = _parse_key(key)
                self.index.setdefault(name, []).append((offs, shape, f, key))

    def names(self):
        return set(self.index)

    def shape(self, name):
        return tuple(int(s) for s in self.manifest[f"shape::{name}"])

    def read_slice(self, name, index):
        """The sub-array [name][index] (slices with starts and stops),
        from the chunks that overlap it alone."""
        shape = self.shape(name)
        index = tuple(slice(s.start or 0, s.stop if s.stop is not None
                            else d) for s, d in zip(index, shape))
        out_shape = tuple(s.stop - s.start for s in index)
        out, filled = None, 0
        for offs, cshape, f, key in self.index[name]:
            ov = []
            for s, o, c in zip(index, offs, cshape):
                lo, hi = max(s.start, o), min(s.stop, o + c)
                if lo >= hi:
                    ov = None
                    break
                ov.append((lo, hi, o))
            if ov is None:
                continue
            data = f[key]
            if out is None:
                out = np.empty(out_shape, data.dtype)
            out[tuple(slice(lo - s.start, hi - s.start)
                      for (lo, hi, _), s in zip(ov, index))] = \
                data[tuple(slice(lo - o, hi - o) for lo, hi, o in ov)]
            filled += int(np.prod([hi - lo for lo, hi, _ in ov]))
        if out is None or filled < int(np.prod(out_shape)):
            raise ValueError(f"the checkpoint's chunks do not cover "
                             f"{name}{list(index)}")
        return out

    def read_global(self, name):
        return self.read_slice(name, tuple(slice(0, s)
                                           for s in self.shape(name)))


def _index(pmesh, shape):
    if pmesh is None or len(shape) < 3:
        return tuple(slice(0, s) for s in shape)
    from ..parallel.topo import local_slices
    return local_slices(pmesh, shape)


def restore_sharded(manifest_path, state, dtype=None, pmesh=None):
    """Load a per-shard checkpoint into a state of this rank's blocks on
    `pmesh` (None: one process, the whole fields), `state` giving the
    device, the dtypes and the history's structure. Each rank reads the
    chunks overlapping its blocks. Returns (state, timestep, time, dt,
    stats), stats as numpy blocks."""
    reader = ChunkReader(manifest_path)
    m = reader.manifest
    device = state["u"].device
    dtype = dtype or state["u"].dtype

    def read(name, dt_=None):
        a = reader.read_slice(name, _index(pmesh, reader.shape(name)))
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dt_ or dtype)

    names = reader.names()
    new = dict(state)
    for k in ("u", "v", "w", "phi"):
        if k in names and k in new:
            new[k] = read(k)
    if "olds" in state and "n_olds_vars" in m.files:
        def odt(i):
            # the live history's precision (bfloat16 under X3D2_BF16_OLDS:
            # archived float32, cast back exactly)
            o = state["olds"][i] if i < len(state["olds"]) else ()
            return o[0].dtype if len(o) else dtype
        new["olds"] = tuple(
            tuple(read(f"olds_{i}_{j}", odt(i)) for j in sorted(
                int(nm.split("_")[2]) for nm in names
                if nm.startswith(f"olds_{i}_")))
            for i in range(int(m["n_olds_vars"])))
    if "comp" in state:
        new["comp"] = tuple(
            read(f"comp_{i}") if f"comp_{i}" in names
            else torch.zeros_like(state["comp"][i])
            for i in range(len(state["comp"])))
    if "rng" in state and _rng_key(state["rng"]) in m.files:
        new["rng"].set_state(torch.as_tensor(np.array(
            m[_rng_key(state["rng"])])))
    stats = {nm[len("stats_"):]: reader.read_slice(
        nm, _index(pmesh, reader.shape(nm)))
        for nm in sorted(names) if nm.startswith("stats_")}
    timestep = int(m["timestep"])
    new["istep"] = timestep + 1
    return new, timestep, float(m["time"]), float(m["dt"]), stats


def cleanup_sharded(prefix, keep_manifest, rank=None):
    """Remove the per-shard checkpoint files of `prefix` but those of
    `keep_manifest`, once every rank's files of it are durable: with
    `rank`, that rank's own shard files (and on rank 0 the manifests), so
    that ranks without a shared directory each clean their own; without,
    every file (one process)."""
    keep_base = keep_manifest[:-len(".manifest.npz")]
    mine = r"shards\d+" if rank is None else f"shards{rank:04d}"
    kinds = (f"manifest|{mine}" if rank in (None, 0) else mine)
    pat = re.compile(re.escape(prefix) + rf"_\d+\.({kinds})\.npz$")
    for f in glob.glob(f"{prefix}_*.npz"):
        if pat.search(f) and not f.startswith(keep_base + "."):
            os.remove(f)
