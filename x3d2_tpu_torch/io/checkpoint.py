"""Checkpoint/restart manager.

Counterpart of x3d2_tpu.io.checkpoint (reference
src/io/checkpoint_manager.f90), in x3d2_tpu's single-``.npz`` format
(checkpoint.py:52-117), so that either package restores the other's file:
  - u, v, w (+ the stacked species phi), timestep/time/dt;
  - the AB history ``olds_i`` per field, stacked (nolds, ...), with
    ``n_olds_vars``; a bfloat16 history is archived as float32 (the
    widening is exact) and cast back to the live history's dtype on
    restore, which gives back its bits;
  - the Kahan compensation ``comp_i`` and running statistics ``stats_*``;
  - the old-checkpoint cleanup unless keep_checkpoint, and ``latest()``;
  - restore resumes at timestep + 1 (:346-501).
x3d2_tpu's JAX PRNG ``key`` is read and dropped (as convert.py drops it);
the port saves the state of its ``torch.Generator`` under
``torch_rng_<device type>`` (the CPU and CUDA generators keep different
states), a key x3d2_tpu's restore does not read. The write serialises on
the main thread, after every field has been copied to the host (so the
next step may write over the state's buffers), and hands the bytes to the
native background writer (temporary file, then rename).

On a process mesh (``pmesh``, the run's parallel.topo.ProcessMesh, and
``mesh``, the case's Mesh) the state holds the rank's blocks. Per-shard
files (io/sharded.py) are written where the config's ``sharded_io`` says
so, and by default with more than one process (x3d2_tpu
checkpoint.py:40-50); the global file is otherwise gathered (collective)
and written by rank 0 alone. ``restore`` reads a manifest shard-locally
onto the rank's blocks, and a global file whole (IOManager.handle_restart
then cuts it to the rank's blocks).
"""

from __future__ import annotations

import glob
import io
import os

import numpy as np
import torch

from . import native
from .sharded import (_host, _rng_key, cleanup_sharded, restore_sharded,
                      write_sharded)
from ..parallel import multihost


class CheckpointManager:
    def __init__(self, config, verbose=True, pmesh=None, mesh=None):
        self.config = config
        self.verbose = verbose
        self.pmesh, self.mesh = pmesh, mesh

    def _fname(self, timestep):
        return f"{self.config.checkpoint_prefix}_{timestep:06d}.npz"

    def should_checkpoint(self, timestep) -> bool:
        f = self.config.checkpoint_freq
        return f > 0 and timestep % f == 0

    def sharded_io(self) -> bool:
        """Per-shard files where the config says so; by default with more
        than one process (x3d2_tpu checkpoint.py:40-50)."""
        cfg = getattr(self.config, "sharded_io", None)
        if cfg is not None:
            return bool(cfg)
        return self.pmesh is not None and self.pmesh.size > 1

    def write(self, state, timestep, time, dt, stats=None):
        """Write the checkpoint of `state` at `timestep` (on a mesh every
        rank calls it). The history is stored where a field has one
        (AB2-4; x3d2_tpu's RK states carry none, and its AB1 files
        zero-length ones, which either package's restore reads as none).
        `stats`: the statistics' accumulators (StatsManager.
        checkpoint_state)."""
        if self.sharded_io():
            path = write_sharded(self.config.checkpoint_prefix, timestep,
                                 state, time, dt, stats, self.pmesh,
                                 self.mesh)
            if self.verbose:
                print(f"Checkpoint written (sharded): {path}")
            if not self.config.keep_checkpoint:
                # every rank's files durable before any rank removes its
                # older ones: a complete checkpoint is always on disk
                native.async_flush()
                rank = None
                if self.pmesh is not None and self.pmesh.size > 1:
                    torch.distributed.barrier(
                        group=self.pmesh.groups["world"])
                    rank = self.pmesh.rank
                cleanup_sharded(self.config.checkpoint_prefix, path, rank)
            return path

        def host(t):
            # collective on a mesh: every rank gathers, rank 0 writes
            if torch.is_tensor(t):
                t = multihost.gather_global(t, self.pmesh, self.mesh)
            return _host(t)

        arrays = {}
        for k in ("u", "v", "w", "phi"):
            if k in state:
                arrays[k] = host(state[k])
        olds = state.get("olds", ())
        if any(len(o) for o in olds):
            # olds[i] is a (nolds,)-tuple per field, stored stacked
            for i, o in enumerate(olds):
                arrays[f"olds_{i}"] = (np.stack([host(a) for a in o])
                                       if len(o) else np.zeros((0,)))
            arrays["n_olds_vars"] = np.asarray(len(olds))
        if "comp" in state:
            for i, c in enumerate(state["comp"]):
                arrays[f"comp_{i}"] = host(c)
        if "rng" in state:
            arrays[_rng_key(state["rng"])] = state["rng"].get_state().numpy()
        arrays["timestep"] = np.asarray(timestep)
        arrays["time"] = np.asarray(time)
        arrays["dt"] = np.asarray(dt)
        if stats is not None:
            for k, v in stats.items():
                arrays[f"stats_{k}"] = host(v)
        fname = self._fname(timestep)
        if not multihost.is_primary():
            return fname
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        del arrays
        view = buf.getbuffer()
        native.async_write(fname, view)
        del view
        if self.verbose:
            print(f"Checkpoint written: {fname}")
        if not self.config.keep_checkpoint:
            native.async_flush()
            self._cleanup(keep=fname)
        return fname

    def _cleanup(self, keep):
        for f in glob.glob(f"{self.config.checkpoint_prefix}_*.npz"):
            if f != keep:
                os.remove(f)

    def latest(self):
        native.async_flush()  # queued checkpoints durable first
        files = sorted(f for f in
                       glob.glob(f"{self.config.checkpoint_prefix}_*.npz")
                       if ".shards" not in f)
        return files[-1] if files else None

    def restore(self, state, path=None, dtype=None):
        """Load a checkpoint into an existing state (the case's
        initial_state(), or on a mesh the rank's blocks of it, whose tensors
        give the device, the dtypes and the history's structure). Returns
        (state, timestep, time, dt, stats): from a manifest the rank's
        blocks, from a global file the whole fields."""
        native.async_flush()
        path = path or self.config.restart_file or self.latest()
        if not path or not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint found at {path!r}")
        if path.endswith(".manifest.npz"):
            out = restore_sharded(path, state, dtype=dtype, pmesh=self.pmesh)
            if self.verbose:
                print(f"Restart from {path} at iteration {out[1]}")
            return out
        device = state["u"].device
        dtype = dtype or state["u"].dtype

        def t(a, dt_=None):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=device, dtype=dt_ or dtype)

        with np.load(path) as z:
            new = dict(state)
            for k in ("u", "v", "w", "phi"):
                if k in z and k in new:
                    new[k] = t(z[k])
            if "olds" in state and "n_olds_vars" in z:
                def odt(i):
                    # the live history's precision (bfloat16 under
                    # X3D2_BF16_OLDS: archived float32, cast back exactly)
                    o = state["olds"][i] if i < len(state["olds"]) else ()
                    return o[0].dtype if len(o) else dtype
                # separate tensors per slot, so the rotation never aliases
                stacked = [z[f"olds_{i}"]
                           for i in range(int(z["n_olds_vars"]))]
                new["olds"] = tuple(tuple(t(a, odt(i)) for a in arr)
                                    for i, arr in enumerate(stacked))
            if "comp" in state:
                new["comp"] = tuple(
                    t(z[f"comp_{i}"]) if f"comp_{i}" in z
                    else torch.zeros_like(state["comp"][i])
                    for i in range(len(state["comp"])))
            if "rng" in state and _rng_key(state["rng"]) in z.files:
                new["rng"].set_state(torch.as_tensor(
                    np.array(z[_rng_key(state["rng"])])))
            timestep = int(z["timestep"])
            new["istep"] = timestep + 1
            stats = {k[len("stats_"):]: np.array(z[k]) for k in z.files
                     if k.startswith("stats_")}
            time, dt = float(z["time"]), float(z["dt"])
        if self.verbose:
            print(f"Restart from {path} at iteration {timestep}")
        return new, timestep, time, dt, stats
