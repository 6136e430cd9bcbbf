"""IO manager facade (counterpart of x3d2_tpu.io.manager; reference
src/io/io_manager.f90:22-36): init / handle_restart / update_stats /
handle_io_step / finalise. On a process mesh the case is the sharded
step's working case (``case.pmesh`` set, parallel/topo.py), the state the
rank's blocks, and every rank calls each method."""

from __future__ import annotations

from ..config import CheckpointConfig, StatsConfig
from ..parallel.topo import local_slices, shard_state
from . import native
from .checkpoint import CheckpointManager
from .snapshot import SnapshotManager
from .stats import StatsManager


class IOManager:
    def __init__(self, case, checkpoint_cfg: CheckpointConfig | None = None,
                 stats_cfg: StatsConfig | None = None, verbose=None):
        self.case = case
        verbose = case.monitor.verbose if verbose is None else verbose
        self.checkpoint_cfg = checkpoint_cfg or CheckpointConfig()
        self.stats_cfg = stats_cfg or StatsConfig()
        self.pmesh = getattr(case, "pmesh", None)
        self.checkpoint_mgr = CheckpointManager(
            self.checkpoint_cfg, verbose, pmesh=self.pmesh, mesh=case.mesh)
        self.snapshot_mgr = SnapshotManager(case, self.checkpoint_cfg,
                                            verbose)
        self.stats_mgr = StatsManager(case, self.stats_cfg, verbose)

    def handle_restart(self, state):
        """Restore from checkpoint when configured
        (io_manager handle_restart -> checkpoint_manager restart path). On
        a mesh a per-shard checkpoint restores onto the rank's blocks
        directly, and a global one is read whole and cut to them
        (shard_state, x3d2_tpu __main__.py:119-122)."""
        if not self.checkpoint_cfg.restart_from_checkpoint:
            return state
        block = tuple(state["u"].shape)
        state, timestep, time, dt, stats = self.checkpoint_mgr.restore(state)
        if tuple(state["u"].shape) != block:
            # a global file on a mesh: the restored fields cut to the block
            # (p is the template's block)
            restored = {k: state[k] for k in ("u", "v", "w", "phi", "olds",
                                              "comp") if k in state}
            state = dict(state, **shard_state(self.pmesh, restored))
            stats = {k: v[local_slices(self.pmesh, v.shape)] if v.ndim >= 3
                     else v for k, v in stats.items()}
        self.stats_mgr.restore(stats)
        return state

    def update_stats(self, state, timestep):
        self.stats_mgr.update(state, timestep)

    def handle_io_step(self, state, timestep, time):
        if self.stats_mgr.should_write(timestep):
            self.stats_mgr.write(timestep)
        if self.snapshot_mgr.should_snapshot(timestep):
            self.snapshot_mgr.write(state, timestep, time)
        if self.checkpoint_mgr.should_checkpoint(timestep):
            self.checkpoint_mgr.write(
                state, timestep, time, self.case.dt,
                stats=self.stats_mgr.checkpoint_state(
                    gather=not self.checkpoint_mgr.sharded_io()))

    def finalise(self, state, timestep, time):
        if (self.stats_mgr.is_active and self.stats_mgr.acc is not None
                and self.stats_cfg.istatout > 0
                and timestep != self.stats_mgr.last_written):
            self.stats_mgr.write(timestep)
        native.async_flush()  # all queued checkpoint writes durable
