"""Process-mesh decomposition and the sharded step on torch.distributed
(counterpart of x3d2_tpu.parallel)."""

from .topo import (ProcessMesh, field_spec, gather_state, local_slices,
                   make_process_mesh, make_sharded_step, shard_state)

__all__ = ["ProcessMesh", "field_spec", "gather_state", "local_slices",
           "make_process_mesh", "make_sharded_step", "shard_state"]
