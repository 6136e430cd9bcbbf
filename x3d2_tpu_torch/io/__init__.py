from .checkpoint import CheckpointManager
from .manager import IOManager
from .monitoring import Monitor, make_observables_fn
from .reader import SnapshotReader, StatsReader
from .snapshot import SnapshotManager
from .stats import StatsManager
