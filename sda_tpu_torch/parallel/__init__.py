r"""Scale-out over ``torch.distributed``: meshes, data parallelism, sequence
parallelism."""

from .mesh import (  # noqa: F401
    batch_constraint,
    host_sharded_array,
    init_multihost,
    make_mesh,
    replicate,
    shard_batch,
)
from .windowed import ShardedMCScoreNet  # noqa: F401
