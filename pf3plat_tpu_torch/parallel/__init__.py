from .mesh import (  # noqa: F401
    Mesh,
    MeshCfg,
    broadcast_from_rank0,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
    shard_train_step,
)
