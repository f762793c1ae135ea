from .mesh import (  # noqa: F401
    Mesh,
    MeshCfg,
    initialize_multihost,
    make_mesh,
    replicate,
    shard_batch,
    shard_train_step,
)
