"""Data parallelism: the mesh (``mesh.py``), the global-batch reductions
(``collectives.py``) and the start of local ranks (``launch.py``)."""

from pointcloududa_torch.parallel.mesh import (
    Mesh,
    create_mesh,
    init_distributed,
    mesh_is_multiprocess,
    pad_batch,
    process_row_slice,
    replicate,
    shard_batch,
    trainer_row_shard,
)

__all__ = [
    "Mesh",
    "create_mesh",
    "init_distributed",
    "mesh_is_multiprocess",
    "pad_batch",
    "process_row_slice",
    "replicate",
    "shard_batch",
    "trainer_row_shard",
]
