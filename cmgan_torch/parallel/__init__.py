from cmgan_torch.parallel.mesh import (
    Mesh,
    attach,
    init_from_env,
    is_writer,
    make_mesh,
    replicate_state,
    shard_batch,
)

__all__ = [
    "Mesh",
    "attach",
    "init_from_env",
    "is_writer",
    "make_mesh",
    "replicate_state",
    "shard_batch",
]
