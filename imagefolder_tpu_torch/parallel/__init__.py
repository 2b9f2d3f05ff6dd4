from imagefolder_tpu_torch.parallel.dist import (
    init_distributed,
    process_allgather,
    sync_global_devices,
)
from imagefolder_tpu_torch.parallel.mesh import (
    fsdp_shard_params,
    make_mesh,
    replicate,
    shard_batch,
    tp_shard_params,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "fsdp_shard_params",
           "tp_shard_params",
           "init_distributed", "sync_global_devices", "process_allgather"]
