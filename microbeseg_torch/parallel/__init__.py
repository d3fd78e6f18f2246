from microbeseg_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    get_mesh,
    pad_batch_to_devices,
    replicated_sharding,
)
