"""Data parallelism over ``torch.distributed``: the plan, placement and
collectives (``mesh``) and the multi-process launcher (``launch``)."""

from weather_unet_tpu_torch.parallel.mesh import (
    make_mesh, batch_sharding, replicated_sharding, shard_batch, MeshPlan,
)
