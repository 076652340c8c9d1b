"""Data, tensor and spatial parallelism over ``torch.distributed``: the
plan, placement and collectives (``mesh``), the multi-process launcher
(``launch``), the Megatron split of the double convs (``tp``) and the
height split of the images (``spatial``)."""

from weather_unet_tpu_torch.parallel.mesh import (
    make_mesh, batch_sharding, replicated_sharding, shard_batch, MeshPlan,
)
