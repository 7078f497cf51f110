"""Data-parallel training and ray-sharded rendering over
`torch.distributed` ranks (counterpart of mvsnerf_tpu/parallel/)."""

from .mesh import (DATA_AXIS, RAY_AXIS, axis_group, init_distributed,
                   is_main_rank, make_mesh, make_mesh_2d)
from .sharding import (allreduce_mean, data_parallel_step, rank_seed,
                       replicate, shard_rays_render)
