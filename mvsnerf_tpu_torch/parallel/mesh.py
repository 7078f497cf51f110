"""Process groups and device meshes (counterpart of
mvsnerf_tpu/parallel/mesh.py).

A rank is one process with one device: NCCL between cards, gloo between
CPU processes (the tests). The workload scales over rays x samples and the
model is under 2 MB, so, as in JAX, a mesh is 1-D over rays, or 2-D
(data x rays) across nodes with `data` outermost: the ranks of one node
form a rays group, and a reduction over both axes is one over the world.

Launch (one process per card):

    torchrun --nproc_per_node 4 -m mvsnerf_tpu_torch.train_mvs_nerf ...
    python -m mvsnerf_tpu_torch.train_mvs_nerf --num_devices 4 ...

    # in code:
    from mvsnerf_tpu_torch.parallel import init_distributed, make_mesh
    init_distributed()            # a no-op in a single process
    mesh = make_mesh()            # rays = every rank

JAX's `local_mesh(n)` (a mesh over the first n devices of one process)
has no counterpart: a torch rank drives one device, and the ranks of one
node are torchrun's `--nproc_per_node`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

RAY_AXIS = "rays"
DATA_AXIS = "data"


def init_distributed(init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None,
                     local_rank: int | None = None, device="cuda",
                     backend: str | None = None) -> bool:
    """Join the default process group (replaces `jax.distributed.
    initialize`, JAX mesh.py:41-68).

    Without `init_method` it reads torchrun's RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR and MASTER_PORT, and is a no-op returning False in a single
    process (no WORLD_SIZE, or WORLD_SIZE 1), so entry points may call it
    unconditionally. With an explicit `init_method` (`file://...` or
    `tcp://host:port`), `rank` and `world_size` it joins that group, at
    world size 1 too. Safe to call twice: True once a group exists.

    `device` "cuda" takes NCCL and sets the process's card to `local_rank`
    (LOCAL_RANK, else the rank); "cpu" takes gloo. `backend` overrides the
    choice (gloo on a card all-reduces through the host)."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if world_size is None and "WORLD_SIZE" in os.environ:
            world_size = int(os.environ["WORLD_SIZE"])
        if not world_size or world_size <= 1:
            return False
        if rank is None:
            rank = int(os.environ["RANK"])
        init_method = "env://"
    elif rank is None or world_size is None:
        raise ValueError("init_distributed: an explicit init_method needs "
                         "rank and world_size")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(local_rank)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return True


def _device_type(device_type):
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _require_group(what):
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs a process group: call "
                           "init_distributed first (or launch with "
                           "torchrun)")


def make_mesh(device_type: str | None = None, axis_name: str = RAY_AXIS):
    """1-D mesh over every rank (JAX mesh.py:71-76), on
    `init_device_mesh`. `device_type` defaults to the backend's: cuda for
    NCCL, cpu for gloo."""
    from torch.distributed.device_mesh import init_device_mesh
    _require_group("make_mesh")
    return init_device_mesh(_device_type(device_type),
                            (dist.get_world_size(),),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(n_data: int | None = None, device_type: str | None = None,
                 axis_names: tuple[str, str] = (DATA_AXIS, RAY_AXIS)):
    """2-D (data x rays) mesh, `data` outermost (JAX mesh.py:87-102).
    `n_data` defaults to the number of nodes (world size over torchrun's
    LOCAL_WORLD_SIZE; 1 without it), so each node's ranks form one rays
    group. Raises when it does not divide the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    _require_group("make_mesh_2d")
    n = dist.get_world_size()
    if n_data is None:
        n_data = max(n // int(os.environ.get("LOCAL_WORLD_SIZE", n)), 1)
    if n % n_data:
        raise ValueError(f"{n} ranks not divisible by data axis {n_data}")
    return init_device_mesh(_device_type(device_type), (n_data, n // n_data),
                            mesh_dim_names=tuple(axis_names))


def axis_group(mesh, axis_name=RAY_AXIS):
    """(process group, number of ranks, this rank's flat index) over the
    mesh axes named (one name or a tuple), the index running as JAX's
    `axis_index` over several axes (JAX sharding.py:74-77). With no mesh:
    the whole world when a process group exists (the default group,
    None), else (None, 1, 0), one process and no collectives."""
    if mesh is None:
        if not dist.is_initialized():
            return None, 1, 0
        return None, dist.get_world_size(), dist.get_rank()
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    names = mesh.mesh_dim_names
    size, index = 1, 0
    for ax in axes:
        dim = names.index(ax)
        size *= mesh.size(dim)
        index = index * mesh.size(dim) + mesh.get_local_rank(dim)
    if len(axes) == 1:
        return mesh.get_group(names.index(axes[0])), size, index
    if sorted(axes) != sorted(names) or size != dist.get_world_size():
        raise NotImplementedError(
            f"a reduction over {axes} of a mesh {names} that is not the "
            "whole world")
    return None, size, index


def is_main_rank() -> bool:
    """True in rank 0 of the world, or without a process group: the rank
    that logs, writes snapshots and validates."""
    return not dist.is_initialized() or dist.get_rank() == 0
