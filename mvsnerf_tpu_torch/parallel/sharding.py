"""Ray-sharded rendering and data-parallel training over torch.distributed
ranks (counterpart of mvsnerf_tpu/parallel/sharding.py).

Parameters and the encoding volume are replicated on every rank (under
2 MB plus the volume); the ray axis is split into contiguous slices, one a
rank, rendered with no communication and gathered at the end; a training
step averages its gradients over the ranks. What replaces each JAX
construct:

- `shard_map` over the ray axis: each rank slices its rays, and
  `all_gather_into_tensor` puts the full output on every rank;
- `pmean` of the gradients (and of the loss and its parts): one
  coalesced all-reduce of a flat buffer, the sum over the ranks divided
  by their number; at one rank every value is copied back unchanged;
- `fold_in(key, axis_index)`: a generator a rank, seeded by `rank_seed`,
  which leaves rank 0's seed as it is;
- the replicated `device_put`: `replicate`, a broadcast from rank 0.

The step runs its own all-reduce, not `DistributedDataParallel`: K7 and K8
read the MLP's weights inside `torch.autograd.Function`s, outside the
wrapper's `forward`, and at world size 1 the step must stay bit-identical
to the single-process one.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist

from .mesh import RAY_AXIS, axis_group


# an odd 64-bit constant (2**64 / the golden ratio) whose low 32 bits are
# odd too: the CPU generator (mt19937) reads only the seed's low 32 bits
_SEED_STRIDE = 0x9E3779B97F4A7C15


def rank_seed(seed: int, index: int) -> int:
    """The generator seed of shard `index` for the step seed `seed`
    (replaces `jax.random.fold_in(key, index)`): `seed` itself at index 0,
    so one rank draws what a single process draws. The shards of one step
    differ in the low 32 bits, which are all the CPU generator reads; with
    up to 64 shards, a shard's seed meets another shard's at another step
    only 23.8M steps apart."""
    if seed < 0 or index < 0:
        raise ValueError(f"rank_seed: seed {seed}, index {index}")
    return (seed + index * _SEED_STRIDE) % 2 ** 64


def replicate(modules, mesh=None):
    """Broadcast every parameter and buffer of `modules` (a module or a
    list of them) from the mesh's first rank, in place (replaces JAX
    sharding.py:21-24). Returns `modules`."""
    if not dist.is_initialized():
        return modules
    group = axis_group(mesh, mesh.mesh_dim_names if mesh is not None
                       else RAY_AXIS)[0]
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for module in (modules if isinstance(modules, (list, tuple))
                   else [modules]):
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src, group=group)
    return modules


def _shard(t, size, index):
    n = t.shape[0]
    if n % size:
        raise ValueError(f"{n} rays not divisible by the mesh's {size} "
                         "ranks (pad upstream)")
    m = n // size
    return t[index * m:(index + 1) * m]


def shard_rays_render(render_fn, mesh=None, n_ray_args: int = 1,
                      axis_name=RAY_AXIS):
    """Wrap a per-ray render function so that each rank renders its
    contiguous slice of the leading ray axis of the first `n_ray_args`
    arguments (the rest are passed whole: MLP, volume, images, cameras),
    and every rank returns the full output: a tensor, or a dict of them,
    gathered key by key with `all_gather_into_tensor` (JAX
    sharding.py:27-48). A ray count that does not divide by the ranks
    raises, as JAX's shard_map does."""
    def wrapped(*args):
        group, size, index = axis_group(mesh, axis_name)
        n = args[0].shape[0]
        if any(a.shape[0] != n for a in args[:n_ray_args]):
            raise ValueError("shard_rays_render: ray arguments of different "
                             "lengths")
        rays = [_shard(a, size, index) for a in args[:n_ray_args]]
        out = render_fn(*rays, *args[n_ray_args:])
        if not dist.is_initialized():
            return out

        def gather(t):
            full = t.new_empty((n, *t.shape[1:]))
            with warnings.catch_warnings():  # renamed in newer torch
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(full, t.contiguous(), group=group)
            return full

        if isinstance(out, dict):
            return {k: gather(v) for k, v in out.items()}
        return gather(out)

    return wrapped


def allreduce_mean(params, mesh=None, axis_name=RAY_AXIS, scalars=()):
    """The mean over the ranks of the mesh axes named of the gradients of
    `params` and of `scalars` (0-d tensors: the loss and its parts), in
    one coalesced all-reduce: everything is flattened into one buffer,
    summed and divided by the number of ranks, and the gradients are
    written back in place (replaces `jax.lax.pmean`, JAX
    sharding.py:79-81, generalizable.py:179-185). Parameters without a
    gradient take no part. Without a process group nothing is reduced.
    Returns (the averaged scalars, the bytes all-reduced)."""
    group, size, _ = axis_group(mesh, axis_name)
    grads = [p.grad for p in params if p.grad is not None]
    scalars = [s.detach().reshape(1) for s in scalars]
    if not dist.is_initialized():
        return [s[0] for s in scalars], 0
    flat = torch.cat([t.reshape(-1) for t in grads + scalars])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(size)
    parts = flat.split([t.numel() for t in grads + scalars])
    for g, part in zip(grads, parts):
        g.copy_(part.view_as(g))
    return [p[0] for p in parts[len(grads):]], \
        flat.numel() * flat.element_size()


def data_parallel_step(loss_fn, optimizer, mesh=None, axis_name=RAY_AXIS,
                       has_aux: bool = False):
    """A data-parallel train step (JAX sharding.py:51-93): the batch's
    leading axis is split over the ranks of the mesh axes named (one name,
    or a tuple such as `mesh.mesh_dim_names` for a 2-D mesh), each rank
    takes its slice's loss with its own generator, and after `backward()`
    one coalesced all-reduce averages the gradients (`allreduce_mean`)
    before the optimizer steps. Parameters and optimizer state stay
    replicated because every rank applies the same averaged update.

    Args:
        loss_fn: fn(batch, generator) -> scalar loss, or (loss, {name:
            scalar}) with `has_aux`; `batch` is this rank's slice.
        optimizer: a torch optimizer over the replicated parameters.
    Returns:
        step(batch, seed) -> the loss averaged over the ranks (and the
        averaged aux dict with `has_aux`). `batch` is a dict of tensors
        with the global batch on the leading axis; the rank's generator
        lives on their device, seeded `rank_seed(seed, index)`.
    """
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def step(batch, seed: int):
        _, size, index = axis_group(mesh, axis_name)
        shard = {k: _shard(v, size, index) for k, v in batch.items()}
        device = next(iter(batch.values())).device
        gen = torch.Generator(device=device).manual_seed(
            rank_seed(seed, index))
        out = loss_fn(shard, gen)
        loss, aux = out if has_aux else (out, {})
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        (loss, *parts), _ = allreduce_mean(params, mesh, axis_name,
                                           [loss, *aux.values()])
        optimizer.step()
        aux = dict(zip(aux, parts))
        return (loss, aux) if has_aux else loss

    return step
