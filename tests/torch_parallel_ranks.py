"""The rank side of tests/test_torch_parallel.py: `run_rank` runs in each
of the processes `torch.multiprocessing.spawn` starts (gloo on the CPU,
a `file://` store), runs every case and saves its results for the test
functions to assert. It imports torch and the port only: the ranks never
load JAX."""

import numpy as np
import torch

TOY_SEED, TOY_N, TOY_IN, TOY_HID, TOY_OUT = 21, 32, 6, 16, 3
SGD_LR = 0.1
RENDER_RAYS, RENDER_SAMPLES = 64, 8
GEN_HW, GEN_PAD, GEN_SAMPLES, GEN_BATCH, GEN_SEED = 32, 4, 8, 64, 3


def toy_problem():
    """(params, batch) of the toy regression, numpy, from TOY_SEED."""
    rng = np.random.default_rng(TOY_SEED)
    params = {"w1": rng.normal(0, 0.5, (TOY_IN, TOY_HID)),
              "b1": rng.normal(0, 0.1, (TOY_HID,)),
              "w2": rng.normal(0, 0.5, (TOY_HID, TOY_OUT))}
    batch = {"x": rng.normal(0, 1, (TOY_N, TOY_IN)),
             "y": rng.normal(0, 1, (TOY_N, TOY_OUT))}
    cast = {k: v.astype(np.float32) for k, v in params.items()}
    return cast, {k: v.astype(np.float32) for k, v in batch.items()}


def render_inputs():
    """The ray-sharded render's inputs (numpy, seeded): a random volume,
    samples in front of 3 cameras on an arc, NDC in [0, 1], images."""
    rng = np.random.default_rng(5)
    intr = np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]], np.float32)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    w2cs[:, 0, 3] = [-0.1, 0.0, 0.1]
    z = np.sort(rng.uniform(2, 6, (RENDER_RAYS, RENDER_SAMPLES)), -1)
    dirs = np.concatenate([rng.uniform(-0.3, 0.3, (RENDER_RAYS, 2)),
                           np.ones((RENDER_RAYS, 1))], -1)
    out = dict(pts_world=dirs[:, None] * z[..., None],
               pts_ndc=rng.uniform(0, 1, (RENDER_RAYS, RENDER_SAMPLES, 3)),
               z_vals=z, rays_dir=dirs,
               volume=rng.standard_normal((8, 12, 12, 8)), w2c=np.eye(4),
               w2cs=w2cs, intrinsics=np.stack([intr] * 3),
               imgs=rng.uniform(0, 1, (3, 16, 16, 3)))
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in
            out.items()}


def generalizable_sample(seed=9, n_views=4, hw=GEN_HW):
    """A generalizable batch of MVSDatasetDTU's shape: views on an arc,
    the target last, GT depths with holes (as in
    tests/test_torch_generalizable.py)."""
    from mvsnerf_tpu_torch.data.common import normalize_imagenet
    rng = np.random.default_rng(seed)
    intr = np.array([[40.0, 0, hw / 2], [0, 40.0, hw / 2], [0, 0, 1]],
                    np.float32)
    w2cs = []
    for i in range(n_views):
        a = 0.08 * (i - n_views / 2)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.15 * (i - n_views / 2), 0, 0]
        w2cs.append(m)
    w2cs = np.stack(w2cs)
    intr_s4 = intr.copy()
    intr_s4[:2] /= 4
    p4 = np.tile(np.eye(4, dtype=np.float32), (n_views, 1, 1))
    p4[:, :3] = intr_s4 @ w2cs[:, :3]
    depths = rng.uniform(2.0, 6.0, (n_views, hw, hw))
    depths[rng.uniform(size=depths.shape) < 0.3] = 0.0
    return {
        "images": normalize_imagenet(
            rng.uniform(0.2, 0.8, (n_views, hw, hw, 3))).astype(np.float32),
        "proj_mats": (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32),
        "near_fars": np.tile(np.float32([2.0, 6.0]), (n_views, 1)),
        "w2cs": w2cs, "c2ws": np.linalg.inv(w2cs).astype(np.float32),
        "intrinsics": np.stack([intr] * n_views),
        "depths_h": depths.astype(np.float32)}


def generalizable_args(batch_size=GEN_BATCH):
    from mvsnerf_tpu_torch.config import config_parser
    return config_parser(
        f"--dataset_name dtu --pad {GEN_PAD} --N_samples {GEN_SAMPLES} "
        f"--batch_size {batch_size} --with_depth_loss --lrate 5e-4")


def toy_loss(params):
    """loss_fn(batch, generator) of the toy regression over `params`."""
    def loss_fn(batch, generator):
        h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
        return torch.mean((h @ params["w2"] - batch["y"]) ** 2)
    return loss_fn


def _toy_step(mesh, axis_name):
    from mvsnerf_tpu_torch.parallel import data_parallel_step
    p0, batch = toy_problem()
    params = {k: torch.nn.Parameter(torch.from_numpy(v))
              for k, v in p0.items()}
    opt = torch.optim.SGD(params.values(), lr=SGD_LR)
    step = data_parallel_step(toy_loss(params), opt, mesh, axis_name)
    loss = step({k: torch.from_numpy(v) for k, v in batch.items()}, 7)
    return {"loss": float(loss),
            "params": {k: v.detach().clone() for k, v in params.items()}}


class Recorder:
    """A logger that keeps what `fit` logs."""

    def __init__(self):
        self.rows = []

    def log_scalars(self, step, scalars):
        self.rows.append((step, dict(scalars)))


def _generalizable(mesh, sample, batch_size=GEN_BATCH, steps=2):
    """`fit` over `steps` steps: the gradients that reach Adam at the
    first step, the logged rows, the losses and the first and last
    states."""
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    system = GeneralizableSystem(generalizable_args(batch_size),
                                 device="cpu", mesh=mesh)
    first = {}
    adam_step = system.optimizer.step

    def recording_step(*a, **kw):
        if not first:
            first.update({f"{m}.{n}": p.grad.clone() for m, mod in
                          (("mlp", system.mlp), ("mvsnet", system.mvsnet))
                          for n, p in mod.named_parameters()})
        return adam_step(*a, **kw)

    system.optimizer.step = recording_step

    def state():
        return {f"{m}.{k}": v.clone() for m, mod in
                (("mlp", system.mlp), ("mvsnet", system.mvsnet))
                for k, v in mod.state_dict().items()}

    state0 = state()
    logger = Recorder()
    losses = system.fit([sample], num_epochs=steps, logger=logger,
                        seed=GEN_SEED, max_steps=steps, log_every=1)
    return {"grads": first, "rows": logger.rows, "losses": losses,
            "state0": state0, "state": state()}


def run_rank(rank, world, init_method, init_method_1, out_dir):
    """Every case on this rank; results saved to out_dir/rank<r>.pt."""
    import torch.distributed as dist
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.parallel import (init_distributed, make_mesh,
                                            make_mesh_2d, shard_rays_render)
    from mvsnerf_tpu_torch.render.renderer import render_rays

    torch.set_num_threads(1)
    assert init_distributed(init_method, rank, world, device="cpu")
    assert init_distributed()  # a second call keeps the group
    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    mesh = make_mesh()
    out["toy_1d"] = _toy_step(mesh, "rays")
    mesh2 = make_mesh_2d(n_data=2)
    out["mesh2_shape"] = tuple(mesh2.mesh.shape)
    out["toy_2d"] = _toy_step(mesh2, mesh2.mesh_dim_names)

    inp = render_inputs()
    torch.manual_seed(0)
    mlp = MVSNeRF()

    def render(pw, pn, zv, rd, *rest):
        return render_rays(mlp, inp["volume"], pw, pn, zv, rd, *rest,
                           twins=True)

    with torch.no_grad():
        rest = (inp["w2c"], inp["w2cs"], inp["intrinsics"], inp["imgs"])
        rays = (inp["pts_world"], inp["pts_ndc"], inp["z_vals"],
                inp["rays_dir"])
        out["render_sharded"] = shard_rays_render(render, mesh, 4)(*rays,
                                                                  *rest)
        out["render_single"] = render(*rays, *rest)
        try:
            shard_rays_render(render, mesh, 4)(*(r[:-1] for r in rays),
                                              *rest)
        except ValueError as e:
            out["render_indivisible"] = str(e)

    sample = generalizable_sample()
    out["gen"] = _generalizable(mesh, sample)
    dist.destroy_process_group()

    if rank == 0:  # world size 1 through the data-parallel path
        assert init_distributed(init_method_1, 0, 1, device="cpu")
        out["ws1_dp"] = _generalizable(make_mesh(), sample, steps=3)
        dist.destroy_process_group()
        out["ws1_plain"] = _generalizable(None, sample, steps=3)
    torch.save(out, f"{out_dir}/rank{rank}.pt")
