"""The port's parallel/ (data-parallel training and the ray-sharded render)
on the CPU: one `torch.multiprocessing.spawn` of 4 gloo ranks for the file
(a module fixture, a `file://` store under tmp_path, no fixed port), in
which every rank runs every case of tests/torch_parallel_ranks.py and
saves its results; the test functions assert on them.

- `data_parallel_step` on a toy regression that draws nothing, one SGD
  step on a 1-D mesh and on a 2x2 `make_mesh_2d` mesh, against JAX's
  `data_parallel_step` over 4 virtual CPU devices on the same parameters
  and batch (tests/test_parallel.py:91-127, 195-233): abs <= 1e-6;
- `shard_rays_render` over the port's `render_rays` on its plain twins
  against the single-process render (as tests/test_parallel.py:43-58):
  abs <= 1e-6, the same output on every rank, and an indivisible ray
  count refused;
- `GeneralizableSystem`'s 4-rank step at toy size (32x32, 64 rays, 16 a
  rank): the gradients Adam receives equal the mean of the 4 ranks'
  gradient sets recomputed here in one process from the same draws
  (abs <= 1e-5 x the part's max|g|; not the full-batch gradient, since
  the depth loss's masked mean differs), the parameters are identical on
  every rank after 2 steps, and the logged loss is the mean of the
  per-rank losses (rel <= 1e-6);
- world size 1 through the data-parallel path is bit-equal to the
  single-process step over 3 steps;
- `init_distributed` is a no-op in a single process.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_parallel_ranks as ranks

WORLD = 4


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    torch.multiprocessing.spawn(
        ranks.run_rank, args=(WORLD, f"file://{tmp}/store",
                              f"file://{tmp}/store1", str(tmp)),
        nprocs=WORLD, join=True)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_toy_step(mesh, axis_name):
    from mvsnerf_tpu.parallel import data_parallel_step, replicate
    params, batch = ranks.toy_problem()

    def loss_fn(p, b, key):
        h = jnp.tanh(b["x"] @ p["w1"] + p["b1"])
        return jnp.mean((h @ p["w2"] - b["y"]) ** 2)

    opt = optax.sgd(ranks.SGD_LR)
    p = replicate(jax.tree.map(jnp.asarray, params), mesh)
    step = data_parallel_step(loss_fn, opt, mesh, axis_name=axis_name)
    p, _, loss = step(p, opt.init(p), jax.tree.map(jnp.asarray, batch),
                      jax.random.PRNGKey(7))
    return float(loss), jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("case", ["toy_1d", "toy_2d"])
def test_data_parallel_step_matches_jax(results, case):
    from mvsnerf_tpu.parallel import make_mesh, make_mesh_2d
    devices = jax.devices()[:WORLD]
    if case == "toy_1d":
        mesh = make_mesh(devices)
        loss, params = _jax_toy_step(mesh, "rays")
    else:
        mesh = make_mesh_2d(n_data=2, devices=devices)
        loss, params = _jax_toy_step(mesh, mesh.axis_names)
        assert all(r["mesh2_shape"] == (2, 2) for r in results)
    for r in results:
        assert r["world"] == WORLD
        ours = r[case]
        assert abs(ours["loss"] - loss) <= 1e-6
        for k, v in params.items():
            np.testing.assert_allclose(ours["params"][k].numpy(), v,
                                       rtol=0, atol=1e-6, err_msg=k)
    # the step moved the parameters
    p0, _ = ranks.toy_problem()
    assert np.abs(params["w1"] - p0["w1"]).max() > 1e-4


def test_shard_rays_render_matches_single_process(results):
    single = results[0]["render_single"]
    assert single["acc"].max() > 0
    for r in results:
        out = r["render_sharded"]
        assert out.keys() == single.keys()
        for k in single:
            assert out[k].shape == single[k].shape, k
            np.testing.assert_allclose(out[k].numpy(), single[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)
            assert torch.equal(out[k], results[0]["render_sharded"][k])
        assert "not divisible" in r["render_indivisible"]


def _recompute_rank_grads():
    """Each rank's loss and gradients at the initial state from its own
    draws (the generator of rank r at step 0, `rank_seed(GEN_SEED * 2**32,
    r)`), in this process: a one-process system with one rank's batch, on
    one thread as the ranks run (the U-Net's float32 gradients move by
    ~1e-3 x max|g| between thread counts, whose convolutions sum in other
    orders)."""
    from mvsnerf_tpu_torch.parallel import rank_seed
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    system = GeneralizableSystem(
        ranks.generalizable_args(ranks.GEN_BATCH // WORLD), device="cpu")
    batch = system.batch(ranks.generalizable_sample())
    losses, grads = [], []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for r in range(WORLD):
            gen = torch.Generator().manual_seed(
                rank_seed(ranks.GEN_SEED * 2 ** 32, r))
            loss, _ = system.loss(batch, *system.draw(batch, gen))
            system.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            losses.append(float(loss.detach()))
            grads.append({f"{m}.{n}": p.grad.clone() for m, mod in
                          (("mlp", system.mlp), ("mvsnet", system.mvsnet))
                          for n, p in mod.named_parameters()})
    finally:
        torch.set_num_threads(threads)
    return losses, grads


def test_generalizable_step_averages_the_rank_gradients(results):
    losses, grads = _recompute_rank_grads()
    mean = {k: sum(g[k] for g in grads) / WORLD for k in grads[0]}
    full_batch_differs = False
    for r in results:
        ours = r["gen"]["grads"]
        assert ours.keys() == mean.keys()
        for part in ("mlp.", "mvsnet.cost_reg_2.", "mvsnet.feature."):
            names = [n for n in mean if n.startswith(part)]
            g_max = max(float(mean[n].abs().max()) for n in names)
            assert g_max > 0, part
            for n in names:
                np.testing.assert_allclose(ours[n].numpy(),
                                           mean[n].numpy(), rtol=0,
                                           atol=1e-5 * g_max, err_msg=n)
        # rank r's own gradients are not the mean: the ranks drew apart
        full_batch_differs |= any(
            float((grads[0][n] - mean[n]).abs().max()) > 1e-3 *
            float(mean[n].abs().max()) for n in mean)
    assert full_batch_differs
    # the logged first-step loss is the mean of the per-rank losses
    step, row = results[0]["gen"]["rows"][0]
    assert step == 1
    assert abs(row["train/loss"] - np.mean(losses)) <= \
        1e-6 * abs(np.mean(losses))
    assert abs(results[0]["gen"]["losses"][0] - np.mean(losses)) <= \
        1e-6 * abs(np.mean(losses))


def test_generalizable_parameters_equal_on_every_rank(results):
    ref = results[0]["gen"]["state"]
    for r in results[1:]:
        assert r["gen"]["rows"] == [] and r["gen"]["losses"] == \
            results[0]["gen"]["losses"]
        for k, v in r["gen"]["state"].items():
            assert torch.equal(v, ref[k]), k
    state0 = results[0]["gen"]["state0"]
    assert all(torch.equal(v, state0[k]) for r in results
               for k, v in r["gen"]["state0"].items())
    assert not all(torch.equal(v, state0[k]) for k, v in ref.items())


def test_world_size_one_is_bit_equal_to_one_process(results):
    dp, plain = results[0]["ws1_dp"], results[0]["ws1_plain"]
    assert dp["losses"] == plain["losses"] and len(dp["losses"]) == 3
    for k, v in plain["grads"].items():
        assert torch.equal(dp["grads"][k], v), k
    for k, v in plain["state"].items():
        assert torch.equal(dp["state"][k], v), k
    assert [r for _, r in dp["rows"]] == [r for _, r in plain["rows"]]


def test_init_distributed_is_a_noop_in_one_process(monkeypatch):
    import torch.distributed as dist
    from mvsnerf_tpu_torch.parallel import axis_group, init_distributed, \
        is_main_rank
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() is False
    assert not dist.is_initialized()
    assert axis_group(None) == (None, 1, 0) and is_main_rank()
    with pytest.raises(ValueError, match="rank and world_size"):
        init_distributed("file:///nowhere")
    assert "WORLD_SIZE" in os.environ
