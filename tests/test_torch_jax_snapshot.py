"""The JAX package's `.msgpack` snapshots in the port
(mvsnerf_tpu_torch/io/jax_snapshot.py, io/checkpoint.py), on the CPU.

Each case is one of JAX's trainers, built and stepped by the JAX package
itself: `FinetuneSystem` (v0 with and without `--use_color_volume`, and
v2, whose tree has v0's keys and shapes; 5 views of 32x32, pad 4, volume
(128, 16, 16, 8 or 20) from a seeded reference checkpoint), `GeneralizableSystem` (4 views of
32x32, its cosine schedule over 10 steps) and `FusionFinetuneSystem` (the
fused volume (16, 16, 16, 20) seeded; `VOLUME_DIM` (16, 16, 16) on both
sides). JAX takes 2 steps of its own `fit` and `save`s a snapshot; a port
system of the same flags restores it from JAX's `ckpts/` directory (the
directory holds no `.pt`). Then, per case:

- every parameter and every Adam moment equals JAX's after the layout
  transforms, exactly (atol 0); the MVSNet of the fine-tune trainer has
  no Adam state (JAX holds zero moments for it); `step`, `last_epoch`
  and `global_step` equal JAX's counts;
- the next lr equals JAX's `make_lr_schedule(...)(count)` within float32
  rounding (rel 1e-6);
- one port Adam update of a seeded gradient equals `optax.adam`'s update
  from JAX's `opt_state` on the same gradient (the optimizer, not the
  trainer step): the new moments within 1e-6 x max|moment| of each
  tensor, the update within (1e-6 + e) x max|update|, e the float32
  rounding of optax's bias corrections at the count (~4e-6 at count 3;
  see the test);
- `write_jax_snapshot` of the port's state gives the bytes of JAX's file
  (flax's `to_bytes` of JAX's tree), and JAX's own `restore` resumes from
  it and steps on.

Also: the directory rule (`.pt` before `.msgpack`), the refusals (a
`.msgpack` `--ckpt` for the generalizable and fusion trainers, nonzero
moments that have no slot in the port, a file that is no snapshot), and
`render_video --ckpt *.msgpack` restoring exactly that file.
"""

import contextlib
import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_finetune import Scene as FinetuneScene
from test_torch_fusion import DIM, Scene as FusionScene
from torch_parallel_ranks import generalizable_sample
from torch_port_common import jax_mlp_params, jax_params

FT_FLAGS = "--pad 4 --N_samples 8 --batch_size 64 --with_rgb_loss"
GEN_FLAGS = ("--dataset_name dtu --pad 4 --N_samples 8 --batch_size 64 "
             "--with_depth_loss --with_depth")
FUSION_FLAGS = "--pad 4 --N_samples 8 --batch_size 64 --with_rgb_loss"
GEN_SCHEDULE = 10
CASES = {"finetune-v0": ("finetune", "v0", ""),
         "finetune-v0-color": ("finetune", "v0", "--use_color_volume"),
         "finetune-v2": ("finetune", "v2", ""),
         "generalizable": ("generalizable", "v0", ""),
         "fusion": ("fusion", "v0", "")}


@contextlib.contextmanager
def _volume_dim():
    from mvsnerf_tpu.train import fusion as jf
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jf.FusionFinetuneSystem, "VOLUME_DIM", DIM)
        mp.setattr(FusionFinetuneSystem, "VOLUME_DIM", DIM)
        yield


def _reference_ckpt(tmp, net_type, volume=None):
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    path = str(tmp / "ref.tar")
    export_reference_checkpoint(path, jax_mlp_params(net_type, 0),
                                jax_params(0)[1], volume=volume)
    return path


def _finetune(tmp, net_type, extra):
    from mvsnerf_tpu.config import config_parser as jax_config
    from mvsnerf_tpu.train import FinetuneSystem as JaxFinetune
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    scene = FinetuneScene()
    volume = np.random.default_rng(5).normal(
        0, 0.2, (128, 16, 16, 8)).astype(np.float32)
    flags = f"{FT_FLAGS} --net_type {net_type} {extra} --ckpt " + \
        _reference_ckpt(tmp, net_type, volume)
    ref = JaxFinetune(jax_config(flags.split()), scene)
    ref.fit(2, val_every=0)
    ref.save(str(tmp / "ckpts"), 2)
    return ref, FinetuneSystem(config_parser(flags), scene, device="cpu")


def _generalizable(tmp):
    from mvsnerf_tpu.config import config_parser as jax_config
    from mvsnerf_tpu.train.generalizable import GeneralizableSystem as JaxGen
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    flags = f"{GEN_FLAGS} --ckpt {_reference_ckpt(tmp, 'v0')}"
    sample = generalizable_sample(9, 4, 32)
    ref = JaxGen(jax_config(flags.split()))
    # JAX's step over a 10-step cosine schedule: its fit builds the
    # optimizer on the first call and reuses it (generalizable.py:68-90)
    ref._make_step((32, 32), 64, 8, GEN_SCHEDULE)
    ref.fit([sample], num_epochs=2)
    ref.save(str(tmp / "ckpts"))
    port = GeneralizableSystem(config_parser(flags), device="cpu")
    port.schedule_steps = GEN_SCHEDULE
    return ref, port


def _fusion(tmp):
    """JAX's fusion system built without its fuse (the snapshot holds
    {mlp, volume} whatever the volume is): a seeded fused volume."""
    from mvsnerf_tpu.config import config_parser as jax_config
    from mvsnerf_tpu.train import fusion as jf
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
    scene = FusionScene()
    mlp_p, mvs_p = jax_params(0)
    ref = jf.FusionFinetuneSystem.__new__(jf.FusionFinetuneSystem)
    ref.args = jax_config(f"{FUSION_FLAGS} --ckpt None".split())
    ref.train_dataset, ref.val_dataset = scene, None
    ref.mlp, ref.mvsnet = mlp_p, mvs_p
    ref.bbox_3d = jnp.asarray(scene.bbox_3d)
    ref.pose_source_ref = {k: jnp.asarray(v) for k, v in
                           scene.read_source_views()[3].items()}
    ref.density_volume, ref.opt_state = None, None
    volume = np.random.default_rng(6).normal(0, 0.2, (*DIM, 20))
    ref.params = {"mlp": mlp_p, "volume": jnp.asarray(volume, jnp.float32)}
    ref._build_step()
    ref.fit(2, val_every=0)
    ref.save(str(tmp / "ckpts"), 2)
    port = FusionFinetuneSystem(
        config_parser(f"{FUSION_FLAGS} --ckpt {_reference_ckpt(tmp, 'v0')}"),
        scene, device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def build(tmp_path_factory):
    """name -> the case: JAX's system after 2 steps and its snapshot, the
    port's system restored from JAX's ckpts/ directory (built once)."""
    cache = {}

    def get(name):
        if name not in cache:
            kind, net_type, extra = CASES[name]
            tmp = tmp_path_factory.mktemp(name)
            with _volume_dim():
                if kind == "finetune":
                    ref, port = _finetune(tmp, net_type, extra)
                elif kind == "generalizable":
                    ref, port = _generalizable(tmp)
                else:
                    ref, port = _fusion(tmp)
            ckpts = str(tmp / "ckpts")
            assert os.listdir(ckpts) == ["ckpt_000000002.msgpack"]
            step = port.restore(ckpts, strict=True)
            cache[name] = dict(kind=kind, net_type=net_type, ref=ref,
                               port=port, step=step, tmp=tmp,
                               path=os.path.join(ckpts, os.listdir(ckpts)[0]))
        return cache[name]
    return get


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_layout(case, tree):
    """A JAX params-shaped tree -> {part: port state dict or volume}."""
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    fn, mvs = state_dicts_from_jax(tree["mlp"], tree.get("mvsnet"),
                                   case["net_type"])
    out = {"mlp": fn, "mvsnet": mvs}
    if "volume" in tree:
        out["volume"] = torch.tensor(np.asarray(tree["volume"]))
    return out


def _named_params(port):
    """(part, name, parameter) of every parameter Adam holds."""
    out = [("mlp", n, p) for n, p in port.mlp.named_parameters()]
    out += [("mvsnet", n, p) for n, p in port.mvsnet.named_parameters()]
    if getattr(port, "volume", None) is not None:
        out.append(("volume", None, port.volume))
    held = {id(p) for g in port.optimizer.param_groups for p in g["params"]}
    return [(part, n, p) for part, n, p in out if id(p) in held]


def _pick(parts, part, name):
    return parts["volume"] if part == "volume" else parts[part][name]


@pytest.mark.parametrize("name", list(CASES))
def test_params_and_moments_are_exact(build, name):
    case = build(name)
    ref, port = case["ref"], case["port"]
    assert case["step"] == 2
    params = _port_layout(case, _np(ref.params))
    for part in ("mlp", "mvsnet"):
        if params[part] is None:
            continue
        ours = getattr(port, part).state_dict()
        assert ours.keys() == params[part].keys()
        for k, v in params[part].items():
            torch.testing.assert_close(ours[k], v, rtol=0, atol=0,
                                       msg=f"{part} {k}")
    if "volume" in params:
        torch.testing.assert_close(port.volume.detach(), params["volume"],
                                   rtol=0, atol=0)
    adam, sched = ref.opt_state
    mu = _port_layout(case, _np(adam.mu))
    nu = _port_layout(case, _np(adam.nu))
    state = port.optimizer.state
    for part, n, p in _named_params(port):
        if part == "mvsnet" and case["kind"] == "finetune":
            # never updated in the port: no state; JAX's moments are zero
            assert p not in state
            assert not _pick(mu, part, n).any() and \
                not _pick(nu, part, n).any()
            continue
        assert float(state[p]["step"]) == int(adam.count) == 2
        assert state[p]["step"].dtype == torch.float32
        for key, ref_m in (("exp_avg", mu), ("exp_avg_sq", nu)):
            torch.testing.assert_close(state[p][key], _pick(ref_m, part, n),
                                       rtol=0, atol=0,
                                       msg=f"{key} {part} {n}")
    assert port.scheduler.last_epoch == int(sched.count) == 2
    assert len(state) == len([1 for part, _, _ in _named_params(port)
                              if not (part == "mvsnet" and
                                      case["kind"] == "finetune")])


@pytest.mark.parametrize("name", list(CASES))
def test_next_lr_is_jaxs_schedule(build, name):
    from mvsnerf_tpu.utils.schedulers import make_lr_schedule
    case = build(name)
    args = case["ref"].args
    if case["kind"] == "generalizable":
        schedule = make_lr_schedule(args.lrate, "cosine",
                                    num_steps=GEN_SCHEDULE, eta_min=1e-7)
    elif case["kind"] == "fusion":
        schedule = make_lr_schedule(args.lrate, args.lr_scheduler,
                                    args.decay_step, args.decay_gamma)
    else:
        schedule = make_lr_schedule(args.lrate, args.lr_scheduler,
                                    args.decay_step, args.decay_gamma,
                                    num_steps=args.num_epochs * 10000
                                    or 10000)
    want = float(schedule(int(case["ref"].opt_state[1].count)))
    for group in case["port"].optimizer.param_groups:
        assert group["lr"] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_one_adam_update_matches_optax(build, name):
    """The update of a seeded gradient (zero where JAX's step gives zero:
    the fine-tune MVSNet, ABN's mean and var), from the restored state,
    against `optax.adam`'s from JAX's `opt_state`. Adam's update does not
    read the parameter (no weight decay), so the port's parameters are
    zeroed first: after the step each holds its update exactly, not
    rounded into the parameter's value.

    The new moments are held to optax's within 1e-6 x max|moment|. The
    update, within (1e-6 + e) x max|update|: optax computes its bias
    corrections 1 - b**count in float32, where b**count lies near 1 and
    the difference keeps few bits (at count 3, 1 - 0.999**3 is off by
    ~1e-5 relative); torch computes them in float64. e is the relative
    error of optax's corrections at this count (JAX's own float32 ops
    against float64), that of mu's plus half that of nu's (the update
    divides by sqrt(nu_hat))."""
    case = build(name)
    ref = case["ref"]
    port = copy.deepcopy(case["port"])
    rng = np.random.default_rng(11)

    def grad(path, a):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[-1] in ("mean", "var") or (
                keys[0] == "mvsnet" and case["kind"] == "finetune"):
            return np.zeros(a.shape, np.float32)
        return rng.standard_normal(a.shape).astype(np.float32)

    g = jax.tree_util.tree_map_with_path(grad, _np(ref.params))
    updates, new_state = jax.jit(ref.optimizer.update)(g, ref.opt_state,
                                                       ref.params)
    want = _port_layout(case, _np(updates))
    count = int(new_state[0].count)
    # optax's `1 - decay**count` on its int32 count, against float64
    e = sum(abs(float(1 - b ** new_state[0].count) / (1 - b ** count) - 1)
            * w for b, w in ((0.9, 1.0), (0.999, 0.5)))
    moments = {"exp_avg": _port_layout(case, _np(new_state[0].mu)),
               "exp_avg_sq": _port_layout(case, _np(new_state[0].nu))}
    grads = _port_layout(case, g)
    stepped = set()
    with torch.no_grad():
        for part, n, p in _named_params(port):
            if part == "mvsnet" and case["kind"] == "finetune":
                continue
            p.grad = _pick(grads, part, n).clone()
            p.zero_()
            stepped.add((part, n))
    port.optimizer.step()
    for part, n, p in _named_params(port):
        ref_d = _pick(want, part, n)
        if (part, n) not in stepped:
            assert not ref_d.any()
            continue
        tol = (1e-6 + e) * float(ref_d.abs().max())
        torch.testing.assert_close(p.detach(), ref_d, rtol=0, atol=tol,
                                   msg=f"{part} {n}")
        for key, ref_m in moments.items():
            m = _pick(ref_m, part, n)
            torch.testing.assert_close(
                port.optimizer.state[p][key], m, rtol=0,
                atol=1e-6 * float(m.abs().max()), msg=f"{key} {part} {n}")
        assert float(port.optimizer.state[p]["step"]) == count


@pytest.mark.parametrize("name", list(CASES))
def test_port_written_snapshot_is_jaxs_and_resumes_in_jax(build, name):
    from mvsnerf_tpu_torch.io.jax_snapshot import write_jax_snapshot
    case = build(name)
    port, kind = case["port"], case["kind"]
    state = port.state() if kind == "generalizable" else port.state(2)
    out = str(case["tmp"] / "port" / "ckpt_000000002.msgpack")
    write_jax_snapshot(out, state, kind, port)
    assert not os.path.exists(out + ".tmp")
    with open(out, "rb") as f, open(case["path"], "rb") as g:
        assert f.read() == g.read()
    ref = copy.copy(case["ref"])
    assert ref.restore(out, strict=True) == 2
    for a, b in zip(jax.tree.leaves(_np(ref.params)),
                    jax.tree.leaves(_np(case["ref"].params))):
        np.testing.assert_array_equal(a, b)
    if kind == "generalizable":
        ref.fit([generalizable_sample(9, 4, 32)], num_epochs=1)
        assert ref.global_step == 3
    else:
        ref.fit(3, start_step=2, val_every=0)
    assert int(ref.opt_state[0].count) == 3


def test_directory_prefers_pt_then_newest_msgpack(tmp_path):
    from mvsnerf_tpu_torch.io.checkpoint import latest_checkpoint, \
        snapshot_path
    d = str(tmp_path)
    assert latest_checkpoint(d) is None
    for step in (3, 12):
        open(os.path.join(d, f"ckpt_{step:09d}.msgpack"), "wb").close()
    assert latest_checkpoint(d) == (12, os.path.join(
        d, "ckpt_000000012.msgpack"))
    open(os.path.join(d, "ckpt_000000005.pt"), "wb").close()
    assert latest_checkpoint(d) == (5, os.path.join(d, "ckpt_000000005.pt"))
    named = os.path.join(d, "ckpt_000000003.msgpack")
    assert snapshot_path(named) == named
    with pytest.raises(FileNotFoundError):
        snapshot_path(os.path.join(d, "none.msgpack"), strict=True)
    assert snapshot_path(os.path.join(d, "none")) is None


@pytest.mark.parametrize("trainer", ["generalizable", "fusion"])
def test_msgpack_ckpt_is_refused_at_construction(build, trainer):
    """JAX's constructors hand `--ckpt` to load_reference_checkpoint, which
    cannot read a snapshot: the port refuses it, naming where to put it."""
    from mvsnerf_tpu_torch.config import config_parser
    case = build("generalizable")
    if trainer == "generalizable":
        from mvsnerf_tpu_torch.train.generalizable import \
            GeneralizableSystem
        with pytest.raises(ValueError, match="ckpts/ directory"):
            GeneralizableSystem(config_parser(
                f"{GEN_FLAGS} --ckpt {case['path']}"), device="cpu")
    else:
        from mvsnerf_tpu_torch.train.fusion import FusionFinetuneSystem
        with pytest.raises(ValueError, match="ckpts/ directory"):
            FusionFinetuneSystem(config_parser(
                f"{FUSION_FLAGS} --ckpt {case['path']}"), FusionScene(),
                device="cpu")


def _edited(case, tmp, edit):
    """The case's JAX snapshot with `edit(tree)` applied, re-encoded."""
    from mvsnerf_tpu_torch.io import flax_msgpack
    with open(case["path"], "rb") as f:
        tree = flax_msgpack.from_bytes(f.read())
    edit(tree)
    path = str(tmp / "edited.msgpack")
    with open(path, "wb") as f:
        f.write(flax_msgpack.to_bytes(tree))
    return path


@pytest.mark.parametrize("what", ["ABN mean moment", "fine-tune MVSNet",
                                  "not a snapshot", "wrong trainer"])
def test_moments_without_a_slot_and_bad_files_raise(build, tmp_path, what):
    from mvsnerf_tpu_torch.io.jax_snapshot import read_jax_snapshot
    name = "generalizable" if what == "ABN mean moment" else "finetune-v0"
    case = build(name)
    conv = "feature/conv0/0"

    def at(tree, path):
        for k in path.split("/"):
            tree = tree[k]
        return tree

    if what == "ABN mean moment":
        def edit(tree):
            at(tree, f"opt_state/0/mu/mvsnet/{conv}/bn")["mean"] = \
                np.ones(8, np.float32)
        path, kind, match = _edited(case, tmp_path, edit), name, "ABN"
    elif what == "fine-tune MVSNet":
        def edit(tree):
            at(tree, f"opt_state/0/nu/mvsnet/{conv}/conv")["kernel"] = \
                np.ones((3, 3, 3, 8), np.float32)
        path, kind, match = _edited(case, tmp_path, edit), "finetune", \
            "mvsnet"
    elif what == "not a snapshot":
        path, kind, match = str(tmp_path / "x.msgpack"), "finetune", \
            "truncated"
        open(path, "wb").close()
    else:
        path, kind, match = case["path"], "fusion", "params"
    with pytest.raises(ValueError, match=match) as err:
        read_jax_snapshot(path, kind, case["port"])
    assert path in str(err.value)


def test_render_video_restores_exactly_the_named_msgpack(build, tmp_path,
                                                         monkeypatch,
                                                         capsys):
    """`render_video --ckpt ckpt_*.msgpack` renders JAX's snapshot (the
    root render_video.py:27-31 rule), a 32x32 Blender scene's volume being
    the snapshot's shape; a named snapshot that does not exist raises."""
    from mvsnerf_tpu_torch import render_video as cli
    from mvsnerf_tpu_torch.data.pairs import get_split
    from mvsnerf_tpu_torch.data.synthetic import write_blender_scene
    case = build("finetune-v0")
    write_blender_scene(str(tmp_path / "lego"), res=64, frames=np.concatenate(
        [get_split("lego", "train"), get_split("lego", "val")]))
    monkeypatch.chdir(tmp_path)
    flags = ["--dataset_name", "blender", "--datadir", str(tmp_path / "lego"),
             "--white_bkgd", "--expname", "vid", "--imgScale_train", "0.04",
             "--pad", "4", "--N_samples", "8", "--device", "cpu"]
    rendered = {}

    def render_video(system, poses, *a, **kw):
        rendered["system"] = system
        return []

    render_video.last_path = None
    monkeypatch.setattr(cli, "render_video", render_video)
    cli.main(flags + ["--ckpt", case["path"]])
    assert f"restored {case['path']} (step 2)" in capsys.readouterr().out
    got, want = rendered["system"], case["port"]
    for k, v in want.mlp.state_dict().items():
        assert torch.equal(got.mlp.state_dict()[k], v), k
    assert torch.equal(got.volume.detach(), want.volume.detach())
    with pytest.raises(FileNotFoundError):
        cli.main(flags + ["--ckpt", str(tmp_path / "none.msgpack")])
