"""The port's `--costreg_impl dband` route (K10, ops/costreg_conv.py) against
the JAX package on the CPU, where its Functions run the plain twins through
the same forward and backward decomposition the kernels run on a card.

- conv3d_s1 / conv3d_s2 / conv3d_up, forward and the gradients of x and
  the kernel under the loss sum(y^2 + 0.3 y), against
  `jax.lax.conv_general_dilated` (HIGHEST) and `layers.conv_transpose3d`
  under `jax.grad`: abs <= 1e-5 x max|ref|.
- one single-block interpret-mode run of each JAX dband forward kernel
  (conv3d_s1_dband, conv3d_s2_dband, conv3d_up_dband) at (Cin 3, Cout 4,
  D 8, H 8, W 128) against the port's twin: JAX's own atol 2e-5, rtol
  1e-5 (tests/test_pallas_costreg.py).
- CostRegNet(impl="dband") against `cost_reg_apply`, forward (atol 5e-5,
  rtol 1e-4) and parameter gradients (2e-3 x max|g| per tensor), JAX's
  own tolerances (tests/test_pallas_costreg.py:155, 183).
- MVSNet(costreg_impl="dband") on the toy scene against
  `mvsnet_apply(costreg_impl="plain")`, through a reference checkpoint.
- one generalizable step with `--costreg_impl dband` against the JAX step
  of tests/test_torch_generalizable.py on kink-clear draws, at that
  file's 1e-4 x max|g|.
- dband and auto agree on the CPU; the flag's plumbing; the kernel
  wrappers refuse what they cannot take.
- `costreg_route`: `auto` resolves to K10 for an input on a card, float64
  and batch 2 included, whose K10 wrappers refuse those two, and to cuDNN
  for a CPU tensor (from the device alone, no card needed); `plain`,
  `dband` and `packed` keep their route; the U-Net's forward takes the
  route it gives, once a call. (A card step under `auto` is counted in
  tests/test_torch_costreg_tc.py, which runs on the card.)
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_torch_generalizable as tg
from torch_port_common import jax_params, t

HIGHEST = jax.lax.Precision.HIGHEST


def _rng(seed):
    return np.random.default_rng(seed)


def _jax_conv(x, k, stride):
    """x (1, D, H, W, C), k DHWIO -> lax conv, pad 1."""
    return jax.lax.conv_general_dilated(
        x, k, window_strides=(stride,) * 3, padding=((1, 1),) * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"), precision=HIGHEST)


def _jax_up(x, k):
    from mvsnerf_tpu.models.layers import conv_transpose3d
    return conv_transpose3d({"kernel": k}, x)


def _to_port_kernel(k, kind):
    """JAX kernel -> the port's: conv DHWIO -> OIDHW; the transposed conv's
    pre-flipped (k3, I, O) -> (I, O, k3) unflipped (io/torch_ckpt.py)."""
    k = np.asarray(k)
    if kind == "up":
        return np.ascontiguousarray(
            np.transpose(k, (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1])
    return np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2)))


def _ncdhw(x):
    return t(np.transpose(np.asarray(x), (0, 4, 1, 2, 3))).contiguous()


def _ndhwc(y):
    return np.transpose(y.detach().numpy(), (0, 2, 3, 4, 1))


CONV_CASES = [("s1", 5, 4, (8, 6, 10)), ("s1", 3, 6, (5, 7, 9)),
              ("s2", 5, 8, (8, 8, 12)), ("s2", 4, 3, (6, 9, 7)),
              ("up", 6, 4, (4, 4, 6)), ("up", 3, 5, (3, 5, 7))]


@pytest.mark.parametrize("kind,cin,cout,dhw", CONV_CASES,
                         ids=[f"{c[0]}-{'x'.join(map(str, c[3]))}"
                              for c in CONV_CASES])
def test_conv_and_grads_match_jax(kind, cin, cout, dhw):
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    rng = _rng(sum(dhw) + cin)
    x = rng.standard_normal((1, *dhw, cin)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)

    def jax_fn(x_, k_):
        return _jax_up(x_, k_) if kind == "up" else \
            _jax_conv(x_, k_, 1 if kind == "s1" else 2)

    def loss(y):
        return jnp.sum(y ** 2 + 0.3 * y)

    ref = jax_fn(jnp.asarray(x), jnp.asarray(k))
    gx_ref, gk_ref = jax.grad(lambda a, b: loss(jax_fn(a, b)),
                              argnums=(0, 1))(jnp.asarray(x), jnp.asarray(k))
    xt = _ncdhw(x).requires_grad_()
    kt = t(_to_port_kernel(k, kind)).requires_grad_()
    op = {"s1": k10.conv3d_s1, "s2": k10.conv3d_s2, "up": k10.conv3d_up}
    y = op[kind](xt, kt)
    (y ** 2 + 0.3 * y).sum().backward()
    for ours, theirs in ((_ndhwc(y), ref),
                         (_ndhwc(xt.grad), gx_ref),
                         (kt.grad.numpy(), _to_port_kernel(gk_ref, kind))):
        theirs = np.asarray(theirs)
        assert ours.shape == theirs.shape
        np.testing.assert_allclose(ours, theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max())
    assert k10.launches == {"s1": 0, "s2": 0, "up": 0, "wgrad": 0}


@pytest.mark.parametrize("kind", ["s1", "s2", "up"])
def test_jax_dband_kernel_interpret_matches_twin(kind):
    """One block of each JAX dband forward kernel in interpret mode."""
    from mvsnerf_tpu.ops import pallas_costreg as pc
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    rng = _rng(21)
    cin, cout, d, h, w = 3, 4, 8, 8, 128
    x = rng.standard_normal((cin, d, h, w)).astype(np.float32)
    k = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.2).astype(np.float32)
    xj, kj = jnp.asarray(x), jnp.asarray(k)
    xt, kt = t(x)[None], t(_to_port_kernel(k, kind))
    if kind == "s1":
        ref = pc.conv3d_s1_dband(pc.pad_dh(xj), pc.build_a(kj, P=8), p=8,
                                 rh=8, interpret=True, precision=HIGHEST)
        ours = k10.conv3d_fwd_plain(xt, kt, 1)
    elif kind == "s2":
        xe, xo = pc.split_w(pc.pad_dh(xj))
        ref = pc.conv3d_s2_dband(xe, xo, pc.build_a(kj, P=4, stride=2), p=4,
                                 rh=4, interpret=True, precision=HIGHEST)
        ours = k10.conv3d_fwd_plain(xt, kt, 2)
    else:
        oe, oo = pc.conv3d_up_dband(pc.pad_dh(xj), pc.build_a_up(kj, P=8),
                                    p=8, rh=8, interpret=True,
                                    precision=HIGHEST)
        ref = pc.interleave_w(oe, oo)
        ours = k10.conv3d_up_plain(xt, kt, [2 * d, 2 * h, 2 * w])
    ref = np.asarray(ref)
    assert ours.shape[1:] == ref.shape
    np.testing.assert_allclose(ours[0].numpy(), ref, atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def params():
    return jax_params(0)


def _dband_modules(params, **kw):
    from mvsnerf_tpu_torch.io.torch_ckpt import modules_from_state_dicts, \
        state_dicts_from_jax
    return modules_from_state_dicts(*state_dicts_from_jax(*params),
                                    device="cpu", costreg_impl="dband", **kw)


@pytest.mark.parametrize("dhw", [(16, 8, 8), (15, 7, 8)])
def test_cost_reg_net_dband_matches_jax(params, dhw):
    """(15, 7, 8) is not a multiple of 8: padded to (16, 8, 8) and cropped
    back."""
    from mvsnerf_tpu.models.mvsnet import cost_reg_apply
    from mvsnerf_tpu_torch.io.torch_ckpt import state_dicts_from_jax
    mlp_p, mvs_p = params
    # a draw on which JAX's float32 gradients lie within the tolerance of
    # exact: on _rng(7)'s, at (16, 8, 8), where the deepest level holds
    # 2 x 1 x 1 voxels, the port's float64 run is 1.8e-3 x max|g| from JAX
    # (float32) on conv4.bn.bias
    x = _rng(8).standard_normal((1, *dhw, 41)).astype(np.float32)

    def loss_ref(p_, x_):
        y = cost_reg_apply(p_, x_)
        return jnp.sum(y ** 2 + 0.1 * y), y

    (_, ref), g_ref = jax.value_and_grad(loss_ref, has_aux=True)(
        jax.tree.map(jnp.asarray, mvs_p["cost_reg_2"]), jnp.asarray(x))
    _, mvs = _dband_modules(params)
    net = mvs.cost_reg_2
    assert net.impl == "dband"
    y = net(_ncdhw(x))
    (y ** 2 + 0.1 * y).sum().backward()
    np.testing.assert_allclose(_ndhwc(y), np.asarray(ref), atol=5e-5,
                               rtol=1e-4)
    g_sd = state_dicts_from_jax(
        mlp_p, dict(mvs_p, cost_reg_2=jax.tree.map(np.asarray, g_ref)))[1]
    for name, p in net.named_parameters():
        ref_g = g_sd[f"cost_reg_2.{name}"].numpy()
        scale = max(1e-6, float(np.abs(ref_g).max()))
        np.testing.assert_allclose(p.grad.numpy() / scale, ref_g / scale,
                                   atol=2e-3, err_msg=name)


def test_dband_and_auto_agree_on_the_cpu(params):
    """The same module on both routes, forward and parameter gradients."""
    _, mvs = _dband_modules(params)
    net = mvs.cost_reg_2
    x = _ncdhw(_rng(8).standard_normal((1, 8, 12, 16, 41)).astype(
        np.float32))
    outs = {}
    for impl in ("dband", "auto"):
        net.zero_grad(set_to_none=True)
        y = net(x, impl)
        (y ** 2 + 0.1 * y).sum().backward()
        outs[impl] = (y.detach(), [p.grad for p in net.parameters()])
    (ya, ga), (yb, gb) = outs["dband"], outs["auto"]
    torch.testing.assert_close(ya, yb, rtol=0,
                               atol=1e-5 * float(yb.abs().max()))
    for a, b in zip(ga, gb):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))


def test_mvsnet_dband_on_the_toy_scene_matches_jax(params, tmp_path):
    """MVSNet(costreg_impl="dband") through a reference checkpoint (the
    loader passes the route on), against JAX's plain route."""
    from __graft_entry__ import _toy_scene
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu.models import mvsnet_apply
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    from mvsnerf_tpu_torch.io.torch_ckpt import load_reference_checkpoint
    imgs, intr, w2cs, projs, pad, n_planes = _toy_scene()
    mean = np.array([0.485, 0.456, 0.406], np.float32)
    std = np.array([0.229, 0.224, 0.225], np.float32)
    imgs_norm = ((np.asarray(imgs) - mean) / std).astype(np.float32)
    near_far = (2.0, 6.0)
    ref = np.asarray(mvsnet_apply(
        params[1], jnp.asarray(imgs_norm), jnp.asarray(projs),
        jnp.asarray(near_far), pad=pad, n_planes=n_planes,
        warp_mode="packed", costreg_impl="plain",
        featurenet_impl="plain")[0])
    path = str(tmp_path / "ck.tar")
    export_reference_checkpoint(path, *params)
    mlp, mvsnet, _ = load_reference_checkpoint(path, "cpu",
                                               costreg_impl="dband")
    assert mvsnet.cost_reg_2.impl == "dband"
    with torch.no_grad():
        vol, _ = mvsnet(t(imgs_norm), t(projs), t(near_far), pad=pad,
                        n_planes=n_planes)
    assert vol.shape == ref.shape
    np.testing.assert_allclose(vol.numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))
    # the evaluator's switch picks the route for its build
    pose = {"w2cs": np.asarray(w2cs), "intrinsics": np.stack([intr] * 3)}
    mlp, mvsnet, _ = load_reference_checkpoint(path, "cpu")
    ev = Evaluator(mvsnet, mlp, n_samples=8, pad=pad, n_planes=n_planes,
                   device="cpu", costreg_impl="dband")
    vol_ev = ev.build_volume(imgs_norm, projs, near_far, pose)[0]
    np.testing.assert_allclose(vol_ev.numpy(), vol.numpy(), rtol=0,
                               atol=1e-5 * (1 + np.abs(ref).max()))


def test_generalizable_dband_step_matches_jax(tmp_path):
    """One step of the port's trainer with --costreg_impl dband against
    the JAX step (plain U-Net) from the same weights and kink-clear
    draws."""
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    mlp_p, mvs_p = jax_params(0)
    ckpt = str(tmp_path / "ref.tar")
    export_reference_checkpoint(ckpt, mlp_p, mvs_p)
    port = tg._port_system(ckpt, f"--lrate {tg.LRATE} --costreg_impl dband")
    assert port.mvsnet.cost_reg_2.impl == "dband"
    port.schedule_steps = tg.STEPS
    sample = tg._sample()
    batch = port.batch(sample)
    step, opt = tg._jax_stepper(port.args.lrate)
    params = jax.tree.map(jnp.asarray, {"mlp": mlp_p, "mvsnet": mvs_p})
    rng = np.random.default_rng(3)
    xs = rng.integers(0, tg.W, tg.POOL).astype(np.float32)
    ys = rng.integers(0, tg.H, tg.POOL).astype(np.float32)
    u = rng.uniform(size=(tg.POOL, tg.N_SAMPLES)).astype(np.float32)
    draws = [torch.from_numpy(a) for a in (xs, ys, u)]
    margin = relu_margin(port.mlp, port.mlp_input(batch, *draws))
    keep = np.flatnonzero(
        (margin.reshape(tg.POOL, -1).amin(1) > tg.KINK).numpy())[:tg.BATCH]
    assert len(keep) == tg.BATCH
    _, _, loss, grads = step(
        params, opt.init(params), {k: jnp.asarray(sample[k]) for k in batch},
        *(jnp.asarray(a[keep]) for a in (xs, ys, u)))
    ours = float(port._step(batch, *(d[keep] for d in draws))[0])
    assert abs(ours - float(loss)) <= 1e-5 * abs(float(loss))
    tg._check_grads({f"{m}.{n}": p.grad.clone() for m, mod in
                     (("mlp", port.mlp), ("mvsnet", port.mvsnet))
                     for n, p in mod.named_parameters()},
                    jax.tree.map(np.asarray, grads))


def test_costreg_flag_plumbing(capsys):
    """`dband` is a route of the port, not an ignored TPU switch; `packed`
    says that it runs cuDNN; both trainers build their MVSNet on it."""
    from mvsnerf_tpu_torch.config import TPU_ONLY
    assert "costreg_impl" not in TPU_ONLY
    args = tg._port_args(extra="--costreg_impl dband")
    assert "costreg_impl" not in capsys.readouterr().out
    tg._port_args(extra="--costreg_impl packed")
    out = capsys.readouterr().out
    assert "--costreg_impl packed" in out and "cuDNN" in out
    from mvsnerf_tpu_torch.train.generalizable import GeneralizableSystem
    assert GeneralizableSystem(args, device="cpu").mvsnet.cost_reg_2.impl \
        == "dband"
    from mvsnerf_tpu_torch.models.mvsnet import CostRegNet
    with pytest.raises(ValueError):
        CostRegNet(impl="banded")


@pytest.mark.parametrize("which", ["fwd", "up", "wgrad", "meta"])
def test_kernel_route_refuses_what_it_cannot_take(which):
    """The kernel wrappers refuse CPU tensors instead of running the twin
    (and build nothing); the routed operations refuse other devices."""
    from mvsnerf_tpu_torch import _build
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    x = torch.zeros(1, 4, 4, 4, 4)
    with pytest.raises(ValueError):
        if which == "fwd":
            k10.conv3d_fwd_kernel(x, torch.zeros(2, 4, 3, 3, 3), 1)
        elif which == "up":
            k10.conv3d_up_kernel(x, torch.zeros(4, 2, 3, 3, 3), (8, 8, 8))
        elif which == "wgrad":
            k10.conv3d_wgrad_kernel(x, x, 1)
        else:
            k10.conv3d_s1(x.to("meta"), torch.zeros(2, 4, 3, 3, 3,
                                                    device="meta"))
    assert _build._lib is None


CARD_INPUT = ("cuda", torch.float32, (1, 41, 128, 176, 208))
# case -> (the input's device, dtype and shape), the route, and what K10's
# forward wrapper says of the input on a card (here on "meta")
AUTO_CASES = {"cuda-f32-b1": (CARD_INPUT, "dband", "not a CUDA device"),
              "cpu": (("cpu", *CARD_INPUT[1:]), "plain", None),
              "float64": (("cuda", torch.float64, CARD_INPUT[2]), "dband",
                          "must be contiguous float32"),
              "batch2": (("cuda", torch.float32, (2, *CARD_INPUT[2][1:])),
                         "dband", r"needs x \(1, C, D, H, W\)")}


@pytest.mark.parametrize("case", list(AUTO_CASES))
def test_auto_route_resolves_from_the_input(case):
    """`auto` takes K10 for an input on a card and cuDNN elsewhere, from
    the device alone; on a card K10 refuses a float64 or batch-2 input
    instead of handing it to cuDNN, and takes the cost volume up to the
    device check. A description of the input is enough, no card."""
    from mvsnerf_tpu_torch import _build
    from mvsnerf_tpu_torch.models.mvsnet import costreg_route
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    (device, dtype, shape), want, refusal = AUTO_CASES[case]
    assert costreg_route("auto", device) == want
    assert costreg_route("auto", torch.device(device)) == want
    if want == "dband":
        x = torch.empty(shape, dtype=dtype, device="meta")
        w = torch.empty(8, shape[1], 3, 3, 3, device="meta")
        with pytest.raises(ValueError, match=refusal):
            k10.conv3d_fwd_kernel(x, w, 1)
        assert _build._lib is None


@pytest.mark.parametrize("impl", ["plain", "dband", "packed"])
def test_named_routes_override_auto(impl):
    """`plain` keeps cuDNN on a card, `dband` keeps K10 off one, `packed`
    stays itself; unknown values raise."""
    from mvsnerf_tpu_torch.models.mvsnet import costreg_route
    for (device, _, _), _, _ in AUTO_CASES.values():
        assert costreg_route(impl, device) == impl
    with pytest.raises(ValueError):
        costreg_route("banded", CARD_INPUT[0])


@pytest.mark.parametrize("route", ["plain", "dband"])
def test_cost_reg_net_takes_the_route_it_resolves(route, monkeypatch):
    """The forward asks `costreg_route` once, with its input's device, and
    runs K10's operations (here their CPU twins) exactly when it answers
    "dband"."""
    from mvsnerf_tpu_torch.models import mvsnet as mv
    from mvsnerf_tpu_torch.ops import costreg_conv as k10
    asked, ops = [], []

    def resolved(*args):
        asked.append(args)
        return route

    def counted(name):
        fn = getattr(k10, name)
        monkeypatch.setattr(k10, name, lambda *a: ops.append(name) or fn(*a))

    monkeypatch.setattr(mv, "costreg_route", resolved)
    for name in ("conv3d_fwd", "conv3d_up_op"):
        counted(name)
    torch.manual_seed(0)
    net = mv.CostRegNet(4)
    x = torch.randn(1, 4, 8, 16, 16)
    y = net(x)
    assert y.shape == (1, 8, 8, 16, 16)
    assert asked == [("auto", x.device)]
    assert sorted(ops) == ([] if route == "plain" else
                           ["conv3d_fwd"] * 7 + ["conv3d_up_op"] * 3)
