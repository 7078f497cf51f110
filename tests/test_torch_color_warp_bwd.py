"""K4's backward (the render's gradient in its source images) and the two
entry-point repairs that came with it, against the JAX package on the CPU.

- The warp's VJP in `imgs`: the port's `color_warp` (its plain twin on the
  CPU, `grid_sample`'s backward) against `jax.vjp` of JAX's
  `build_color_volume(mode="pallas")`, whose image cotangent is the Pallas
  `_bwd_kernel` in interpret mode (pallas_sweep.py:147) when the band
  contract holds, which the test asserts. 3 views of 48x64, 128 samples a
  ray, a share of them outside the images (border taps), a random
  cotangent on all 4V channels. Tolerance abs and rel 1e-4, as JAX's own
  test of that kernel (tests/test_pallas_sweep.py:52-68): the banded
  one-hot matmuls sum in another order than `grid_sample`'s scatter.
- The render as a whole: d(MSE of rgb) / d imgs through the port's
  `render_rays(training=True, twins=True)` against `jax.grad` through
  JAX's `render_rays(color_warp_mode="pallas", mlp_impl="xla")` (the XLA
  MLP returns true input gradients: ROADMAP, K7's gradient contract), on
  weights carried over by a reference-format checkpoint. Rays with a sample
  within KINK of a ReLU kink are left out (test_torch_finetune.py's rule).
  Tolerance abs 1e-4 x max|g|, the fine-tune gradients' rule.
- The gradient contract: `color_warp` refuses a gradient in the geometry;
  the twin stays differentiable; the card's autograd wiring (kernels
  replaced by the twins) gives the twin's image gradient.
- `render_video --ckpt` restores exactly the named snapshot.
- `--use_disp` in the Evaluator, in every render mode, against JAX's
  Evaluator with `use_disp` (metric tolerances of test_torch_eval.py).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_common import jax_params, port_modules, \
    port_modules_via_checkpoint, t

RNG = np.random.default_rng(21)
V, H, W, S = 3, 48, 64, 128
BAND = 32  # build_color_volume's default pallas band
NEAR, FAR = 2.0, 5.0
KINK = 5e-6


def _views():
    """3 cameras turned about y and shifted along x (epipolar lines close
    to the image rows, so each ray's samples span few source rows)."""
    imgs = RNG.uniform(0, 1, (V, H, W, 3)).astype(np.float32)
    intr = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1]],
                    np.float32)
    w2cs = []
    for i in range(V):
        a = 0.05 * (i - 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.2 * (i - 1), 0.01 * i, 0.0]
        w2cs.append(m)
    return imgs, np.stack(w2cs), np.stack([intr] * V)


def _rays(w2c, intr, us, vs):
    """(N, 8) rays through pixels (us, vs) of the camera `w2c`."""
    c2w = np.linalg.inv(w2c)
    d = np.stack([(us - intr[0, 2]) / intr[0, 0],
                  (vs - intr[1, 2]) / intr[1, 1], np.ones_like(us)], -1)
    d = d @ c2w[:3, :3].T
    o = np.broadcast_to(c2w[:3, 3], d.shape)
    nf = np.broadcast_to([NEAR, FAR], (len(us), 2))
    return np.concatenate([o, d, nf], -1).astype(np.float32)


def _samples(rays):
    """JAX's samples of `rays` (perturb 0): pts (N, S, 3), rays_d, z."""
    from mvsnerf_tpu.ops.sampling import ray_marcher
    pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0),
                                    jnp.asarray(rays), S, perturb=0.0)
    return np.asarray(pts), np.asarray(rays_d), np.asarray(z)


def _assert_pallas_band(pts, w2cs, intrs):
    """The band contract of build_color_volume's pallas route holds for
    every view (else its lax.cond takes the gather route instead of the
    Pallas backward)."""
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.pallas_sweep import sweep_fits_band
    inv_scale = jnp.asarray([W - 1.0, H - 1.0])
    for v in range(V):
        ndc = get_ndc_coordinate(jnp.asarray(w2cs[v]), jnp.asarray(intrs[v]),
                                 jnp.asarray(pts), inv_scale, near=1.0,
                                 far=2.0)
        grid = jnp.clip(ndc[..., :2] * 2.0 - 1.0, -1.0, 1.0)
        assert bool(sweep_fits_band(grid, H, 1, BAND)), v


# ------------------------------------------------------------ the warp ---

def test_warp_vjp_in_imgs_matches_jax_pallas_backward():
    from mvsnerf_tpu.render.renderer import build_color_volume
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    imgs, w2cs, intrs = _views()
    # rays of view 0 through pixels inside and around the image: their
    # samples leave the other views' frames (border taps, mask 0)
    us = np.array([3.0, 20.5, 40.2, 60.7, -6.0, 70.0, 31.3, 62.0])
    vs = np.array([5.5, 24.1, 40.7, 2.2, 20.0, 30.0, -3.0, 50.0])
    pts = _samples(_rays(w2cs[0], intrs[0], us, vs))[0]
    _assert_pallas_band(pts, w2cs, intrs)
    g = RNG.standard_normal((len(us), S, 4 * V)).astype(np.float32)

    ref_out, vjp = jax.vjp(
        lambda im: build_color_volume(jnp.asarray(pts), jnp.asarray(w2cs),
                                      jnp.asarray(intrs), im, with_mask=True,
                                      mode="pallas"), jnp.asarray(imgs))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    im = t(imgs).requires_grad_()
    out = color_warp(t(pts), t(w2cs), t(intrs), im)
    ours, = torch.autograd.grad(out, im, t(g))
    masks = out.detach().numpy()[..., 3::4]
    assert 0.05 < (masks == 0).mean() < 0.95
    np.testing.assert_array_equal(masks, np.asarray(ref_out)[..., 3::4])
    assert (np.abs(ref) > 0).mean() > 0.01
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ the render --

@pytest.fixture(scope="module")
def render_case(tmp_path_factory):
    """A seeded volume and views, JAX weights carried to the port through
    a reference-format checkpoint, rays of a camera near view 0 clear of
    the MLP's ReLU kinks, and JAX's image gradient of their MSE."""
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    from mvsnerf_tpu_torch.render.renderer import gen_dir_feature, \
        gen_pts_feats, network_input
    imgs, w2cs, intrs = _views()
    mlp_p, mvs_p = jax_params(5)
    mlp, _ = port_modules_via_checkpoint(
        mlp_p, mvs_p, tmp_path_factory.mktemp("ck") / "ref.tar")
    volume = (RNG.standard_normal((16, 12, 16, 8)) * 0.5).astype(np.float32)
    tgt = w2cs[0].copy()
    tgt[0, 3] += 0.05
    n = 256
    rays = _rays(tgt, intrs[0], RNG.uniform(2, W - 3, n),
                 RNG.uniform(2, H - 3, n))
    pts, rays_d, z = _samples(rays)
    ndc = np.asarray(get_ndc_coordinate(
        jnp.asarray(w2cs[0]), jnp.asarray(intrs[0]), jnp.asarray(pts),
        jnp.asarray([W - 1.0, H - 1.0]), near=NEAR, far=FAR))
    with torch.no_grad():
        feats = gen_pts_feats(t(volume), t(ndc), t(pts), t(w2cs), t(intrs),
                              t(imgs))
        unit = t(rays_d) / torch.linalg.norm(t(rays_d), dim=-1, keepdim=True)
        x = network_input(t(ndc), gen_dir_feature(t(w2cs[0]), unit), feats)
    margin = relu_margin(mlp, x).reshape(n, -1).amin(1).numpy()
    keep = np.flatnonzero(margin > KINK)[:24]
    assert len(keep) == 24
    pts, rays_d, z, ndc = pts[keep], rays_d[keep], z[keep], ndc[keep]
    _assert_pallas_band(pts, w2cs, intrs)
    rgbs = RNG.uniform(0, 1, (len(keep), 3)).astype(np.float32)

    def loss(im):
        out = render_rays(mlp_p, jnp.asarray(volume), jnp.asarray(pts),
                          jnp.asarray(ndc), jnp.asarray(z),
                          jnp.asarray(rays_d), w2c_ref=jnp.asarray(w2cs[0]),
                          w2cs=jnp.asarray(w2cs), intrinsics=jnp.asarray(intrs),
                          imgs=im, color_warp_mode="pallas", mlp_impl="xla")
        return jnp.mean((out["rgb"] - rgbs) ** 2)

    ref = np.asarray(jax.grad(loss)(jnp.asarray(imgs)))
    return dict(mlp=mlp, volume=volume, imgs=imgs, w2cs=w2cs, intrs=intrs,
                pts=pts, rays_d=rays_d, z=z, ndc=ndc, rgbs=rgbs, ref=ref)


def test_render_image_gradient_matches_jax(render_case):
    from mvsnerf_tpu_torch.render.renderer import render_rays
    c = render_case
    im = t(c["imgs"]).requires_grad_()
    out = render_rays(c["mlp"], t(c["volume"]), t(c["pts"]), t(c["ndc"]),
                      t(c["z"]), t(c["rays_d"]), t(c["w2cs"][0]),
                      t(c["w2cs"]), t(c["intrs"]), im, training=True,
                      twins=True)
    loss = torch.mean((out["rgb"] - t(c["rgbs"])) ** 2)
    ours, = torch.autograd.grad(loss, im)
    ref = c["ref"]
    assert (np.abs(ref) > 0).mean() > 0.005
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


# ---------------------------------------------------- gradient contract --

@pytest.mark.parametrize("which", ["pts_world", "w2cs", "intrinsics"])
def test_color_warp_refuses_a_geometry_gradient(which):
    from mvsnerf_tpu_torch.ops.color_warp import color_warp
    imgs, w2cs, intrs = _views()
    args = {"pts_world": t(_samples(_rays(w2cs[0], intrs[0],
                                          np.array([10.0]),
                                          np.array([12.0])))[0]),
            "w2cs": t(w2cs), "intrinsics": t(intrs)}
    args[which].requires_grad_()
    with pytest.raises(NotImplementedError, match=which):
        color_warp(**args, imgs=t(imgs))
    with torch.no_grad():  # nothing is asked for there
        assert color_warp(**args, imgs=t(imgs)).shape == (1, S, 4 * V)


def test_twin_stays_differentiable_in_every_input():
    from mvsnerf_tpu_torch.ops.color_warp import color_warp_plain
    imgs, w2cs, intrs = _views()
    pts = _samples(_rays(w2cs[0], intrs[0], np.array([10.0, 30.0]),
                         np.array([12.0, 30.0])))[0]
    ins = [t(a).requires_grad_() for a in (pts, w2cs, intrs, imgs)]
    out = color_warp_plain(*ins)
    grads = torch.autograd.grad(out[..., :3].sum(), ins)
    assert all(bool(g.abs().max() > 0) for g in grads)


def test_cuda_route_is_a_function_with_the_k4_backward(monkeypatch):
    """The card's autograd wiring, with both launches replaced by the
    twins (no card here): the image gradient is the twin's, the backward
    gets the forward's geometry and a contiguous cotangent, and the
    geometry gets no gradient."""
    from mvsnerf_tpu_torch.ops import color_warp as cw
    seen = {}

    def fwd(pts, w2cs, intrs, imgs):
        with torch.no_grad():
            return cw.color_warp_plain(pts, w2cs, intrs, imgs)

    def bwd(g, pts, w2cs, intrs, img_shape):
        seen.update(contiguous=g.is_contiguous(), shape=img_shape)
        return cw.color_warp_bwd_plain(g, pts, w2cs, intrs,
                                       torch.zeros(img_shape))

    monkeypatch.setattr(cw, "color_warp_kernel", fwd)
    monkeypatch.setattr(cw, "color_warp_bwd_kernel", bwd)
    imgs, w2cs, intrs = _views()
    pts = t(_samples(_rays(w2cs[0], intrs[0], np.array([5.0, 33.0, 70.0]),
                           np.array([4.0, 20.0, 10.0])))[0])
    im = t(imgs).requires_grad_()
    out = cw._ColorWarp.apply(pts, t(w2cs), t(intrs), im)
    g = torch.randn(out.shape[::-1], generator=torch.Generator()
                    .manual_seed(0)).permute(2, 1, 0)  # not contiguous
    ours, = torch.autograd.grad(out, im, g)
    assert seen == {"contiguous": True, "shape": im.shape}
    ref = cw.color_warp_bwd_plain(g, pts, t(w2cs), t(intrs), t(imgs))
    assert torch.equal(ours, ref) and bool(ref.abs().max() > 0)


# ------------------------------------------------- render_video --ckpt ---

def test_render_video_restores_exactly_the_named_snapshot(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    """Two snapshots in the experiment's directory; `--ckpt` names the
    older, and its step and weights are what render (the root
    render_video.py:27-32 rule). A named snapshot that does not exist
    raises."""
    import sys
    from mvsnerf_tpu.io.torch_ckpt import export_reference_checkpoint
    from mvsnerf_tpu_torch import render_video as cli
    from mvsnerf_tpu_torch.config import config_parser
    from mvsnerf_tpu_torch.data.dtu_ft import DTUFTDataset
    from mvsnerf_tpu_torch.train.finetune import FinetuneSystem
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "scripts"))
    try:
        from make_synthetic_scene import make_scene
    finally:
        sys.path.pop(0)
    make_scene(str(tmp_path / "dtu"))
    ref_ckpt = str(tmp_path / "seeded.tar")
    export_reference_checkpoint(ref_ckpt, *jax_params(0))
    monkeypatch.chdir(tmp_path)
    flags = ["--dataset_name", "dtu_ft", "--datadir",
             str(tmp_path / "dtu" / "scan1"), "--expname", "vid",
             "--imgScale_train", "0.1", "--pad", "4", "--N_samples", "8",
             "--device", "cpu"]
    args = config_parser(flags + ["--ckpt", ref_ckpt])
    system = FinetuneSystem(args, DTUFTDataset(args, "train"), device="cpu")
    ckpt_dir = os.path.join("runs_fine_tuning", "vid", "ckpts")
    older = system.save(ckpt_dir, 1)
    want = {k: v.clone() for k, v in system.mlp.state_dict().items()}
    want_volume = system.volume.detach().clone()
    with torch.no_grad():
        for p in [*system.mlp.parameters(), system.volume]:
            p.add_(1.0)
    system.save(ckpt_dir, 2)

    rendered = {}

    def render_video(system, poses, *a, **kw):
        rendered["system"] = system
        return []

    render_video.last_path = None
    monkeypatch.setattr(cli, "render_video", render_video)
    cli.main(flags + ["--ckpt", older])
    assert f"restored {older} (step 1)" in capsys.readouterr().out
    got = rendered["system"]
    for k, v in got.mlp.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(got.volume.detach(), want_volume)
    with pytest.raises(FileNotFoundError):
        cli.main(flags + ["--ckpt", os.path.join(ckpt_dir, "none.pt")])


# --------------------------------------------------------- --use_disp ---

@pytest.fixture(scope="module")
def disp_case():
    """JAX's Evaluator with `--use_disp` on test_torch_eval.py's DepthScene
    (chunked), and for `tiled` the JAX metrics of JAX's exact render over
    its baked volume with samples and NDC linear in disparity, as JAX's
    tiled renderer takes them (tiled.py:169, 176)."""
    from test_torch_eval import N_EVAL_SAMPLES, DepthScene
    from test_train import PAD
    from mvsnerf_tpu.config import config_parser
    from mvsnerf_tpu.eval import metrics as jm
    from mvsnerf_tpu.eval.evaluate import Evaluator
    from mvsnerf_tpu.ops.geometry import get_ndc_coordinate
    from mvsnerf_tpu.ops.sampling import ray_marcher
    from mvsnerf_tpu.render.renderer import render_rays
    from mvsnerf_tpu.render.tiled import bake_color_volume
    ds = DepthScene()
    mlp_p, mvs_p = jax_params(4)
    args = config_parser(cmd=f"--pad {PAD} --N_samples {N_EVAL_SAMPLES} "
                             "--dataset_name llff --use_disp")
    ev = Evaluator(args, ds, mvs_p, mlp_p)
    ref = ev.evaluate(chunk=512)
    volume, imgs, nf, pose = ev.build_volume()
    vol20 = bake_color_volume(volume, imgs, pose, nf, PAD)
    h, w = imgs.shape[1:3]
    tiled = []
    for i in range(len(ds)):
        s = ds[i]
        pts, _, rays_d, z = ray_marcher(jax.random.PRNGKey(0),
                                        jnp.asarray(s["rays"]),
                                        N_EVAL_SAMPLES, perturb=0.0,
                                        lindisp=True)
        ndc = get_ndc_coordinate(pose["w2cs"][0], pose["intrinsics"][0],
                                 pts, jnp.asarray([w - 1.0, h - 1.0]),
                                 near=nf[0], far=nf[1], pad=PAD,
                                 lindisp=True)
        out = render_rays(mlp_p, vol20, None, ndc, z, rays_d,
                          w2c_ref=pose["w2cs"][0], use_color_volume=True)
        pred = np.clip(np.asarray(out["rgb"]).reshape(h, w, 3), 0, 1)
        depth = np.asarray(out["depth"]).reshape(h, w)
        mask = s["depth"] > 0
        row = {"psnr": float(jm.psnr(pred, s["rgbs"], jnp.asarray(mask))),
               "ssim": float(jm.ssim(pred, s["rgbs"])),
               "abs_err": float(np.sum(np.asarray(jm.abs_error(
                   depth, s["depth"], mask))) / mask.sum())}
        for th in (0.01, 0.05, 0.1):
            row[f"acc_{th}"] = float(jm.acc_threshold(
                jnp.asarray(depth), jnp.asarray(s["depth"]),
                jnp.asarray(mask), th))
        tiled.append(row)
    return dict(ds=ds, params=(mlp_p, mvs_p), pad=PAD,
                ref=ref["per_image"], tiled_ref=tiled,
                n_samples=N_EVAL_SAMPLES)


@pytest.mark.parametrize("mode", ["chunked", "hybrid", "tiled"])
def test_evaluate_use_disp_matches_jax(disp_case, mode):
    from test_torch_eval import _compare_rows
    from mvsnerf_tpu_torch.eval.evaluate import Evaluator
    c = disp_case
    mlp, mvsnet = port_modules(*c["params"])
    ours = Evaluator(mvsnet, mlp, n_samples=c["n_samples"], pad=c["pad"],
                     chunk=300, device="cpu", lindisp=True)
    plain = Evaluator(mvsnet, mlp, n_samples=c["n_samples"], pad=c["pad"],
                      chunk=300, device="cpu")
    out = ours.evaluate(c["ds"], mode=mode)["per_image"]
    refs = c["tiled_ref"] if mode == "tiled" else c["ref"]
    n_pixels = c["ds"].depth[0].size
    assert len(out) == len(refs) == 2
    for row, ref in zip(out, refs):
        _compare_rows(row, ref, n_pixels)
    # the flag changes the render: without it the depths move
    base = plain.evaluate(c["ds"], mode=mode)["per_image"]
    assert any(abs(a["abs_err"] - b["abs_err"]) > 1e-3
               for a, b in zip(out, base))
