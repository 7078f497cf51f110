"""K2, the plane-sweep backward, as csrc/sweep.cu `sweep_bwd_kernel`
computes it: tiles of reference columns over runs of planes, a window of
each source image per block in shared memory, and the taps that fall
outside a window added in device memory instead.

On the CPU: a torch emulation of the kernel's tiling (ops/sweep.py's
`BWD_*` constants), its window rule (`bwd_window`, from the taps of the
tile's corner columns at the run's first and last plane), the routing of
every tap into a window or past it, and the windows' flush, on three
small geometries: an ordinary near-rectified rig, where every tap lands
in its block's window; a zoomed source view whose windows pass the
kernel's cap and are cut; and a source camera with the near planes
behind it, whose blocks get no window at all. Each is held to the plain
twin `sweep_cost_volume_bwd_plain` and, through build_cost_volume's
feature and image gradients, to `jax.grad` of JAX's exact gather
(`fast_warp=False`), within TOL_K2 x max|twin| (chip_smoke.py's K2 rule:
the window and device-memory sums run in another order than the twin's).
Also: the Python constants and window cap against the source's.

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest; this file imports JAX only inside the CPU
test that calls it):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_sweep_bwd_tile.py

the kernel against its twin (TOL_K2) and a float64 run of the twin (at
most 5 x the float32 twin's own distance, chip_smoke.py's rule for atomic
sums), on NCDHW and channels_last_3d cotangents, at the DTU shape of
chip_smoke.py and at odd sizes, with its tap counters.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

TOL_K2 = 1e-5
CSRC = Path(__file__).resolve().parents[1] / "mvsnerf_tpu_torch" / "csrc"


def _sw():
    from mvsnerf_tpu_torch.ops import sweep
    return sweep


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


# ------------------------------------------------------ the constants ----

def test_tiling_constants_match_the_source():
    sw = _sw()
    text = (CSRC / "sweep.cu").read_text()
    for name in ("BWD_TX", "BWD_TY", "BWD_YSTEP", "BWD_RUN", "BWD_CG",
                 "BWD_MAX_SRC", "BWD_WIN"):
        assert re.search(rf"constexpr int {name} = {getattr(sw, name)};",
                         text), name
    assert re.search(rf"constexpr int GS = {sw.BWD_GS};", text)
    # a warp a tile row; the 8 corner points of every source view's box
    # fill one warp's lanes
    assert sw.BWD_TX == 32 and 8 * sw.BWD_MAX_SRC == 32
    # the gradient rows and a window pixel's channels are whole float4s
    assert sw.BWD_GS % 4 == 0 and sw.BWD_GS >= 35 and sw.BWD_CG == 8
    # a block's forward and gradient windows: two blocks of the path's two
    # source views fit an SM's 228 KB, four views the 227 KB of one block
    win = 2 * sw.BWD_WIN * sw.BWD_CG * 4
    assert 2 * (2 * win + 1024) <= 228 * 1024
    assert 4 * win <= 227 * 1024


def test_window_rule():
    sw = _sw()
    front = torch.ones(8, dtype=torch.bool)
    ix = torch.tensor([3.2, 40.7, 3.5, 40.1, 9.9, 47.0, 10.2, 46.6])
    iy = torch.tensor([5.5, 5.9, 12.1, 12.3, 5.2, 6.0, 12.0, 13.9])
    # taps floor(x) .. floor(x) + 1, widened by one pixel
    assert sw.bwd_window(ix, iy, front, 32, 64, 768) == (2, 4, 48, 12)
    # clipped to the image
    assert sw.bwd_window(ix, iy, front, 10, 45, 768) == (2, 4, 43, 6)
    # cut: whole rows, or one row of `cap` pixels
    assert sw.bwd_window(ix, iy, front, 32, 64, 256) == (2, 4, 48, 5)
    assert sw.bwd_window(ix, iy, front, 32, 64, 32) == (2, 4, 32, 1)
    # a corner behind the camera, or not finite: no window
    assert sw.bwd_window(ix, iy, torch.arange(8) != 3, 32, 64, 768)[2] == 0
    assert sw.bwd_window(ix.where(torch.arange(8) != 5, torch.tensor(
        math.inf)), iy, front, 32, 64, 768)[2] == 0
    # entirely off the image
    assert sw.bwd_window(ix + 100, iy, front, 32, 64, 768)[2] == 0


# ----------------------------------------------------- the emulation ----

def _coords(proj, depths, h, w, pad):
    """px, py, ix, iy and front of every voxel, (D, hp, wp) each, in
    sweep_coord's operation order (csrc/sweep.cu)."""
    sw = _sw()
    D, hp, wp = len(depths), h + 2 * pad, w + 2 * pad
    px, py = sw.plane_sweep_pix_coords(proj, depths, h, w, pad)
    gy, gx = torch.meshgrid(torch.arange(hp, dtype=torch.float32) - pad,
                            torch.arange(wp, dtype=torch.float32) - pad,
                            indexing="ij")
    z = (proj[2, 0] * gx.reshape(-1) + proj[2, 1] * gy.reshape(-1)
         + proj[2, 2])[None] + proj[2, 3] / depths[:, None]
    half_w = torch.tensor((w - 1) / 2.0)
    half_h = torch.tensor((h - 1) / 2.0)
    ix = (px / half_w - 1.0 + 1.0) / 2.0 * (w - 1)
    iy = (py / half_h - 1.0 + 1.0) / 2.0 * (h - 1)
    return [a.reshape(D, hp, wp) for a in (px, py, ix, iy, z > 0)]


def _emulate_k2(g, srcs, proj_mats, depths, pad, cap=None):
    """K2 as the kernel tiles it, on the CPU. Returns the (V, h, w, 35)
    gradient and counts over the blocks and source views: taps into a
    window ("window") and past it ("outside"), windows cut to the cap
    ("cut"), and windows left empty by a corner behind the camera
    ("behind")."""
    sw = _sw()
    V, h, w, cs = srcs.shape
    C, ns = cs - 3, V - 1
    D = len(depths)
    hp, wp = h + 2 * pad, w + 2 * pad
    cap = cap or sw.BWD_WIN
    gd = g[0].permute(1, 2, 3, 0)                 # (D, hp, wp, 3V + C)
    out = torch.zeros(V, h * w, cs)
    ref = torch.nn.functional.pad(srcs[0], (0, 0, pad, pad, pad, pad))
    co = [_coords(proj_mats[s + 1], depths, h, w, pad) for s in range(ns)]

    # per voxel: the taps of each view, the in-bounds count and the mean
    taps = []       # per view: (pixel (D, hp, wp, 4), weight, in image)
    count = torch.ones(D, hp, wp)
    warped = []
    for s in range(ns):
        px, py, ix, iy, _ = co[s]
        count = count + ((px > 0) & (px < w - 1) & (py > 0) & (py < h - 1))
        hit = (ix > -1) & (ix < w) & (iy > -1) & (iy < h)
        fx, fy = ix.floor(), iy.floor()
        wx = [fx + 1 - ix, ix - fx]
        wy = [fy + 1 - iy, iy - fy]
        xi = [fx.long() + (k & 1) for k in range(4)]
        yi = [fy.long() + (k >> 1) for k in range(4)]
        wt = torch.stack([wx[k & 1] * wy[k >> 1] for k in range(4)], -1)
        inimg = torch.stack([hit & (xi[k] >= 0) & (xi[k] < w) &
                             (yi[k] >= 0) & (yi[k] < h) for k in range(4)],
                            -1)
        pix = torch.stack([yi[k] * w + xi[k] for k in range(4)], -1)
        pix = pix.where(inimg, torch.zeros_like(pix))
        vals = srcs[s + 1].reshape(h * w, cs)[pix]    # (D, hp, wp, 4, cs)
        warped.append((vals * (wt * inimg)[..., None]).sum(3))
        taps.append((pix, wt, inimg))
    inv = 1.0 / count
    mean = (ref[None, ..., :C] + sum(v[..., :C] for v in warped)) * \
        inv[..., None]
    gs = gd[..., 3 * V:] * (2.0 * inv)[..., None]
    # the gradient each view's warp passes to its taps: (D, hp, wp, cs)
    gw = [torch.cat([gs * (warped[s][..., :C] - mean),
                     gd[..., 3 * (s + 1):3 * (s + 1) + 3]], -1)
          for s in range(ns)]
    # the reference view: summed over the planes, the interior only
    gref = torch.cat([(gs * (ref[None, ..., :C] - mean)).sum(0),
                      gd[..., 0:3].sum(0)], -1)
    out[0] += gref[pad:pad + h, pad:pad + w].reshape(h * w, cs)

    n = dict(window=0, outside=0, cut=0, behind=0)
    band = sw.BWD_TY * sw.BWD_YSTEP
    blocks = [(d0, ty0, tx0) for d0 in range(0, D, sw.BWD_RUN)
              for b0 in range(0, hp, band)
              for ty0 in range(b0, b0 + sw.BWD_YSTEP)
              for tx0 in range(0, wp, sw.BWD_TX)]
    for d0, ty0, tx0 in blocks:
        d1 = min(D, d0 + sw.BWD_RUN)
        # every BWD_YSTEP-th row from ty0, BWD_TY of them, below hp
        rows = torch.arange(ty0, min(ty0 + band, hp), sw.BWD_YSTEP)
        if len(rows) == 0:
            continue
        x1 = min(tx0 + sw.BWD_TX, wp)
        blk = (slice(d0, d1), rows, slice(tx0, x1))
        corners = (torch.tensor([d0, d0, d0, d0, d1 - 1, d1 - 1,
                                 d1 - 1, d1 - 1]),
                   torch.tensor([rows[0], rows[0], rows[-1],
                                 rows[-1]] * 2),
                   torch.tensor([tx0, x1 - 1] * 4))
        for s in range(ns):
            _, _, ix, iy, front = co[s]
            x0, y0, bw, bh = sw.bwd_window(
                ix[corners], iy[corners], front[corners], h, w, cap)
            n["behind"] += not bool(front[corners].all())
            n["cut"] += bw > 0 and (bw, bh) != sw.bwd_window(
                ix[corners], iy[corners], front[corners], h, w,
                h * w)[2:]
            pix, wt, inimg = (a[blk].reshape(-1, 4)
                              for a in taps[s])
            contrib = (gw[s][blk].reshape(-1, 1, cs) *
                       wt[..., None])           # (n, 4, cs)
            lx, ly = pix % w - x0, pix // w - y0
            inwin = inimg & (lx >= 0) & (lx < bw) & (ly >= 0) & \
                (ly < bh)
            outwin = inimg & ~inwin
            n["window"] += int(inwin.sum())
            n["outside"] += int(outwin.sum())
            window = torch.zeros(max(bw * bh, 1), cs)
            window.index_add_(0, (ly * bw + lx)[inwin],
                              contrib[inwin])
            out[s + 1].index_add_(0, pix[outwin], contrib[outwin])
            if bw:  # the flush: every window pixel, once
                wy_, wx_ = torch.meshgrid(
                    torch.arange(bh) + y0, torch.arange(bw) + x0,
                    indexing="ij")
                out[s + 1].index_add_(
                    0, (wy_ * w + wx_).reshape(-1), window)
    return out.reshape(V, h, w, cs), n


def _rig(h, w, d, near, far, zoom=1.0, forward=0.0, baseline=0.05):
    """A 3-view rig at feature resolution: view 1 shifted along x, view 2
    shifted and turned, with `zoom` x its focal and moved `forward` along
    its optical axis. Returns (projs (3, 3, 4), depths)."""
    intr = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]],
                    np.float32)
    ref4 = np.eye(4, dtype=np.float32)
    ref4[:3] = intr @ np.eye(4)[:3]
    projs = []
    for i in range(3):
        a = 0.03 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = [baseline * i + 0.007, 0.003, 0.0]
        k = intr.copy()
        if i == 2:
            k[:2, :2] *= zoom
            w2c[2, 3] -= forward
        p4 = np.eye(4, dtype=np.float32)
        p4[:3] = k @ w2c[:3]
        projs.append((p4 @ np.linalg.inv(ref4))[:3])
    depths = np.linspace(near, far, d).astype(np.float32)
    return np.stack(projs).astype(np.float32), depths


# name -> (h, w, pad, D, rig keywords)
GEOMETRIES = {
    "ordinary": (24, 40, 4, 40, dict(near=2.0, far=5.0)),
    "window_cut": (40, 72, 2, 34, dict(near=1.5, far=6.0, zoom=2.5,
                                       baseline=0.3)),
    "behind_camera": (20, 36, 3, 36, dict(near=0.6, far=4.0, forward=1.5)),
}


def _inputs(name, seed=0):
    h, w, pad, d, kw = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    projs, depths = _rig(h, w, d, **kw)
    srcs = rng.standard_normal((3, h, w, 35)).astype(np.float32)
    g = rng.standard_normal((1, 41, d, h + 2 * pad, w + 2 * pad)).astype(
        np.float32)
    return g, srcs, projs, depths, pad


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_emulated_tiling_meets_tol_k2_against_the_twin(name):
    g, srcs, projs, depths, pad = _inputs(name)
    got, n = _emulate_k2(t(g), t(srcs), t(projs), t(depths), pad)
    twin = _sw().sweep_cost_volume_bwd_plain(t(g), t(srcs), t(projs),
                                             t(depths), pad, 32)
    tol = TOL_K2 * float(twin.abs().max())
    assert float((got - twin).abs().max()) <= tol
    # every view, every channel kind gets a gradient
    assert all(float(twin[v, ..., c].abs().max()) > 0
               for v in range(3) for c in (0, 31, 32, 34))
    # the geometry takes the route it is named for
    assert n["window"] > 0
    if name == "ordinary":
        assert n["outside"] == n["cut"] == n["behind"] == 0
    elif name == "window_cut":
        assert n["cut"] > 0 and n["outside"] > 0 and n["behind"] == 0
    else:
        assert n["behind"] > 0 and n["outside"] > 0 and n["cut"] == 0


def _grads_through_build_cost_volume(monkeypatch, name, bwd):
    """d feats and d imgs of sum(cost^2 + 0.3 cost) through the port's
    build_cost_volume, with K2 computed by `bwd` (the card's autograd
    Function, its forward the plain twin)."""
    from mvsnerf_tpu_torch.ops import homography
    sw = _sw()
    h, w, pad, d, kw = GEOMETRIES[name]
    rng = np.random.default_rng(5)
    projs, depths = _rig(h, w, d, **kw)
    feats = rng.standard_normal((3, h, w, 32)).astype(np.float32)
    imgs = rng.uniform(0, 1, (3, 4 * h, 4 * w, 3)).astype(np.float32)

    def fwd(srcs, proj_mats, depth_values, pad_, c_feat):
        with torch.no_grad():
            return sw.sweep_cost_volume_plain(srcs, proj_mats, depth_values,
                                              pad_, c_feat)

    def k2(g, srcs, proj_mats, depth_values, pad_, c_feat):
        return bwd(g, srcs, proj_mats, depth_values, pad_)

    monkeypatch.setattr(sw, "sweep_cost_volume_kernel", fwd)
    monkeypatch.setattr(sw, "sweep_cost_volume_bwd_kernel", k2)
    monkeypatch.setattr(homography, "sweep_cost_volume",
                        sw._SweepCostVolume.apply)
    f, im = t(feats).requires_grad_(), t(imgs).requires_grad_()
    cost = homography.build_cost_volume(im, f, t(projs), t(depths), pad=pad)
    torch.sum(cost ** 2 + 0.3 * cost).backward()
    return (f.grad.numpy(), im.grad.numpy()), (feats, imgs, projs, depths,
                                               pad)


def _jax_exact(feats, imgs, projs, depths, pad):
    import jax
    import jax.numpy as jnp
    from mvsnerf_tpu.ops.homography import build_cost_volume

    def loss(f, im):
        cost = build_cost_volume(im, f, jnp.asarray(projs),
                                 jnp.asarray(depths), pad=pad,
                                 fast_warp=False)[0]
        return jnp.sum(cost ** 2 + 0.3 * cost)

    return [np.asarray(a) for a in jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(imgs))]


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_emulated_tiling_matches_jax_exact_gather(monkeypatch, name):
    """The emulated kernel's feature and image gradients (the image's
    through the resize's backward) against JAX's, and the plain twin's
    against JAX's, each within TOL_K2 x max|JAX|."""
    sw = _sw()
    ours, inputs = _grads_through_build_cost_volume(
        monkeypatch, name,
        lambda g, *a: _emulate_k2(g, *a)[0])
    twin, _ = _grads_through_build_cost_volume(
        monkeypatch, name,
        lambda g, *a: sw.sweep_cost_volume_bwd_plain(g, *a, 32))
    refs = _jax_exact(*inputs)
    for o, p, r, what in zip(ours, twin, refs, ("d feats", "d imgs")):
        assert np.abs(r).max() > 0, what
        tol = TOL_K2 * np.abs(r).max()
        np.testing.assert_allclose(p, r, rtol=0, atol=tol, err_msg=what)
        np.testing.assert_allclose(o, r, rtol=0, atol=tol, err_msg=what)


def test_kernel_refuses_more_source_views_than_it_holds():
    sw = _sw()
    with pytest.raises(ValueError, match="5 source views, at most 4"):
        sw.sweep_cost_volume_bwd_kernel(
            torch.zeros(1, 50, 4, 10, 10), torch.zeros(6, 8, 8, 35),
            torch.zeros(6, 3, 4), torch.zeros(4), 1, 32)


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_sweep_bwd_tile.py`")
    return torch.device("cuda", 0)


def _card_rig(card, h, w, d, near, far, focal):
    """chip_smoke.py's camera rig (bench.py:208-234) at feature
    resolution: the reference and two sources 0.3 apart, turned by 0.04
    rad each."""
    intr = np.array([[focal / 4, 0, 2 * w], [0, focal / 4, 2 * h],
                     [0, 0, 1]], np.float32)
    p4 = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    for i in range(3):
        a = 0.04 * (i - 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]]
        m[:3, 3] = [0.3 * (i - 1), 0.0, 0.0]
        p4[i, :3] = intr @ m[:3]
    projs = (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32)
    return (torch.tensor(projs, device=card),
            torch.linspace(near, far, d, device=card))


# (h, w, pad, D, near, far, focal): chip_smoke.py's DTU shape, and odd ones
CARD_CASES = [(128, 160, 24, 128, 2.125, 4.525, 722.0),
              (37, 53, 3, 45, 2.0, 6.0, 300.0),
              (9, 70, 5, 33, 1.0, 3.0, 500.0),
              (64, 31, 0, 7, 2.125, 4.525, 722.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["x".join(map(str, c[:4])) for c in CARD_CASES])
@pytest.mark.parametrize("fmt", ["NCDHW", "channels_last_3d"])
def test_kernel_matches_twin_and_float64_on_the_card(card, case, fmt):
    sw = _sw()
    h, w, pad, d, near, far, focal = case
    proj, depths = _card_rig(card, h, w, d, near, far, focal)
    gen = torch.Generator(device=card).manual_seed(h * w + d)
    srcs = torch.randn(3, h, w, 35, generator=gen, device=card)
    g = torch.randn(1, 41, d, h + 2 * pad, w + 2 * pad, generator=gen,
                    device=card)
    if fmt == "channels_last_3d":
        g = g.contiguous(memory_format=torch.channels_last_3d)
    args = (srcs, proj, depths, pad, 32)
    taps = torch.zeros(2, dtype=torch.int64, device=card)
    before = sw.sweep_cost_volume.bwd_launches
    got = sw.sweep_cost_volume_bwd_kernel(g, *args, taps=taps)
    torch.cuda.synchronize()
    assert sw.sweep_cost_volume.bwd_launches == before + 1
    assert got.shape == (3, h, w, 35)
    twin = sw.sweep_cost_volume_bwd_plain(g, *args)
    tol = TOL_K2 * float(twin.abs().max())
    assert float((got - twin).abs().max()) <= tol
    # against float64 by chip_smoke.py's rule for atomic sums (TOL_K4_BWD):
    # at most 5 x the float32 twin's own distance from it
    ref = sw.sweep_cost_volume_bwd_plain(
        g.double(), srcs.double(), proj.double(), depths.double(), pad, 32)
    own = max(float((twin.double() - ref).abs().max()),
              1e-6 * float(ref.abs().max()))
    assert float((got.double() - ref).abs().max()) <= 5 * own
    # a view gets a gradient wherever the twin gives it one
    assert [bool(got[v].abs().max() > 0) for v in range(3)] == \
        [bool(twin[v].abs().max() > 0) for v in range(3)]
    # every in-image feature tap counted once: 4 per hit (voxel, view)
    assert int(taps.sum()) > 0 and int(taps[1]) <= int(taps.sum())
