"""K1, the plane-sweep cost volume, as csrc/sweep.cu `sweep_kernel`
computes it: the sources laid out quad-planar (`pack_quads`, the layout
`sweep_pack_kernel` writes), blocks of reference columns over runs of
planes, one channel group a block, each tap's 4 channels of a group read
as one quad.

On the CPU: a torch emulation of the kernel's reads from that layout and
of its tiling (ops/sweep.py's `SW_*` constants), every output value
written by exactly one block, held to the plain twin
`sweep_cost_volume_plain` within TOL_K1 x (1 + max|twin|) (chip_smoke.py's
rule for K1), and, through build_cost_volume, to JAX's cost volume (the
dense path and the interpret-mode Pallas sweep of tests/test_torch_sweep.py)
at the same tolerance; on the scenes of tests/test_torch_sweep.py, at
sizes that are not multiples of the tiles, and with 2 and 4 views. Also:
the Python constants against the source's.

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest; this file imports JAX only inside the CPU
tests that call it):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_sweep_quads.py

the kernel against its twin at TOL_K1, at the DTU shape of chip_smoke.py
and at odd sizes (w and h not multiples of 4, V = 2 and 4).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

TOL_K1 = 1e-5
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
    for name in ("SW_TX", "SW_TY", "SW_RUN", "SW_CG", "SW_QUADS"):
        assert re.search(rf"constexpr int {name} = {getattr(sw, name)};",
                         text), name
    # a warp a row of the block; a group is whole quads; the quads hold
    # the 35 channels and the rgb ones in a quad of their own
    assert sw.SW_TX == 32 and sw.SW_CG % 4 == 0 and 32 % sw.SW_CG == 0
    assert 4 * sw.SW_QUADS >= 35 and 4 * (sw.SW_QUADS - 1) == 32


def test_pack_quads_is_the_kernels_layout():
    """Quad q of pixel (y, x) of view v holds its channels 4 q .. 4 q + 3;
    the ninth [r, g, b, 0]; each quad a plane of its own."""
    sw = _sw()
    srcs = torch.randn(3, 5, 7, 35, generator=torch.Generator()
                       .manual_seed(3))
    p = sw.pack_quads(srcs)
    assert p.shape == (3, sw.SW_QUADS, 5, 7, 4) and p.is_contiguous()
    for q in range(sw.SW_QUADS - 1):
        assert torch.equal(p[:, q], srcs[..., 4 * q:4 * q + 4])
    assert torch.equal(p[:, 8, ..., :3], srcs[..., 32:])
    assert not p[:, 8, ..., 3].any()


# ----------------------------------------------------- the emulation ----

def _taps(proj, depths, h, w, pad):
    """The bilinear taps of every voxel in one source view, (D, hp, wp)
    each, by the twin's (and the kernel's) coordinate arithmetic: the
    strict in-bounds mask, the 4 tap pixels and whether each lies in the
    image, and the 4 weights."""
    sw = _sw()
    D, hp, wp = len(depths), h + 2 * pad, w + 2 * pad
    px, py = sw.plane_sweep_pix_coords(proj, depths, h, w, pad)
    half_w = torch.tensor((w - 1) / 2.0)
    half_h = torch.tensor((h - 1) / 2.0)
    ix = ((px / half_w - 1.0 + 1.0) / 2.0 * (w - 1)).reshape(D, hp, wp)
    iy = ((py / half_h - 1.0 + 1.0) / 2.0 * (h - 1)).reshape(D, hp, wp)
    px, py = px.reshape(D, hp, wp), py.reshape(D, hp, wp)
    inside = (px > 0) & (px < w - 1) & (py > 0) & (py < h - 1)
    hit = (ix > -1) & (ix < w) & (iy > -1) & (iy < h)
    fx, fy = ix.floor(), iy.floor()
    wx = [fx + 1 - ix, ix - fx]
    wy = [fy + 1 - iy, iy - fy]
    pix, inimg, wt = [], [], []
    for k in range(4):
        xi, yi = fx.long() + (k & 1), fy.long() + (k >> 1)
        ok = hit & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        pix.append(torch.where(ok, yi * w + xi, torch.zeros_like(xi)))
        inimg.append(ok)
        wt.append(wx[k & 1] * wy[k >> 1])
    return inside, pix, inimg, wt


def _group_values(packed, taps, V, h, w, pad, D, group):
    """One channel group's output channels for every voxel, as a block of
    that group computes them: its quads of each tap, one quad a read,
    accumulated by fmaf in tap order; the variance from per-channel sums
    in view order. Returns (channels, D, hp, wp) and the output channels
    they are."""
    sw = _sw()
    hp, wp = h + 2 * pad, w + 2 * pad
    C = 32
    ref = torch.nn.functional.pad(packed[0].permute(1, 2, 0, 3),
                                  (0, 0, 0, 0, pad, pad, pad, pad))
    ref = ref.reshape(hp, wp, -1)                   # (hp, wp, 36)

    def warp(s, quads):
        # the taps of view s + 1 read from its packed quads: (D, hp, wp, 4 q)
        _, pix, inimg, wt = taps[s]
        src = packed[s + 1][quads].permute(1, 2, 0, 3).reshape(h * w, -1)
        val = torch.zeros(D, hp, wp, src.shape[-1])
        for k in range(4):
            f = src[pix[k]] * inimg[k][..., None]
            val = torch.addcmul(val, f, wt[k][..., None])
        return val

    if group == C // sw.SW_CG:          # the rgb group
        out = [ref[..., 32:35].expand(D, hp, wp, 3)]
        for s in range(V - 1):
            out.append(warp(s, [sw.SW_QUADS - 1])[..., :3])
        return torch.cat(out, -1).permute(3, 0, 1, 2), list(range(3 * V))
    qg = sw.SW_CG // 4
    quads = list(range(qg * group, qg * group + qg))
    r = ref[..., 4 * quads[0]:4 * quads[0] + sw.SW_CG]
    vsum, vsq = r.expand(D, hp, wp, -1), (r * r).expand(D, hp, wp, -1)
    count = torch.ones(D, hp, wp)
    for s in range(V - 1):
        val = warp(s, quads)
        vsum, vsq = vsum + val, vsq + val * val
        count = count + taps[s][0]
    inv = (1.0 / count)[..., None]
    var = vsq * inv - (vsum * inv) ** 2
    c0 = 3 * V + sw.SW_CG * group
    return var.permute(3, 0, 1, 2), list(range(c0, c0 + sw.SW_CG))


def _emulate_k1(srcs, proj_mats, depths, pad):
    """K1 as the kernel lays out its sources and tiles its output, on the
    CPU: the (1, 3V + 32, D, hp, wp) cost volume, and how many times each
    of its values was written (1 everywhere, or a block overlapped or
    missed)."""
    sw = _sw()
    V, h, w, _ = srcs.shape
    D = len(depths)
    hp, wp = h + 2 * pad, w + 2 * pad
    packed = sw.pack_quads(srcs)
    taps = [_taps(proj_mats[s + 1], depths, h, w, pad) for s in range(V - 1)]
    out = torch.zeros(1, 3 * V + 32, D, hp, wp)
    written = torch.zeros(3 * V + 32, D, hp, wp, dtype=torch.int64)
    for group in range(32 // sw.SW_CG + 1):      # blockIdx.y
        vals, chans = _group_values(packed, taps, V, h, w, pad, D, group)
        cs = slice(chans[0], chans[-1] + 1)
        for d0 in range(0, D, sw.SW_RUN):        # blockIdx.x
            for y0 in range(0, hp, sw.SW_TY):
                for x0 in range(0, wp, sw.SW_TX):
                    blk = (slice(d0, d0 + sw.SW_RUN),
                           slice(y0, y0 + sw.SW_TY),
                           slice(x0, x0 + sw.SW_TX))
                    out[(0, cs, *blk)] = vals[(slice(None), *blk)]
                    written[(cs, *blk)] += 1
    return out, written


def _rig(h, w, V, d, near=2.0, far=5.0):
    """tests/test_torch_sweep.py's near-rectified rig at (h, w) with V
    views: view i shifted along x and turned about y."""
    intr = np.array([[1.2 * w, 0, w / 2], [0, 1.2 * w, h / 2], [0, 0, 1]],
                    np.float32)
    ref4 = np.eye(4, dtype=np.float32)
    ref4[:3] = intr @ np.eye(4)[:3]
    projs = []
    for i in range(V):
        a = 0.03 * (i - 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = [0.013 * i + 0.007, 0.003, 0.0]
        p4 = np.eye(4, dtype=np.float32)
        p4[:3] = intr @ w2c[:3]
        projs.append((p4 @ np.linalg.inv(ref4))[:3])
    return (np.stack(projs).astype(np.float32),
            np.linspace(near, far, d).astype(np.float32))


# name -> (h, w, pad, D, V): tests/test_torch_sweep.py's scene, sizes that
# are not multiples of the tiles (nor of 4), 2 and 4 views
SCENES = {"sweep_scene": (24, 40, 4, 8, 3),
          "odd": (13, 37, 3, 19, 3),
          "two_views": (10, 23, 0, 17, 2),
          "four_views": (18, 29, 5, 21, 4)}


def _inputs(name, seed=0):
    h, w, pad, d, V = SCENES[name]
    rng = np.random.default_rng(seed)
    projs, depths = _rig(h, w, V, d)
    srcs = rng.standard_normal((V, h, w, 35)).astype(np.float32)
    return t(srcs), t(projs), t(depths), pad


@pytest.mark.parametrize("name", list(SCENES))
def test_emulated_kernel_meets_tol_k1_against_the_twin(name):
    srcs, projs, depths, pad = _inputs(name)
    got, written = _emulate_k1(srcs, projs, depths, pad)
    twin = _sw().sweep_cost_volume_plain(srcs, projs, depths, pad, 32)
    assert got.shape == twin.shape
    assert bool((written == 1).all())
    tol = TOL_K1 * (1 + float(twin.abs().max()))
    assert float((got - twin).abs().max()) <= tol
    # every view is warped somewhere, and some voxels see it
    V = srcs.shape[0]
    assert all(float(twin[0, 3 * v].abs().max()) > 0 for v in range(V))
    assert float(twin[0, 3 * V:].abs().max()) > 0


def _jax_cost(srcs, projs, depths, pad, **kw):
    """JAX's cost volume (dense, channel-last) from the port's [feat | rgb]
    sources, with feature-resolution images (a resize to the same size is
    the identity)."""
    import jax.numpy as jnp
    from mvsnerf_tpu.ops.homography import build_cost_volume
    s = srcs.numpy()
    return np.asarray(build_cost_volume(
        jnp.asarray(s[..., 32:]), jnp.asarray(s[..., :32]),
        jnp.asarray(projs.numpy()), jnp.asarray(depths.numpy()), pad=pad,
        **kw)[0])


@pytest.mark.parametrize("name,kw", [
    ("sweep_scene", dict(warp_fwd_mode="packed")),
    ("odd", dict(warp_fwd_mode="packed")),
    ("sweep_scene", dict(warp_fwd_mode="pallas", warp_band=16))],
    ids=["dense", "dense_odd", "pallas_interpret"])
def test_emulated_kernel_through_build_cost_volume_matches_jax(
        monkeypatch, name, kw):
    """The port's build_cost_volume with its sweep replaced by the
    emulation, on the same sources as JAX's (images already at feature
    resolution), against JAX's dense cost volume and its Pallas sweep in
    interpret mode."""
    from mvsnerf_tpu_torch.ops import homography
    srcs, projs, depths, pad = _inputs(name, seed=4)
    if kw["warp_fwd_mode"] == "pallas":
        depths = depths[:4]
    monkeypatch.setattr(homography, "sweep_cost_volume",
                        lambda s, p, d, pad_, c: _emulate_k1(s, p, d, pad_)[0])
    cost = homography.build_cost_volume(srcs[..., 32:], srcs[..., :32],
                                        projs, depths, pad=pad)
    ref = _jax_cost(srcs, projs, depths, pad, **kw)
    assert cost.shape == ref.shape
    np.testing.assert_allclose(cost.numpy(), ref, rtol=0,
                               atol=TOL_K1 * (1 + np.abs(ref).max()))


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_sweep_quads.py`")
    return torch.device("cuda", 0)


def _card_rig(card, h, w, V, d, near, far, focal):
    """chip_smoke.py's camera rig (bench.py:208-234) at feature resolution,
    V views 0.3 apart, turned by 0.04 rad each."""
    intr = np.array([[focal / 4, 0, 2 * w], [0, focal / 4, 2 * h],
                     [0, 0, 1]], np.float32)
    p4 = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    for i in range(V):
        a = 0.04 * (i - 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[math.cos(a), 0, math.sin(a)], [0, 1, 0],
                     [-math.sin(a), 0, math.cos(a)]]
        m[:3, 3] = [0.3 * (i - 1), 0.0, 0.0]
        p4[i, :3] = intr @ m[:3]
    projs = (p4 @ np.linalg.inv(p4[0]))[:, :3].astype(np.float32)
    return (torch.tensor(projs, device=card),
            torch.linspace(near, far, d, device=card))


# (h, w, pad, D, V, near, far, focal): chip_smoke.py's DTU shape, and odd
# ones: w and h not multiples of 4, 2 and 4 views, no padding
CARD_CASES = [(128, 160, 24, 128, 3, 2.125, 4.525, 722.0),
              (37, 53, 3, 45, 3, 2.0, 6.0, 300.0),
              (9, 70, 5, 33, 2, 1.0, 3.0, 500.0),
              (63, 31, 0, 7, 4, 2.125, 4.525, 722.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["x".join(map(str, c[:5])) for c in CARD_CASES])
def test_kernel_matches_twin_on_the_card(card, case):
    sw = _sw()
    h, w, pad, d, V, near, far, focal = case
    proj, depths = _card_rig(card, h, w, V, d, near, far, focal)
    gen = torch.Generator(device=card).manual_seed(h * w + d)
    srcs = torch.randn(V, h, w, 35, generator=gen, device=card)
    args = (srcs, proj, depths, pad, 32)
    before = sw.sweep_cost_volume.launches
    got = sw.sweep_cost_volume_kernel(*args)
    torch.cuda.synchronize()
    assert sw.sweep_cost_volume.launches == before + 1
    assert got.shape == (1, 3 * V + 32, d, h + 2 * pad, w + 2 * pad)
    assert got.is_contiguous()
    twin = sw.sweep_cost_volume_plain(*args)
    tol = TOL_K1 * (1 + float(twin.abs().max()))
    assert float((got - twin).abs().max()) <= tol
    # the rgb channels are gathers: the same sums in the same order
    assert float((got[:, :3 * V] - twin[:, :3 * V]).abs().max()) <= \
        TOL_K1 * (1 + float(twin[:, :3 * V].abs().max()))
