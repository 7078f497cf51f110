"""The render body's tensor-core form (csrc/render_v0.cu on
csrc/mlp_tc.cuh) and K10's paired stride-2 convolution.

On the CPU: the TF32 split (`split_tf32`), the padded fragment packing
(`pack_v0_weights_tc`) against the header's offsets, a CPU emulation of the
kernel's 3xTF32 MLP, read back from that packing, against a float64 run of
the twin at full width (W = 128), and the wrappers' refusals. On a card
(tests/conftest.py imports JAX, which the card's machine does not have,
hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_render_tc.py

each form (K6, K6b, K8) against its twin and a float64 run of it, at tile
edges (S of 8, 24, 128 and 200: several rays a tile, a partial tile, one
ray, a ray over two tiles), and K10's stride-2 calls on the conv3 and conv9
dgrad shapes against `conv3d_fwd_plain`.

Tolerances: chip_smoke.py's TOL_K6 = 1e-4 (abs, rgb / depth / acc) for the
render (f32 sums in another order; 3xTF32 products), TOL_K10 = 1e-5 x (1 +
max|twin|) for the convolution (f32 sums in another order)."""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

TOL_K6, TOL_K10 = 1e-4, 1e-5
HEADER = (Path(__file__).resolve().parents[1] / "mvsnerf_tpu_torch" / "csrc"
          / "mlp_tc.cuh")


def _mlp(seed=0, dtype=torch.float32, device="cpu"):
    """The v0 MLP with chip_smoke.py's seeded draw: weights uniform in
    +-1/sqrt(fan_in), biases N(0, 0.05)."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    gen = torch.Generator().manual_seed(seed)
    m = MVSNeRF()
    with torch.no_grad():
        for name, p in m.named_parameters():
            if p.dim() > 1:
                b = 1.0 / math.sqrt(p[0].numel())
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * b)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return m.to(device=device, dtype=dtype).eval()


def _rays(rng, n, s):
    """(ndc, feats, dirs, z) of n rays of s samples, as numpy float32."""
    ndc = rng.uniform(0, 1, (n, s, 3)).astype(np.float32)
    feats = rng.standard_normal((n, s, 20)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(2, 5, (n, s)), -1).astype(np.float32)
    return ndc, feats, dirs, z


def _err(a, b):
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in ("rgb", "depth", "acc"))


# ------------------------------------------------------------ the split ----

def test_split_tf32_keeps_10_bits_and_rebuilds_the_weight():
    from mvsnerf_tpu_torch.ops.render_fused import split_tf32
    rng = np.random.default_rng(0)
    x = rng.standard_normal(20000) * np.exp2(rng.integers(-30, 30, 20000))
    # ties at the rounding bit, both signs
    x[:8] = np.float32(1.0) + np.float32(2.0 ** -11) * np.array(
        [1, 3, 5, 7, -1, -3, 9, 11])
    x[8:16] = -x[:8]
    x = torch.tensor(x.astype(np.float32))
    hi, lo = split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32
    for part in (hi, lo):  # TF32: the low 13 mantissa bits are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    xd, hd, ld = x.double(), hi.double(), lo.double()
    assert bool(((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all())
    assert bool(((xd - hd - ld).abs() <= 2.0 ** -21 * xd.abs()).all())
    # to nearest, ties away from zero (cvt.rna.tf32.f32)
    mag, e = np.frexp(np.abs(x.numpy().astype(np.float64)))
    ref = np.sign(x.numpy()) * np.floor(mag * 2.0 ** 11 + 0.5) * \
        np.exp2(e - 11.0)
    np.testing.assert_array_equal(hi.numpy(), ref.astype(np.float32))


# ----------------------------------------------------------- the packing ----

def _header_offsets():
    text = HEADER.read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (TC_\w+) = (\d+);", text)}


def _unpack(tc, name):
    """The (K, N) hi and lo matrices of one layer of the stream: the
    inverse of `fragment_order`."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    rows, n = next((r, n) for nm, _, r, n in rf.TC_LAYERS if nm == name)
    k, off = len(rows), rf.TC_OFFSETS[name]
    blk = tc[off:off + k * n * 2].view(k // 8, n // 8, 32, 4)

    def inverse(f):
        return f.reshape(k // 8, n // 8, 8, 4, 2).permute(0, 4, 3, 1, 2) \
            .reshape(k, n)
    return inverse(blk[..., :2]), inverse(blk[..., 2:])


def test_tc_offsets_match_the_header():
    from mvsnerf_tpu_torch.ops import render_fused as rf
    hdr = _header_offsets()
    assert hdr == {**rf.TC_OFFSETS, "TC_TOTAL": rf.TC_TOTAL}
    assert rf.TC_TOTAL == 251904


def test_fragment_order_is_the_mma_b_layout():
    """Lane 4 g + t of k-step kb, n-tile nb: m[8 kb + t, 8 nb + g] and
    m[8 kb + t + 4, 8 nb + g] (the m16n8k8 TF32 B fragment)."""
    from mvsnerf_tpu_torch.ops.render_fused import fragment_order
    m = torch.arange(16 * 24).reshape(16, 24)
    f = fragment_order(m)
    assert f.shape == (2, 3, 32, 2)
    for kb in range(2):
        for nb in range(3):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                assert int(f[kb, nb, lane, 0]) == m[8 * kb + t, 8 * nb + g]
                assert int(f[kb, nb, lane, 1]) == m[8 * kb + t + 4,
                                                    8 * nb + g]


def test_tc_packing_pads_with_zeros_and_splits_each_weight():
    from mvsnerf_tpu_torch.ops import render_fused as rf
    mlp = _mlp(3)
    w = rf.pack_v0_weights(mlp)
    w0 = w.clone()
    tc = rf.pack_v0_weights_tc(w)
    assert torch.equal(w, w0) and w.shape == (rf.N_WEIGHTS,)
    assert tc.shape == (rf.TC_TOTAL,) and tc.dtype == torch.float32
    for name, layer, rows, n in rf.TC_LAYERS:
        hi, lo = _unpack(tc, name)
        lin = mlp.nerf.get_submodule(layer)
        for k, r in enumerate(rows):
            if r < 0:  # zero padding of K
                assert not hi[k].any() and not lo[k].any(), (name, k)
                continue
            want = lin.weight[:, r].detach().double()
            got = hi[k].double() + lo[k].double()
            assert bool(((got - want).abs() <=
                         2.0 ** -21 * want.abs()).all()), (name, k)
            assert torch.equal(hi[k], rf.split_tf32(lin.weight[:, r])[0])


# --------------------------------------------------- the emulated kernel ----

def _emulated_render(ndc, feats, dirs, z, mlp, passes=3):
    """The kernel's arithmetic on the CPU: every product of the tensor-core
    layers from the packed hi/lo weights and the activations split as the
    kernel splits them (hi by `split_tf32`, lo truncated to TF32), as
    lo.hi + hi.lo + hi.hi (passes=3) or hi.hi alone (passes=1), f32 sums;
    the direction term, sigma and rgb heads in f32; then the twin's
    compositing."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.compositing import raw2outputs
    from mvsnerf_tpu_torch.ops.encoding import positional_encoding
    tc = rf.pack_v0_weights_tc(rf.pack_v0_weights(mlp))
    nerf = mlp.nerf
    n_rays, s, _ = ndc.shape

    def mm(a, name):
        wh, wl = _unpack(tc, name)
        ah = rf.split_tf32(a)[0]
        # the activations' lo goes whole; the tensor core reads its TF32
        # bits (truncation)
        al = ((a - ah).view(torch.int32) & -0x2000).view(torch.float32)
        return al @ wh + ah @ wl + ah @ wh if passes == 3 else ah @ wh

    def zeros(cols):
        return ndc.new_zeros(n_rays * s, cols)

    pe = torch.cat([positional_encoding(ndc, 10).reshape(-1, 63), zeros(1)],
                   1)
    f = torch.cat([feats.reshape(-1, 20), zeros(4)], 1)
    bias = nerf.pts_bias.bias + mm(f, "TC_PTS_BIAS")
    h = torch.relu((nerf.pts_linears[0].bias + mm(pe, "TC_PTS_0")) * bias)
    for i in range(1, 5):
        h = torch.relu((nerf.pts_linears[i].bias + mm(h, f"TC_PTS_{i}"))
                       * bias)
    h = torch.relu((nerf.pts_linears[5].bias +
                    mm(torch.cat([pe, h], 1), "TC_PTS_5")) * bias)
    sigma = torch.relu(h @ nerf.alpha_linear.weight[0] +
                       nerf.alpha_linear.bias)
    feat = nerf.feature_linear.bias + mm(h, "TC_FEATURE")
    views = nerf.views_linears[0]
    start = views.bias + dirs @ views.weight[:, 128:].T
    hv = torch.relu(start.repeat_interleave(s, 0) + mm(feat, "TC_VIEWS"))
    rgb = torch.sigmoid(hv @ nerf.rgb_linear.weight.T + nerf.rgb_linear.bias)
    return raw2outputs(torch.cat([rgb, sigma[:, None]], 1).reshape(
        n_rays, s, 4), z)


def test_emulated_3xtf32_mlp_meets_tol_k6_against_float64():
    """At full width the 3-pass split stays within TOL_K6 of float64 (about
    the f32 twin's own distance); one TF32 pass does not."""
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_feats_plain
    rng = np.random.default_rng(7)
    ndc, feats, dirs, z = (torch.tensor(a) for a in _rays(rng, 96, 128))
    mlp, m64 = _mlp(0), _mlp(0, torch.float64)
    with torch.no_grad():
        f64 = render_v0_feats_plain(ndc.double(), feats.double(),
                                    dirs.double(), z.double(), m64)
        twin = render_v0_feats_plain(ndc, feats, dirs, z, mlp)
        three = _emulated_render(ndc, feats, dirs, z, mlp)
        one = _emulated_render(ndc, feats, dirs, z, mlp, passes=1)
    assert 0.2 < float(f64["acc"].mean()) < 0.99
    assert _err(twin, f64) <= TOL_K6
    assert _err(three, f64) <= TOL_K6
    assert _err(three, f64) <= 10 * max(_err(twin, f64), 1e-7)
    assert _err(one, f64) > TOL_K6


# --------------------------------------------------------- the refusals ----

N, S = 4, 16


def _render_args(**change):
    m = "meta"
    args = {"pts_ndc": torch.empty(N, S, 3, device=m),
            "z_vals": torch.empty(N, S, device=m),
            "colors": torch.empty(N, S, 12, device=m),
            "dirs": torch.empty(N, 3, device=m),
            "volume": torch.empty(4, 5, 6, 8, device=m)}
    args.update(change)
    return args


def _strided(*shape):
    return torch.empty(*shape[::-1], device="meta").permute(
        *reversed(range(len(shape))))


RENDER_CASES = {
    "S not a multiple of 8": (
        {"pts_ndc": torch.empty(N, 12, 3, device="meta"),
         "z_vals": torch.empty(N, 12, device="meta"),
         "colors": torch.empty(N, 12, 12, device="meta")}, "S % 8 == 0"),
    "no rays": ({"pts_ndc": torch.empty(0, S, 3, device="meta"),
                 "z_vals": torch.empty(0, S, device="meta"),
                 "colors": torch.empty(0, S, 12, device="meta"),
                 "dirs": torch.empty(0, 3, device="meta")}, "0 < N"),
    "z of another S": ({"z_vals": torch.empty(N, 8, device="meta")},
                       "bad shapes"),
    "dirs of 2": ({"dirs": torch.empty(N, 2, device="meta")}, "bad shapes"),
    "ndc of 2 coordinates": ({"pts_ndc": torch.empty(N, S, 2,
                                                     device="meta")},
                             "bad shapes"),
    "colors with the baked volume": (
        {"volume": torch.empty(4, 5, 6, 20, device="meta")}, "8-channel"),
    "no colors with the 8-channel volume": ({"colors": None}, "8-channel"),
    "colors of 8 channels": ({"colors": torch.empty(N, S, 8, device="meta")},
                             "8-channel"),
    "volume 3-D": ({"volume": torch.empty(4, 5, 8, device="meta")},
                   "not \\(D, hp, wp, C\\)"),
    "ndc float64": ({"pts_ndc": torch.empty(N, S, 3, dtype=torch.float64,
                                            device="meta")},
                    "pts_ndc must be contiguous float32"),
    "z not contiguous": ({"z_vals": _strided(N, S)},
                         "z_vals must be contiguous"),
    "volume on the CPU": ({"volume": torch.empty(4, 5, 6, 8)},
                          "volume must be contiguous float32 on meta"),
}


@pytest.mark.parametrize("case", list(RENDER_CASES))
def test_render_kernel_refuses(case):
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_kernel
    change, msg = RENDER_CASES[case]
    with pytest.raises(ValueError, match=msg):
        render_v0_kernel(**_render_args(**change), mlp=MVSNeRF())


FEATS_CASES = {
    "S not a multiple of 8": ({"pts_ndc": torch.empty(N, 20, 3),
                               "feats": torch.empty(N, 20, 20),
                               "z_vals": torch.empty(N, 20)}, "S % 8 == 0"),
    "feats of 12 channels": ({"feats": torch.empty(N, S, 12)},
                             "want \\(4, 16, 20\\)"),
    "feats of another S": ({"feats": torch.empty(N, 8, 20)}, "feats"),
    "dirs of 4 rays too many": ({"dirs": torch.empty(2 * N, 3)},
                                "bad shapes"),
    "feats float16": ({"feats": torch.empty(N, S, 20, dtype=torch.float16)},
                      "feats must be contiguous float32"),
}


@pytest.mark.parametrize("case", list(FEATS_CASES))
def test_render_feats_kernel_refuses(case):
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_feats_kernel
    change, msg = FEATS_CASES[case]
    args = {"pts_ndc": torch.empty(N, S, 3), "feats": torch.empty(N, S, 20),
            "dirs": torch.empty(N, 3), "z_vals": torch.empty(N, S)}
    args.update(change)
    args = {k: v.to("meta") for k, v in args.items()}
    with pytest.raises(ValueError, match=msg):
        render_v0_feats_kernel(**args, mlp=MVSNeRF())


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_render_tc.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [8, 24, 128, 200])
@pytest.mark.parametrize("form", ["K6", "K6b", "K8"])
def test_render_forms_match_twin_and_float64_on_the_card(card, form, s):
    from mvsnerf_tpu_torch.ops import render_fused as rf
    rng = np.random.default_rng(100 + s)
    n = 137
    ndc, feats, dirs, z = (torch.tensor(a, device=card)
                           for a in _rays(rng, n, s))
    ndc = ndc * 1.1 - 0.05  # some samples outside the volume
    vol = torch.tensor(rng.standard_normal(
        (12, 20, 24, 8 if form == "K6" else 20)).astype(np.float32),
        device=card)
    colors = torch.tensor(rng.uniform(0, 1, (n, s, 12)).astype(np.float32),
                          device=card)
    mlp, m64 = _mlp(1, device=card), _mlp(1, torch.float64, card)

    def f64(a):
        return None if a is None else a.double()

    with torch.no_grad():
        if form == "K8":
            args = (ndc, feats, dirs, z)
            before = rf.render_v0_feats.launches
            k = rf.render_v0_feats(*args, mlp)
            counted = rf.render_v0_feats.launches - before
            twin = rf.render_v0_feats_plain(*args, mlp)
            ref = rf.render_v0_feats_plain(*map(f64, args), m64)
        else:
            args = (ndc, z, colors if form == "K6" else None, dirs, vol)
            attr = "launches" if form == "K6" else "baked_launches"
            before = getattr(rf.render_v0, attr)
            k = rf.render_v0(*args, mlp)
            counted = getattr(rf.render_v0, attr) - before
            twin = rf.render_v0_plain(*args, mlp)
            ref = rf.render_v0_plain(*map(f64, args), m64)
        torch.cuda.synchronize()
    assert counted == 1
    assert _err(k, twin) <= TOL_K6
    assert _err(k, ref) <= TOL_K6
    if form == "K8":
        assert float((k["weights"] - twin["weights"]).abs().max()) <= TOL_K6


@pytest.mark.cuda
@pytest.mark.parametrize("call", ["conv3 forward", "conv9 dgrad",
                                  "odd width", "Blender conv5"])
def test_k10_stride2_matches_plain_on_the_card(card, call):
    from mvsnerf_tpu_torch.ops import costreg_conv as cc
    rng = np.random.default_rng(len(call))
    if call == "odd width":  # W % 4 != 0: the per-output kernel
        x = rng.standard_normal((1, 8, 9, 10, 14))
        w = rng.standard_normal((16, 8, 3, 3, 3)) / math.sqrt(8 * 27)
    elif call == "Blender conv5":  # the U-Net at 800x800: W = 62
        x = rng.standard_normal((1, 32, 32, 62, 62))
        w = rng.standard_normal((64, 32, 3, 3, 3)) / math.sqrt(32 * 27)
    else:  # Conv3d (32, 16, 3, 3, 3), or ConvTranspose3d's as stored
        x = rng.standard_normal((1, 16, 64, 88, 104))
        w = rng.standard_normal((32, 16, 3, 3, 3)) / math.sqrt(16 * 27)
    x, w = (torch.tensor(a.astype(np.float32), device=card) for a in (x, w))
    before = cc.launches["s2"]
    routes = dict(cc.s2_routes)
    if call == "conv9 dgrad":  # through conv3d_up's backward: x is d y
        inp = torch.zeros((1, 32, 32, 44, 52), device=card,
                          requires_grad=True)
        got, = torch.autograd.grad(cc.conv3d_up(inp, w), inp, x)
    else:
        got = cc.conv3d_fwd_kernel(x, w, 2)
    torch.cuda.synchronize()
    assert cc.launches["s2"] == before + 1
    route = "pair" if x.shape[4] % 4 == 0 else "generic"
    assert cc.s2_routes == {**routes, route: routes[route] + 1}
    twin = cc.conv3d_fwd_plain(x.double(), w.double(), 2)
    assert got.shape == twin.shape
    tol = TOL_K10 * (1 + float(twin.abs().max()))
    assert float((got.double() - twin).abs().max()) <= tol
