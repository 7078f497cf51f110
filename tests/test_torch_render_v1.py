"""K11, the fused render body of the v1 attention MLP (csrc/render_v1.cu,
`ops/render_fused.py` `render_v1_feats`), and the chunked route that
takes it. Imports no JAX (tests/test_torch_mlp_variants.py holds the v1
MLP to JAX).

On the CPU (~10 s):
- a chunked v1 render on both of its routes, the module's (under a
  gradient) and K11's plain twin (no gradient), against the benchmark's
  plain reference `gpu_bench/reference/mvsnerf_v1.py` on its seeded
  weights: abs <= 2e-5 in rgb and in depth over (far - near): float32
  round-off of the same operations in another order, through 32 samples'
  sums (measured 3e-8);
- the eager attention's span `render.color_attention` inside
  `render.mlp`;
- the dispatch: K11 for v1 at D=6, W=128 with no gradient, the module
  under a gradient and at another shape, K8 for v0, the module for v2;
- the packing K11 reads against the kernel source's offsets, and a CPU
  emulation of the kernel's arithmetic (the attention in its order, the
  trunk's products in 3xTF32 from the packed stream) against a float64
  run of the twin: TOL_K6 = 1e-4, the render bodies' tolerance (one TF32
  pass misses it), and the folded features [volume | colour | colour]
  within 1e-5 of the twin's (f32 sums in another order; the colour is a
  sum of 3 sigmoids).

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_render_v1.py

K11 against its twin and a float64 run of it on a 5120-ray chunk (the
view cell's) with one all-masked source view and saturated colours, at
S = 128 and at tile edges (S = 24: several rays a tile; S = 200: one ray
over two tiles): rgb, depth, acc, weights and alpha within TOL_K6, the
folded features within 1e-5 (their volume channels bit-equal).
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench import core
from gpu_bench.reference import mvsnerf_v1 as ref

TOL_K6, TOL_COLOR, TOL_REF = 1e-4, 1e-5, 2e-5
SOURCE = (Path(__file__).resolve().parents[1] / "mvsnerf_tpu_torch" / "csrc"
          / "render_v1.cu")


def _weights(seed, density, dtype=torch.float32, device="cpu"):
    """The benchmark's seeded draw of the v1 MLP (`core.make_weights` of
    the reference's table), `density` added to the alpha head's bias so
    that the test's rays are neither empty nor opaque: (parameters by key,
    the port's module)."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    table = {"fn": ref.param_table()["network_fn_state_dict"]}
    p = core.make_weights(table, seed, "cpu")["fn"]
    p["nerf.alpha_linear.bias"] += density
    mlp = MVSNeRF("v1")
    mlp.load_state_dict(p, strict=True)
    return p, mlp.to(device=device, dtype=dtype).eval()


def _rays(rng, n, s, masked=False):
    """(ndc, feats, dirs, z) of n rays of s samples, numpy float32; with
    `masked`, source view 1 is outside every sample (mask 0, its colours
    the border's) and view 2's colours are saturated at 0 or 1."""
    ndc = rng.uniform(0, 1, (n, s, 3)).astype(np.float32)
    vol = rng.standard_normal((n, s, 8))
    views = [np.concatenate([rng.uniform(0, 1, (n, s, 3)),
                             rng.uniform(0, 1, (n, s, 1)) > 0.3], -1)
             for _ in range(3)]
    if masked:
        views[1][..., 3] = 0.0
        views[2][..., :3] = views[2][..., :3] > 0.5
    feats = np.concatenate([vol, *views], -1).astype(np.float32)
    d = rng.standard_normal((n, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(2, 5, (n, s)), -1).astype(np.float32)
    return ndc, feats, dirs, z


def _err(a, b, keys=("rgb", "depth", "acc")):
    return max(float((a[k].double() - b[k].double()).abs().max())
               for k in keys)


# ------------------------------------------- the chunked route, end to end

HW, PAD, N_S = (40, 32), 2, 32


def _scene(seed):
    """A source rig, [0, 1] images, a volume and a test view's rays."""
    from gpu_bench.scenes import DTURig
    rng = np.random.default_rng(seed)
    rig = DTURig(HW)
    ids = [20, 24, 28]
    w, h = HW
    volume = rng.standard_normal((16, h // 4 + 2 * PAD, w // 4 + 2 * PAD, 8))
    return {"imgs": torch.tensor(rng.uniform(0, 1, (3, h, w, 3)),
                                 dtype=torch.float32),
            "w2cs": torch.tensor(rig.w2cs[ids]),
            "intrinsics": torch.tensor(rig.k[ids]),
            "near_far": torch.tensor(rig.near_far, dtype=torch.float32),
            "volume": torch.tensor(volume, dtype=torch.float32),
            "rays": torch.tensor(rig.rays(26)), "pad": PAD, "n_samples": N_S}


@pytest.mark.parametrize("route", ["module", "k11_twin"])
def test_chunked_v1_render_matches_the_reference(route, monkeypatch):
    from mvsnerf_tpu_torch.render import renderer
    calls = {"k11": 0}
    fused = renderer.render_v1_feats

    def counted(*a, **kw):
        calls["k11"] += 1
        return fused(*a, **kw)

    monkeypatch.setattr(renderer, "render_v1_feats", counted)
    p, mlp = _weights(2 ** 31 + 11, 0.1)
    sc = _scene(3)
    render = renderer.make_chunked_renderer(
        mlp, sc["volume"], sc["imgs"], sc["near_far"],
        {"w2cs": sc["w2cs"], "intrinsics": sc["intrinsics"]}, N_S, PAD,
        chunk=300)
    w, h = HW
    with torch.set_grad_enabled(route == "module"):
        out = {k: v.detach() for k, v in render(sc["rays"], h, w).items()}
    assert calls["k11"] == (0 if route == "module" else 5)
    with torch.no_grad():
        want = ref.render_image(p, sc["volume"], sc["rays"], sc, block=512)
    near, far = sc["near_far"].tolist()
    assert 0.05 < float(want["acc"].mean()) < 0.99
    assert float((out["rgb"] - want["rgb"]).abs().max()) <= TOL_REF
    assert float((out["depth"] - want["depth"]).abs().max()) <= \
        TOL_REF * (far - near)


@pytest.mark.parametrize("route", ["module", "k11_twin"])
def test_the_eager_attention_has_its_span_inside_render_mlp(route):
    """Under a profiler the eager colour attention (the module's, which
    K11's twin runs too) is the span `render.color_attention`, once a
    chunk, inside `render.mlp`."""
    from mvsnerf_tpu_torch.render import renderer
    _, mlp = _weights(2 ** 31 + 11, 0.1)
    sc = _scene(3)
    render = renderer.make_chunked_renderer(
        mlp, sc["volume"], sc["imgs"], sc["near_far"],
        {"w2cs": sc["w2cs"], "intrinsics": sc["intrinsics"]}, 8, PAD,
        chunk=300)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.set_grad_enabled(route == "module"):
            render(sc["rays"], HW[1], HW[0])
    parents = []
    for e in prof.events():
        if e.name == "mvsnerf.render.color_attention":
            p = e.cpu_parent
            while p is not None and not p.name.startswith("mvsnerf."):
                p = p.cpu_parent
            parents.append(None if p is None else p.name)
    assert parents == ["mvsnerf.render.mlp"] * 5


# ------------------------------------------------------------ dispatch ----

@pytest.mark.parametrize("case", ["v1 no grad", "v1 grad", "v1 D4 W64",
                                  "v0 no grad", "v2 no grad"])
def test_the_route_follows_the_mlp_and_the_gradient(case, monkeypatch):
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.render import renderer
    seen = []
    for name in ("render_v0_feats", "render_v1_feats"):
        orig = getattr(renderer, name)
        monkeypatch.setattr(renderer, name,
                            lambda *a, _n=name, _o=orig, **kw:
                            seen.append(_n) or _o(*a, **kw))
    net, *shape = case.split()[0], 6, 128
    if "D4" in case:
        shape = [4, 64]
    torch.manual_seed(0)
    mlp = MVSNeRF(net, *shape)
    sc = _scene(5)
    rays = sc["rays"][:64]
    pts, rays_d, z, ndc = renderer.sample_rays(
        rays, 8, sc["w2cs"][0], sc["intrinsics"][0], sc["imgs"].shape[1:3],
        sc["near_far"], PAD)
    with torch.set_grad_enabled(case.endswith("grad") and "no" not in case):
        out = renderer.render_rays(mlp, sc["volume"], pts, ndc, z, rays_d,
                                   sc["w2cs"][0], sc["w2cs"],
                                   sc["intrinsics"], sc["imgs"])
    want = {"v1 no grad": ["render_v1_feats"], "v0 no grad":
            ["render_v0_feats"]}.get(case, [])
    assert seen == want
    assert mlp.fused_body == {"v1 no grad": "v1", "v1 grad": "v1",
                              "v0 no grad": "v0"}.get(case)
    if net == "v1":  # the colours folded into feats on either route
        assert out["feats"].shape == (64, 8, 14)
        assert torch.equal(out["feats"][..., 8:11], out["feats"][..., 11:])
        assert {"alpha", "weights"} <= set(out)


def test_the_v0_kernels_refuse_v1_and_k11_refuses_the_others():
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops import render_fused as rf
    with pytest.raises(ValueError, match="v0 MLP at D=6, W=128"):
        rf.pack_v0_weights(MVSNeRF("v1"))
    for mlp in (MVSNeRF("v0"), MVSNeRF("v2"), MVSNeRF("v1", 4, 64)):
        with pytest.raises(ValueError, match="v1 MLP at D=6, W=128"):
            rf.pack_v1_weights(mlp)
    m = "meta"
    with pytest.raises(ValueError, match="want \\(4, 16, 20\\)"):
        rf.render_v1_feats_kernel(
            torch.empty(4, 16, 3, device=m), torch.empty(4, 16, 12, device=m),
            torch.empty(4, 3, device=m), torch.empty(4, 16, device=m),
            MVSNeRF("v1"))


# --------------------------------------------------------- the packing ----

def _source_constants():
    """Every `constexpr int` of csrc/render_v1.cu, evaluated in order."""
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 SOURCE.read_text()):
        env[name] = int(eval(re.sub(r"//.*", "", expr), {}, dict(env)))
    return env


def test_the_packing_matches_the_kernel_source():
    from mvsnerf_tpu_torch.ops import render_fused as rf
    c = _source_constants()
    off = rf._pack_v1_offsets()
    assert c["N_WEIGHTS"] == rf.N_WEIGHTS_V1
    for key, layer in [("OFF_W0", "pts_linears.0"), ("OFF_WB", "pts_bias"),
                       ("OFF_W1", "pts_linears.1"), ("OFF_WA", "alpha_linear"),
                       ("OFF_WF", "feature_linear"),
                       ("OFF_WV", "views_linears.0"),
                       ("OFF_WR", "rgb_linear")]:
        assert c[key] == off[layer], key
    for key, layer in [("A_WQ", "w_qs"), ("A_WK", "w_ks"), ("A_WV", "w_vs"),
                       ("A_FC", "fc"), ("A_LNW", "layer_norm")]:
        assert c["OFF_ATTN"] + c[key] == off[f"color_attention.{layer}"]
    assert c["OFF_ATTN"] + c["A_WO"] == off["weight_out"]
    assert {k: v for k, v in c.items() if k.startswith("TC1_")} == \
        {**rf.TC1_OFFSETS, "TC1_TOTAL": rf.TC1_TOTAL}
    # the stream is read a k-step at a time from chunks of 8192 floats:
    # no k-step may straddle two
    for name, _, rows, n in rf.TC1_LAYERS:
        assert (rf.TC1_OFFSETS[name] % 8192) % (16 * n) == 0, name


def _unpack(tc, name):
    """The (K, N) hi and lo matrices of one layer of K11's stream."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    rows, n = next((r, n) for nm, _, r, n in rf.TC1_LAYERS if nm == name)
    k, off = len(rows), rf.TC1_OFFSETS[name]
    blk = tc[off:off + k * n * 2].view(k // 8, n // 8, 32, 4)

    def inverse(f):
        return f.reshape(k // 8, n // 8, 8, 4, 2).permute(0, 4, 3, 1, 2) \
            .reshape(k, n)
    return inverse(blk[..., :2]), inverse(blk[..., 2:])


def _emulated_k11(ndc, feats, dirs, z, mlp, passes=3):
    """K11's arithmetic on the CPU from what it reads: the attention in f32
    from `pack_v1_weights` in the kernel's order (the volume's share of q,
    k, v once for the three tokens), the tensor-core layers from the
    packed stream, each activation split as the kernel splits it, as
    lo.hi + hi.lo + hi.hi (passes=3) or hi.hi alone (passes=1); the heads'
    f32 parts from the pack; then the twin's compositing."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.compositing import raw2outputs
    from mvsnerf_tpu_torch.ops.encoding import positional_encoding
    w = rf.pack_v1_weights(mlp)
    tc = rf.pack_v1_weights_tc(w)
    off = rf._pack_v1_offsets()
    n_rays, s, _ = ndc.shape

    def mat(name, n_in, n_out):
        return w[off[name]:off[name] + n_in * n_out].view(n_in, n_out)

    def vec(name, n_in, n_out):
        return w[off[name] + n_in * n_out:off[name] + (n_in + 1) * n_out]

    def mm(a, name):
        wh, wl = _unpack(tc, name)
        ah = rf.split_tf32(a)[0]
        al = ((a - ah).view(torch.int32) & -0x2000).view(torch.float32)
        return al @ wh + ah @ wl + ah @ wh if passes == 3 else ah @ wh

    f = feats.reshape(-1, 20)
    vol, cm = f[:, :8], f[:, 8:].reshape(-1, 3, 4)
    qkv = [vol[:, None] @ mat(f"color_attention.{n}", 12, 16)[4:] +
           cm @ mat(f"color_attention.{n}", 12, 16)[:4]
           for n in ("w_qs", "w_ks", "w_vs")]
    q, k, v = (x.reshape(-1, 3, 4, 4) for x in qkv)
    att = torch.softmax(torch.einsum("bihd,bjhd->bhij", q * 0.5, k), -1)
    o = torch.einsum("bhij,bjhd->bihd", att, v).reshape(-1, 3, 16)
    tok = torch.cat([cm, vol[:, None].expand(-1, 3, 8)], -1)
    y = o @ mat("color_attention.fc", 16, 12) + tok
    y = y - y.mean(-1, keepdim=True)
    ln = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6) * \
        mat("color_attention.layer_norm", 1, 12)[0] + \
        vec("color_attention.layer_norm", 1, 12)
    color = torch.sigmoid(ln @ mat("weight_out", 12, 3) +
                          vec("weight_out", 12, 3)).sum(1)
    zeros = f.new_zeros
    pb = vec("pts_bias", 11, 128) + mm(
        torch.cat([vol, color, zeros(len(f), 5)], 1), "TC1_PTS_BIAS")
    pe = torch.cat([positional_encoding(ndc, 10).reshape(-1, 63),
                    zeros(len(f), 1)], 1)
    h = torch.relu(vec("pts_linears.0", 63, 128) + mm(pe, "TC1_PTS_0") + pb)
    for i in range(1, 6):
        h = torch.relu(vec(f"pts_linears.{i}", 128, 128) +
                       mm(h, f"TC1_PTS_{i}") + pb)
    sigma = torch.relu(h @ mat("alpha_linear", 128, 1)[:, 0] +
                       vec("alpha_linear", 128, 1))
    feat = vec("feature_linear", 128, 128) + mm(h, "TC1_FEATURE")
    start = vec("views_linears.0", 131, 64) + \
        dirs @ mat("views_linears.0", 131, 64)[128:]
    hv = torch.relu(start.repeat_interleave(s, 0) + mm(feat, "TC1_VIEWS"))
    rgb = torch.sigmoid(hv @ mat("rgb_linear", 64, 3) +
                        vec("rgb_linear", 64, 3))
    out = raw2outputs(torch.cat([rgb, sigma[:, None]], 1).reshape(
        n_rays, s, 4), z)
    out["feats"] = torch.cat([vol, color, color], 1).reshape(n_rays, s, 14)
    return out


def test_emulated_k11_meets_tol_k6_against_float64():
    """At full width the kernel's arithmetic from its packed weights
    stays within TOL_K6 of float64, with the twin's folded features; one
    TF32 pass does not."""
    from mvsnerf_tpu_torch.ops.render_fused import render_v1_feats_plain
    rng = np.random.default_rng(7)
    ndc, feats, dirs, z = (torch.tensor(a) for a in
                           _rays(rng, 48, 128, masked=True))
    _, mlp = _weights(5, -0.3)
    _, m64 = _weights(5, -0.3, torch.float64)
    with torch.no_grad():
        f64 = render_v1_feats_plain(ndc.double(), feats.double(),
                                    dirs.double(), z.double(), m64)
        twin = render_v1_feats_plain(ndc, feats, dirs, z, mlp)
        three = _emulated_k11(ndc, feats, dirs, z, mlp)
        one = _emulated_k11(ndc, feats, dirs, z, mlp, passes=1)
    assert 0.2 < float(f64["acc"].mean()) < 0.99
    assert _err(twin, f64) <= TOL_K6
    assert _err(three, f64) <= TOL_K6
    assert _err(one, f64) > TOL_K6
    assert _err(three, twin, ("feats",)) <= TOL_COLOR


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_render_v1.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [24, 128, 200])
def test_k11_matches_twin_and_float64_on_the_card(card, s):
    from mvsnerf_tpu_torch.ops import render_fused as rf
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(300 + s)
    n = 5120 if s <= 128 else 331
    args = tuple(torch.tensor(a, device=card)
                 for a in _rays(rng, n, s, masked=True))
    _, mlp = _weights(9, -0.4, device=card)
    _, m64 = _weights(9, -0.4, torch.float64, card)
    with torch.no_grad():
        before = rf.render_v1_feats.launches
        k = rf.render_v1_feats(*args, mlp)
        counted = rf.render_v1_feats.launches - before
        twin = rf.render_v1_feats_plain(*args, mlp)
        f64 = rf.render_v1_feats_plain(*(a.double() for a in args), m64)
        torch.cuda.synchronize()
    assert counted == 1
    assert all(bool(torch.isfinite(v).all()) for v in k.values())
    assert 0.1 < float(f64["acc"].mean()) < 0.99
    keys = ("rgb", "depth", "acc", "weights", "alpha")
    assert _err(k, twin, keys) <= TOL_K6
    assert _err(k, f64, keys) <= TOL_K6
    assert _err(k, twin, ("feats",)) <= TOL_COLOR
    assert torch.equal(k["feats"][..., :8], args[1][..., :8])
    assert math.isclose(float(k["weights"].sum(1).sub(k["acc"]).abs().max()),
                        0.0, abs_tol=1e-5)
