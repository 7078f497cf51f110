"""K4's kernel wrappers (`color_warp_kernel`, `color_warp_bwd_kernel`):
the argument checks they make before a launch, on the CPU with meta and
CPU tensors, and, on a card, the hand-written kernels against their plain
twins at the edges of their (sample, view) thread mapping.

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \
        tests/test_torch_color_warp_kernel.py

Tolerances: the forward within 1e-6 of the twin with equal masks (the
projection is bit-identical to the twin's; only the order of the taps'
multiply-adds differs). The backward's atomics add in an order that changes
from run to run, so it is held to a float64 run of the twin as
chip_smoke.py holds it: |kernel - twin| <= 5 x max(|twin - float64|,
1e-6 x max|float64|)."""

import numpy as np
import pytest
import torch

V, H, W, N, S = 3, 8, 10, 4, 5


def _args(device="meta", v=V):
    return {"pts_world": torch.empty(N, S, 3, device=device),
            "w2cs": torch.empty(v, 4, 4, device=device),
            "intrinsics": torch.empty(v, 3, 3, device=device),
            "imgs": torch.empty(v, H, W, 3, device=device)}


def _strided(*shape):
    """A float32 meta tensor of `shape` that is not contiguous (its
    strides run the other way)."""
    return torch.empty(*shape[::-1], device="meta").permute(
        *reversed(range(len(shape))))


# name -> (changes to the forward's arguments, the refusal's message)
GEOMETRY_CASES = {
    "pts float64": ({"pts_world": torch.empty(N, S, 3, dtype=torch.float64,
                                              device="meta")},
                    "pts_world must be contiguous float32"),
    "w2cs float64": ({"w2cs": torch.empty(V, 4, 4, dtype=torch.float64,
                                          device="meta")},
                     "w2cs must be contiguous float32"),
    "intrinsics float16": ({"intrinsics": torch.empty(
        V, 3, 3, dtype=torch.float16, device="meta")},
        "intrinsics must be contiguous float32"),
    "pts not contiguous": ({"pts_world": _strided(N, S, 3)},
                           "pts_world must be contiguous"),
    "w2cs not contiguous": ({"w2cs": _strided(V, 4, 4)},
                            "w2cs must be contiguous"),
    "intrinsics not contiguous": ({"intrinsics": _strided(V, 3, 3)},
                                  "intrinsics must be contiguous"),
    "pts 2-D": ({"pts_world": torch.empty(N * S, 3, device="meta")},
                "bad shapes"),
    "pts of 2 coordinates": ({"pts_world": torch.empty(N, S, 2,
                                                       device="meta")},
                             "bad shapes"),
    "w2cs 3x4": ({"w2cs": torch.empty(V, 3, 4, device="meta")},
                 "bad shapes"),
    "w2cs of another view count": ({"w2cs": torch.empty(V + 1, 4, 4,
                                                        device="meta")},
                                   "bad shapes"),
    "intrinsics 4x4": ({"intrinsics": torch.empty(V, 4, 4, device="meta")},
                       "bad shapes"),
    "intrinsics of another view count": ({"intrinsics": torch.empty(
        V - 1, 3, 3, device="meta")}, "bad shapes"),
    "w2cs on another device": ({"w2cs": torch.empty(V, 4, 4)},
                               "w2cs must be contiguous float32 on meta"),
    "pts on another device": ({"pts_world": torch.empty(N, S, 3)},
                              "must be contiguous float32 on cpu"),
    "2**31 samples": ({"pts_world": torch.empty(2 ** 16, 2 ** 15, 3,
                                                device="meta")},
                      "2147483648 samples exceed int32"),
}
# forward only: the images are an argument there
IMAGE_CASES = {
    "imgs float64": ({"imgs": torch.empty(V, H, W, 3, dtype=torch.float64,
                                          device="meta")},
                     "imgs must be contiguous float32"),
    "imgs not contiguous": ({"imgs": _strided(V, H, W, 3)},
                            "imgs must be contiguous"),
    "imgs 3-D": ({"imgs": torch.empty(V, H, W, device="meta")},
                 "bad shapes"),
    "imgs RGBA": ({"imgs": torch.empty(V, H, W, 4, device="meta")},
                  "bad shapes"),
    "imgs of one row": ({"imgs": torch.empty(V, 1, W, 3, device="meta")},
                        "bad shapes"),
    "imgs of one column": ({"imgs": torch.empty(V, H, 1, 3, device="meta")},
                           "bad shapes"),
    "imgs on another device": ({"imgs": torch.empty(V, H, W, 3)},
                               "imgs must be contiguous float32 on meta"),
}


@pytest.mark.parametrize("case", [*GEOMETRY_CASES, *IMAGE_CASES,
                                  "257 views", "CPU tensors"])
def test_forward_refuses(case):
    from mvsnerf_tpu_torch.ops.color_warp import color_warp_kernel
    if case == "257 views":
        args, match = _args(v=257), "257 views exceed 256"
    elif case == "CPU tensors":
        args, match = _args("cpu"), "tensors on cpu, not CUDA"
    else:
        change, match = {**GEOMETRY_CASES, **IMAGE_CASES}[case]
        args = {**_args(), **change}
    with pytest.raises(ValueError, match=match):
        color_warp_kernel(**args)


def _cotangent(shape=(N, S, 4 * V), **kw):
    return torch.empty(*shape, **{"device": "meta", **kw})


# name -> (cotangent, image shape, refusal's message), with the geometry of
# `_args()`
COTANGENT_CASES = {
    "cotangent of another view count": (_cotangent((N, S, 4 * V + 4)),
                                        (V, H, W, 3), "bad cotangent"),
    "cotangent of another sample count": (_cotangent((N, S + 1, 4 * V)),
                                          (V, H, W, 3), "bad cotangent"),
    "cotangent float64": (_cotangent(dtype=torch.float64), (V, H, W, 3),
                          "bad cotangent"),
    "cotangent not contiguous": (_strided(N, S, 4 * V), (V, H, W, 3),
                                 "bad cotangent"),
    "cotangent on another device": (torch.empty(N, S, 4 * V), (V, H, W, 3),
                                    "bad cotangent"),
    "image shape 3-D": (_cotangent(), (V, H, W), "bad image shape"),
    "image shape RGBA": (_cotangent(), (V, H, W, 4), "bad image shape"),
    "image of one row": (_cotangent(), (V, 1, W, 3), "bad shapes"),
    "image of another view count": (_cotangent(), (V + 1, H, W, 3),
                                    "bad shapes"),
}


@pytest.mark.parametrize("case", [*GEOMETRY_CASES, *COTANGENT_CASES,
                                  "cotangent 4 bytes off alignment",
                                  "CPU tensors"])
def test_backward_refuses(case):
    from mvsnerf_tpu_torch.ops.color_warp import color_warp_bwd_kernel
    args = _args()
    g, img_shape = _cotangent(), (V, H, W, 3)
    if case in GEOMETRY_CASES:
        change, match = GEOMETRY_CASES[case]
        args.update(change)
        if "pts_world" in change:  # the cotangent follows the points
            g = torch.empty(*change["pts_world"].shape[:2], 4 * V,
                            device=change["pts_world"].device)
    elif case in COTANGENT_CASES:
        g, img_shape, match = COTANGENT_CASES[case]
    else:  # CPU tensors, the last refusal on an otherwise valid call
        args = _args("cpu")
        g = torch.empty(N, S, 4 * V)
        match = "tensors on cpu, not CUDA"
        if case.startswith("cotangent 4 bytes"):
            g = torch.empty(N * S * 4 * V + 1)[1:].view(N, S, 4 * V)
            assert g.is_contiguous() and g.data_ptr() % 16 == 4
            match = "16-byte aligned"
    with pytest.raises(ValueError, match=match):
        color_warp_bwd_kernel(g, args["pts_world"], args["w2cs"],
                              args["intrinsics"], img_shape)


def test_autograd_backward_hands_the_kernel_an_aligned_cotangent(
        monkeypatch):
    """A cotangent that is a contiguous view 4 bytes into a larger buffer
    reaches the backward launch as an aligned copy of itself."""
    from mvsnerf_tpu_torch.ops import color_warp as cw
    seen = {}

    def fwd(pts, w2cs, intrs, imgs):
        return torch.zeros(*pts.shape[:2], 4 * len(w2cs))

    def bwd(g, pts, w2cs, intrs, img_shape):
        seen.update(offset=g.data_ptr() % 16, contiguous=g.is_contiguous(),
                    g=g.clone())
        return torch.zeros(img_shape)

    monkeypatch.setattr(cw, "color_warp_kernel", fwd)
    monkeypatch.setattr(cw, "color_warp_bwd_kernel", bwd)
    a = {k: torch.zeros(t.shape) for k, t in _args().items()}
    im = a["imgs"].requires_grad_()
    out = cw._ColorWarp.apply(a["pts_world"], a["w2cs"], a["intrinsics"], im)
    g = torch.arange(out.numel() + 1, dtype=torch.float32)[1:].view(
        out.shape)
    assert g.data_ptr() % 16 == 4
    torch.autograd.grad(out, im, g)
    assert seen["offset"] == 0 and seen["contiguous"]
    assert torch.equal(seen["g"], g)


# ------------------------------------------------------- on the card ----

TOL_K4, TOL_K4_BWD = 1e-6, 5.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_color_warp_kernel.py`")
    return torch.device("cuda", 0)


def _rig(rng, v, h, w):
    """v views of random images and a rig of cameras turned and shifted
    around the first (focal ~w)."""
    imgs = rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)
    intr = np.array([[1.1 * w, 0, w / 2], [0, 1.1 * w, h / 2], [0, 0, 1]],
                    np.float32)
    w2cs = []
    for i in range(v):
        a = 0.05 * (i - 1)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]]
        m[:3, 3] = [0.2 * (i - 1), 0.03 * i, 0.0]
        w2cs.append(m)
    return imgs, np.stack(w2cs), np.stack([intr] * v)


def _scattered(rng, n, s, spread=1.4):
    """Points in front of the rig; `spread` > 1 sends a share outside."""
    xy = rng.uniform(-spread, spread, (n, s, 2)) * 0.5
    z = rng.uniform(2.0, 5.0, (n, s, 1))
    return np.concatenate([xy * z, z], -1).astype(np.float32)


def _outside(w2c, intr, n, s, h, w):
    """Rays through one camera's centre at pixels right of its frame (some
    above or below it too): every sample clamps onto its border."""
    c2w = np.linalg.inv(w2c.astype(np.float64))
    u = np.linspace(w + 2, w + 40, n)
    v = np.linspace(-0.5 * h, 1.5 * h, n)
    z = np.linspace(2.0, 5.0, s)
    x = ((u - intr[0, 2]) / intr[0, 0])[:, None] * z
    y = ((v - intr[1, 2]) / intr[1, 1])[:, None] * z
    cam = np.stack([x, y, np.broadcast_to(z, x.shape), np.ones_like(x)], -1)
    return (cam @ c2w.T)[..., :3].astype(np.float32)


def _on_centres(v):
    """Images of 33 x 65 (H - 1 and W - 1 powers of two), focal 64 and
    integer principal point, identity rotations and translations of v/32 in
    x: every projection lands exactly on a pixel centre of every view (or
    clamps onto one), so the far taps' weights are exactly 0."""
    h, w = 33, 65
    intr = np.array([[64.0, 0, 32], [0, 64.0, 16], [0, 0, 1]], np.float32)
    w2cs = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    w2cs[:, 0, 3] = np.arange(v) / 32.0
    uu, vv = np.meshgrid(np.arange(w), np.arange(h))
    z = 2.0
    pts = np.stack([(uu - 32) / 64.0 * z, (vv - 16) / 64.0 * z,
                    np.full(uu.shape, z)], -1).reshape(-1, 1, 3)
    return pts[:2143].astype(np.float32), w2cs, np.stack([intr] * v), h, w


def _case(name, v, rng):
    """(pts, w2cs, intrinsics, imgs) numpy arrays of one case: sample
    counts that are no multiple of 32 or of v."""
    if name == "centres":
        pts, w2cs, intrs, h, w = _on_centres(v)
        imgs = rng.uniform(0, 1, (v, h, w, 3)).astype(np.float32)
        return pts, w2cs, intrs, imgs
    h, w = (2, 2) if name == "2x2 images" else (48, 64)
    imgs, w2cs, intrs = _rig(rng, v, h, w)
    if name == "clamped in one view":
        pts = _outside(w2cs[-1], intrs[-1], 37, 13, h, w)
    else:
        pts = _scattered(rng, 37, 13)
    return pts, w2cs, intrs, imgs


CASES = ("scattered", "clamped in one view", "centres", "2x2 images")


@pytest.mark.cuda
@pytest.mark.parametrize("v", [1, 3, 4])
@pytest.mark.parametrize("name", CASES)
def test_kernels_match_twins_on_the_card(card, name, v):
    from mvsnerf_tpu_torch.ops import color_warp as cw
    rng = np.random.default_rng(10 * CASES.index(name) + v)
    pts, w2cs, intrs, imgs = (torch.tensor(a, device=card)
                              for a in _case(name, v, rng))
    n = pts[..., 0].numel()
    assert n % 32 != 0 and (v == 1 or n % v != 0)
    grids = cw.color_warp_grids(pts, w2cs, intrs, *imgs.shape[1:3])
    if name == "clamped in one view":
        assert bool((grids[-1].abs() >= 1).any(-1).all())
    if name == "centres":  # every coordinate on a pixel centre
        ix = (grids[..., 0] + 1) / 2 * (imgs.shape[2] - 1)
        assert torch.equal(ix, ix.round())

    launches = cw.color_warp.launches
    out = cw.color_warp_kernel(pts, w2cs, intrs, imgs)
    torch.cuda.synchronize()
    ref = cw.color_warp_plain(pts, w2cs, intrs, imgs)
    assert cw.color_warp.launches == launches + 1
    assert out.shape == ref.shape == (*pts.shape[:2], 4 * v)
    assert torch.equal(out[..., 3::4], ref[..., 3::4])
    assert float((out - ref).abs().max()) <= TOL_K4

    g = torch.tensor(rng.standard_normal(out.shape).astype(np.float32),
                     device=card)
    launches = cw.color_warp.bwd_launches
    got = cw.color_warp_bwd_kernel(g, pts, w2cs, intrs, imgs.shape)
    torch.cuda.synchronize()
    assert cw.color_warp.bwd_launches == launches + 1
    twin = cw.color_warp_bwd_plain(g, pts, w2cs, intrs, imgs)
    f64 = cw.color_warp_bwd_plain(g.double(), pts.double(), w2cs.double(),
                                  intrs.double(), imgs.double())
    tol = TOL_K4_BWD * max(float((twin.double() - f64).abs().max()),
                           1e-6 * float(f64.abs().max()))
    assert got.shape == imgs.shape
    assert float((got - twin).abs().max()) <= tol


@pytest.mark.cuda
def test_autograd_route_on_the_card(card):
    """`color_warp` with images that require grad: the forward is the
    kernel's, and the images' gradient is the backward kernel's."""
    from mvsnerf_tpu_torch.ops import color_warp as cw
    rng = np.random.default_rng(5)
    pts, w2cs, intrs, imgs = (torch.tensor(a, device=card)
                              for a in _case("scattered", 3, rng))
    im = imgs.clone().requires_grad_()
    out = cw.color_warp(pts, w2cs, intrs, im)
    g = torch.tensor(rng.standard_normal(out.shape).astype(np.float32),
                     device=card)
    got, = torch.autograd.grad(out, im, g)
    assert torch.equal(out, cw.color_warp_kernel(pts, w2cs, intrs, imgs))
    twin = cw.color_warp_bwd_plain(g, pts, w2cs, intrs, imgs)
    f64 = cw.color_warp_bwd_plain(g.double(), pts.double(), w2cs.double(),
                                  intrs.double(), imgs.double())
    tol = TOL_K4_BWD * max(float((twin.double() - f64).abs().max()),
                           1e-6 * float(f64.abs().max()))
    assert float((got - twin).abs().max()) <= tol
