"""K10's stride-1 convolution and weight gradient on the tensor cores
(csrc/conv3d.cu `conv3d_s1_tc_kernel`, `conv3d_wgrad_tc_kernel`, on
csrc/mlp_tc.cuh's 3xTF32 `mma.sync`).

On the CPU: the Python twin of the weight packing (`pack_weights_tc`: the
(chunk, tap, channel) K order, zero padding to whole k-steps and n-tiles,
hi/lo in B-fragment order) against the source's constants; a CPU
emulation of the kernels' arithmetic (operands split once into hi and lo,
the tensor core reading lo truncated to TF32, each k-step's three passes
summed in float32 and then added to a float32 accumulator, wgrad's runs of
voxels added in order) at conv0's channel counts (41 -> 8, the flipped
8 -> 41, wgrad 8 x 41) and a deep layer's (64 -> 64), strides 1 and 2, on
small grids with odd extents, held to a float64 run of the plain twin and
to `jax.lax.conv_general_dilated` at Precision.HIGHEST; and the wrappers'
refusals. On a card (tests/conftest.py imports JAX, which the card's
machine does not have, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_costreg_tc.py

every stride-1 and weight-gradient call of the dband U-Net at its DTU
shape (conv0 at the full (128, 176, 208) grid) against the twin and
float64, the kernel's packing against the twin's, partial tiles, and
bit-identical dW over two calls.

Tolerances, chip_smoke.py's: forward and dgrad TOL_K10 x (1 + max|twin|);
wgrad by TOL_K7_BWD's rule, |kernel - twin| <= 5 x max(|twin - float64|,
1e-6 x max|float64|).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

TOL_K10, TOL_K7_BWD = 1e-5, 5.0
CSRC = Path(__file__).resolve().parents[1] / "mvsnerf_tpu_torch" / "csrc"


def _k10():
    from mvsnerf_tpu_torch.ops import costreg_conv
    return costreg_conv


def _wgrad_tol(plain, ref):
    return TOL_K7_BWD * max(float((plain.double() - ref).abs().max()),
                            1e-6 * float(ref.abs().max()))


def _fwd_tol(twin):
    return TOL_K10 * (1 + float(twin.abs().max()))


# ------------------------------------------------------- the packing ----

def test_packing_constants_match_the_source():
    k10 = _k10()
    text = (CSRC / "conv3d.cu").read_text()
    assert re.search(rf"constexpr int CC = {k10.CC};", text)
    # conv0's forward: K 1107 -> 1112, not 48 x 27 = 1296
    assert 8 * k10.k_steps(41) == 1112
    assert [k10.k_steps(c) for c in (8, 16, 64, 1, 7)] == \
        [27, 54, 216, 4, 24]
    assert k10.packed_floats(41, 8, 1) == 139 * 1 * 128
    assert k10.packed_floats(8, 41, 1) == 27 * 6 * 128
    assert k10.packed_floats(64, 64, 2) == 0
    order = k10.k_order(41)
    assert len(order) == 1112 and order[1107:] == [(-1, -1)] * 5
    assert order[:9] == [(c, 0) for c in range(8)] + [(0, 1)]
    assert order[1080:1083] == [(40, 0), (40, 1), (40, 2)]
    assert sorted(order[:1107]) == [(c, t) for c in range(41)
                                    for t in range(27)]


def _unpack(packed, cin, cout):
    """(K, N) hi and lo from the twin's packing (the inverse of
    render_fused.fragment_order)."""
    k10 = _k10()
    ks, nt = k10.k_steps(cin), -(-cout // 8)
    blk = packed.view(ks, nt, 32, 4)

    def inverse(f):
        return f.reshape(ks, nt, 8, 4, 2).permute(0, 4, 3, 1, 2) \
            .reshape(8 * ks, 8 * nt)
    return inverse(blk[..., :2]), inverse(blk[..., 2:])


@pytest.mark.parametrize("cin,cout", [(41, 8), (8, 41), (16, 16), (64, 64),
                                      (5, 3)])
def test_pack_weights_tc_is_w_transposed_in_k_order_and_split(cin, cout):
    from mvsnerf_tpu_torch.ops.render_fused import split_tf32
    k10 = _k10()
    w = torch.tensor(np.random.default_rng(cin + cout).standard_normal(
        (cout, cin, 3, 3, 3)).astype(np.float32))
    packed = k10.pack_weights_tc(w)
    assert packed.shape == (k10.packed_floats(cin, cout, 1),)
    hi, lo = _unpack(packed, cin, cout)
    wf = w.reshape(cout, cin, 27)
    for k, (c, tap) in enumerate(k10.k_order(cin)):
        if c < 0:
            assert not hi[k].any() and not lo[k].any(), k
            continue
        want = wf[:, c, tap]
        assert torch.equal(hi[k, :cout], split_tf32(want)[0]), k
        assert torch.equal(lo[k, :cout], split_tf32(want)[1]), k
    assert not hi[:, cout:].any() and not lo[:, cout:].any()
    rebuilt = hi[:cin * 27, :cout].double() + lo[:cin * 27, :cout]
    exact = torch.stack([wf[:, c, t] for c, t in
                         k10.k_order(cin)[:cin * 27]]).double()
    assert float((rebuilt - exact).abs().max()) <= \
        2 ** -21 * float(w.abs().max())


# ---------------------------------------------- the emulated kernels ----

def _trunc(v):
    """The TF32 bits the tensor core reads from a float32 (truncation)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(v):
    """An operand split as staged: hi rounded to TF32, lo the remainder,
    read by the tensor core to TF32 (truncated)."""
    from mvsnerf_tpu_torch.ops.render_fused import split_tf32
    hi = split_tf32(v)[0]
    return hi, _trunc(v - hi)


def _ksteps(ah, al, bh, bl):
    """sum over k-steps s of (al bh + ah bl + ah bh)[s], each k-step's 8
    products and 3 passes in float32, then added to a float32 sum in
    order: a (M, S, 8), b (S, 8, N) -> (M, N)."""
    t = (torch.bmm(al.transpose(0, 1), bh) + torch.bmm(ah.transpose(0, 1), bl)
         ) + torch.bmm(ah.transpose(0, 1), bh)
    acc = torch.zeros(t.shape[1:])
    for s in range(t.shape[0]):
        acc = acc + t[s]
    return acc


def _taps(x, stride, size):
    """(C, 27, prod(size)): x (C, D, H, W) at o stride + tap - 1, 0 off
    the grid."""
    k10 = _k10()
    xp = k10._pad_for(x, stride, size)
    return torch.stack([s.reshape(x.shape[0], -1) for _, s in
                        k10._taps(xp, stride, size)], 1)


def _emulated_s1(x, w):
    """conv3d_s1_tc_kernel's arithmetic: x (1, Cin, D, H, W), w (Cout,
    Cin, 3, 3, 3) -> (1, Cout, D, H, W)."""
    k10 = _k10()
    cout, cin = w.shape[:2]
    size = x.shape[2:]
    order = k10.k_order(cin)
    cols = _taps(x[0], 1, size)
    a = torch.stack([cols[c, t] if c >= 0 else cols[0, 0] for c, t in order],
                    1)  # (V, Kp); the padding reads channel 0, B is 0 there
    ks = len(order) // 8
    ah, al = (m.reshape(-1, ks, 8) for m in _split(a))
    bh, bl = (m.reshape(ks, 8, -1) for m in
              _unpack(k10.pack_weights_tc(w), cin, cout))
    y = _ksteps(ah, al, bh, bl)[:, :cout]
    return y.t().reshape(1, cout, *size)


def _emulated_wgrad(g, x, stride, runs=3):
    """conv3d_wgrad_tc_kernel's arithmetic: dW^T[(chunk, tap, channel),
    a] = sum over voxels of split x taps . split g, 8 voxels a k-step, the
    voxels cut into `runs` runs summed apart and then added in order."""
    k10 = _k10()
    A, B = g.shape[1], x.shape[1]
    size = g.shape[2:]
    cols = _taps(x[0], stride, size)
    rows = [(c, t) for c, t in k10.k_order(B) if c >= 0]
    a = torch.stack([cols[c, t] for c, t in rows])  # (rows, V)
    gm = g[0].reshape(A, -1).t()                    # (V, A)
    v = a.shape[1]
    pad = -v % 8
    a = torch.cat([a, a.new_zeros(a.shape[0], pad)], 1)
    gm = torch.cat([gm, gm.new_zeros(pad, A)])
    ks = a.shape[1] // 8
    ah, al = (m.reshape(-1, ks, 8) for m in _split(a))
    bh, bl = (m.reshape(ks, 8, A) for m in _split(gm))
    cut = np.linspace(0, ks, runs + 1).astype(int)
    dwt = torch.zeros(len(rows), A)
    for r0, r1 in zip(cut[:-1], cut[1:]):
        dwt = dwt + _ksteps(ah[:, r0:r1], al[:, r0:r1], bh[r0:r1],
                            bl[r0:r1])
    dw = torch.zeros(A, B, 27)
    for i, (c, t) in enumerate(rows):
        dw[:, c, t] = dwt[i]
    return dw.reshape(A, B, 3, 3, 3)


def _jax_conv_ncdhw(x, w, stride):
    """jax.lax.conv_general_dilated at HIGHEST on the port's layouts."""
    import jax.numpy as jnp
    import test_torch_costreg as tc
    k = np.transpose(w.numpy(), (2, 3, 4, 1, 0))  # OIDHW -> DHWIO
    xj = jnp.asarray(np.transpose(x.numpy(), (0, 2, 3, 4, 1)))
    y = tc._jax_conv(xj, jnp.asarray(k), stride)
    return torch.tensor(np.transpose(np.asarray(y), (0, 4, 1, 2, 3)))


def _jax_wgrad(g, x, stride, A):
    """d/dk of sum(g . conv(x, k)) in JAX at HIGHEST: (A, B, 3, 3, 3)."""
    import jax
    import jax.numpy as jnp
    import test_torch_costreg as tc
    xj = jnp.asarray(np.transpose(x.numpy(), (0, 2, 3, 4, 1)))
    gj = jnp.asarray(np.transpose(g.numpy(), (0, 2, 3, 4, 1)))
    k0 = jnp.zeros((3, 3, 3, x.shape[1], A), jnp.float32)
    dk = jax.grad(lambda k: jnp.sum(tc._jax_conv(xj, k, stride) * gj))(k0)
    return torch.tensor(np.transpose(np.asarray(dk), (4, 3, 0, 1, 2)))


def _draw(seed, *shape):
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# conv0 (41 -> 8), its dgrad on the flipped kernel (8 -> 41), a deep
# layer (64 -> 64), and a small odd one
S1_CASES = [(41, 8, (5, 7, 9)), (8, 41, (3, 7, 33)), (64, 64, (3, 5, 7)),
            (5, 3, (4, 3, 17))]


@pytest.mark.parametrize("cin,cout,dhw", S1_CASES,
                         ids=[f"{c[0]}to{c[1]}" for c in S1_CASES])
def test_emulated_s1_meets_tol_k10_against_float64_and_jax(cin, cout, dhw):
    k10 = _k10()
    x = _draw(cin, 1, cin, *dhw)
    w = _draw(cout, cout, cin, 3, 3, 3) / np.sqrt(27 * cin)
    emu = _emulated_s1(x, w)
    twin = k10.conv3d_fwd_plain(x, w, 1)
    ref = k10.conv3d_fwd_plain(x.double(), w.double(), 1)
    tol = _fwd_tol(twin)
    assert emu.shape == twin.shape
    assert float((emu - twin).abs().max()) <= tol
    assert float((emu.double() - ref).abs().max()) <= tol
    assert float((emu - _jax_conv_ncdhw(x, w, 1)).abs().max()) <= tol


def test_emulated_s1_dgrad_is_the_flipped_kernels_forward():
    """conv0's dgrad as the autograd Function takes it: the stride-1
    forward on flip_swap(w), 8 -> 41 channels."""
    k10 = _k10()
    w = _draw(1, 8, 41, 3, 3, 3) / np.sqrt(27 * 41)
    gy = _draw(2, 1, 8, 5, 6, 7)
    emu = _emulated_s1(gy, k10.flip_swap(w))
    x = torch.zeros(1, 41, 5, 6, 7, dtype=torch.float64, requires_grad=True)
    y = k10.conv3d_fwd_plain(x, w.double(), 1)
    (ref,) = torch.autograd.grad(y, x, gy.double())
    assert float((emu.double() - ref).abs().max()) <= \
        _fwd_tol(ref.float())


# (A gradient channels, B input channels, x grid, stride): conv0's wgrad
# (8 x 41), a deep s1 layer's (64 x 64), conv1-like and conv5-like s2
WG_CASES = [(8, 41, (5, 7, 9), 1), (64, 64, (3, 5, 7), 1),
            (16, 8, (7, 9, 11), 2), (64, 32, (5, 6, 7), 2)]


@pytest.mark.parametrize("A,B,dhw,stride", WG_CASES,
                         ids=[f"{c[0]}x{c[1]}-s{c[3]}" for c in WG_CASES])
def test_emulated_wgrad_meets_its_rule_against_float64_and_jax(A, B, dhw,
                                                               stride):
    k10 = _k10()
    x = _draw(A + B, 1, B, *dhw)
    g = _draw(A, 1, A, *(k10.out_size(n, stride) for n in dhw))
    emu = _emulated_wgrad(g, x, stride)
    twin = k10.conv3d_wgrad_plain(g, x, stride)
    ref = k10.conv3d_wgrad_plain(g.double(), x.double(), stride)
    assert emu.shape == twin.shape == (A, B, 3, 3, 3)
    assert float((emu - twin).abs().max()) <= _wgrad_tol(twin, ref)
    jax_dw = _jax_wgrad(g, x, stride, A)
    assert float((emu - jax_dw).abs().max()) <= _wgrad_tol(jax_dw, ref)


def test_one_tf32_pass_would_miss_tol_k10():
    """Why three passes: hi(a) . hi(b) alone misses the forward's
    tolerance on conv0's channels."""
    k10 = _k10()
    x = _draw(41, 1, 41, 5, 7, 9)
    w = _draw(8, 8, 41, 3, 3, 3) / np.sqrt(27 * 41)
    from mvsnerf_tpu_torch.ops.render_fused import split_tf32
    one = k10.conv3d_fwd_plain(split_tf32(x)[0], split_tf32(w)[0], 1)
    ref = k10.conv3d_fwd_plain(x.double(), w.double(), 1)
    assert float((one.double() - ref).abs().max()) > _fwd_tol(ref.float())


# ------------------------------------------------------- the refusals ----

def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


FWD_REFUSALS = {
    "packed one short": (dict(packed=_meta(139 * 128 - 1)), "packed must"),
    "packed float64": (dict(packed=_meta(139 * 128, dtype=torch.float64)),
                       "packed must"),
    "packed on the CPU": (dict(packed=torch.empty(139 * 128)),
                          "packed must"),
    "packed at stride 2": (dict(stride=2, packed=_meta(139 * 128)),
                           "packed must"),
    "stride 3": (dict(stride=3), "stride 3"),
    "x on meta": ({}, "is not a CUDA device"),
    "kernel of 40 input channels": (dict(w=_meta(8, 40, 3, 3, 3)),
                                    "41 channels"),
}


@pytest.mark.parametrize("case", list(FWD_REFUSALS))
def test_fwd_kernel_refuses(case):
    from mvsnerf_tpu_torch import _build
    k10 = _k10()
    change, msg = FWD_REFUSALS[case]
    args = dict(x=_meta(1, 41, 4, 5, 6), w=_meta(8, 41, 3, 3, 3), stride=1,
                packed=None)
    args.update(change)
    with pytest.raises(ValueError, match=msg):
        k10.conv3d_fwd_kernel(**args)
    assert _build._lib is None


WGRAD_REFUSALS = {
    "g larger than x allows": (_meta(1, 8, 5, 5, 5), _meta(1, 4, 8, 8, 8), 2,
                               "does not fit"),
    "stride 3": (_meta(1, 8, 4, 4, 4), _meta(1, 4, 8, 8, 8), 3,
                 "does not fit"),
    "x float64": (_meta(1, 8, 4, 4, 4),
                  _meta(1, 4, 8, 8, 8, dtype=torch.float64), 2,
                  "x must be"),
    "g on meta": (_meta(1, 8, 4, 4, 4), _meta(1, 4, 8, 8, 8), 2,
                  "is not a CUDA device"),
}


@pytest.mark.parametrize("case", list(WGRAD_REFUSALS))
def test_wgrad_kernel_refuses(case):
    from mvsnerf_tpu_torch import _build
    g, x, stride, msg = WGRAD_REFUSALS[case]
    with pytest.raises(ValueError, match=msg):
        _k10().conv3d_wgrad_kernel(g, x, stride)
    assert _build._lib is None


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_costreg_tc.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _card_draw(card, seed, *shape, scale=1.0):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=card) * scale


# the dband U-Net's stride-1 layers at DTU size: (name, Cin, Cout, grid)
S1_LAYERS = [("conv0", 41, 8, (128, 176, 208)), ("conv2", 16, 16,
                                                  (64, 88, 104)),
             ("conv4", 32, 32, (32, 44, 52)), ("conv6", 64, 64,
                                                (16, 22, 26))]
# every weight gradient: (name, A, B, gradient grid, stride); the up
# layers' by duality (g = the layer's input, x = its output's cotangent)
WG_LAYERS = [(n, co, ci, d, 1) for n, ci, co, d in S1_LAYERS] + [
    ("conv1", 16, 8, (64, 88, 104), 2), ("conv3", 32, 16, (32, 44, 52), 2),
    ("conv5", 64, 32, (16, 22, 26), 2), ("conv7", 64, 32, (16, 22, 26), 2),
    ("conv9", 32, 16, (32, 44, 52), 2), ("conv11", 16, 8, (64, 88, 104), 2)]


def _check_fwd(card, cin, cout, dhw, seed):
    k10 = _k10()
    x = _card_draw(card, seed, 1, cin, *dhw)
    w = _card_draw(card, seed + 1, cout, cin, 3, 3, 3,
                   scale=(27 * cin) ** -0.5)
    packed = torch.empty(k10.packed_floats(cin, cout, 1), device=card)
    before = k10.launches["s1"]
    y = k10.conv3d_fwd_kernel(x, w, 1, packed)
    torch.cuda.synchronize()
    assert k10.launches["s1"] == before + 1
    assert torch.equal(packed, k10.pack_weights_tc(w))
    twin = k10.conv3d_fwd_plain(x, w, 1)
    tol = _fwd_tol(twin)
    assert float((y - twin).abs().max()) <= tol
    del twin
    ref = k10.conv3d_fwd_plain(x.double(), w.double(), 1)
    assert float((y.double() - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layer", S1_LAYERS, ids=[c[0] for c in S1_LAYERS])
@pytest.mark.parametrize("direction", ["forward", "dgrad"])
def test_s1_layer_matches_twin_and_float64_on_the_card(card, layer,
                                                       direction):
    """The forward at (Cin, Cout), the dgrad as the flipped kernel's
    forward at (Cout, Cin)."""
    name, cin, cout, dhw = layer
    if direction == "dgrad":
        cin, cout = cout, cin
    _check_fwd(card, cin, cout, dhw, seed=cin * 100 + cout)


# every form of the kernel: B in shared memory with one n-tile (41 -> 8,
# 5 -> 3) or one chunk (8 -> 41, 5 -> 12, 7 -> 30 on a grid wide enough
# for 4 n-tiles a block), else through L1
PARTIAL = [(41, 8, (3, 5, 33)), (8, 41, (5, 9, 17)), (5, 3, (1, 1, 1)),
           (9, 33, (2, 3, 40)), (64, 57, (4, 9, 31)), (3, 70, (3, 4, 5)),
           (5, 12, (3, 5, 20)), (7, 30, (16, 64, 160))]


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,dhw", PARTIAL,
                         ids=[f"{c[0]}to{c[1]}-{'x'.join(map(str, c[2]))}"
                              for c in PARTIAL])
def test_s1_partial_tiles_on_the_card(card, cin, cout, dhw):
    """Grids that end inside a box, partial chunks, padded and grouped
    n-tiles."""
    _check_fwd(card, cin, cout, dhw, seed=7)


def _check_wgrad(card, A, B, gdhw, stride, xdhw=None, seed=0):
    k10 = _k10()
    xdhw = xdhw or [n * stride for n in gdhw]
    g = _card_draw(card, seed, 1, A, *gdhw)
    x = _card_draw(card, seed + 1, 1, B, *xdhw)
    before = k10.launches["wgrad"]
    dw = k10.conv3d_wgrad_kernel(g, x, stride)
    dw2 = k10.conv3d_wgrad_kernel(g, x, stride)
    torch.cuda.synchronize()
    assert k10.launches["wgrad"] == before + 2
    assert torch.equal(dw, dw2)
    twin = k10.conv3d_wgrad_plain(g, x, stride)
    ref = k10.conv3d_wgrad_plain(g.double(), x.double(), stride)
    assert float((dw - twin).abs().max()) <= _wgrad_tol(twin, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", WG_LAYERS, ids=[c[0] for c in WG_LAYERS])
def test_wgrad_layer_matches_twin_and_float64_on_the_card(card, layer):
    name, A, B, gdhw, stride = layer
    _check_wgrad(card, A, B, gdhw, stride, seed=A + B)


WG_PARTIAL = [(8, 41, (3, 5, 33), 1, None), (5, 3, (1, 1, 1), 1, None),
              (70, 9, (2, 7, 40), 1, None), (16, 8, (3, 5, 33), 2, None),
              (64, 32, (2, 3, 9), 2, (3, 5, 17)), (3, 11, (1, 2, 3), 2,
                                                   (2, 3, 6))]


@pytest.mark.cuda
@pytest.mark.parametrize("A,B,gdhw,stride,xdhw", WG_PARTIAL,
                         ids=[f"{c[0]}x{c[1]}-s{c[3]}-"
                              f"{'x'.join(map(str, c[2]))}"
                              for c in WG_PARTIAL])
def test_wgrad_partial_tiles_on_the_card(card, A, B, gdhw, stride, xdhw):
    """Boxes cut by the grid, partial chunks and n-tiles, odd x extents at
    stride 2."""
    _check_wgrad(card, A, B, gdhw, stride, xdhw, seed=3)
