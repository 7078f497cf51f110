"""K7 on the tensor cores (csrc/mlp_v0_train.cu on csrc/mlp_tc.cuh).

On the CPU: the transposed weight stream of the backward
(`pack_v0_weights_tct`) against the header's `TCT_*` offsets and the
m16n8k8 B layout, the state layout against the kernel's constants, a CPU
emulation of the kernel's 3xTF32 forward, deltas and dW (read back from
the packed streams, every product as lo.hi + hi.lo + hi.hi of split
operands) against a float64 run of the twin at full width (W = 128), and
the wrappers' refusals. On a card (tests/conftest.py imports JAX, which
the card's machine does not have, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_mlp_train_tc.py

K7's forward and backward against their twins and a float64 run of the
twin at N in {1, 31, 129, 4099, 131072} (a partial tile, several tiles,
the fine-tune batch), the zero PE and view-direction slices of dx, the
kernel's weight streams against the Python packings, and bit-identical dW
over two calls.

Tolerances, chip_smoke.py's: TOL_K7 = 1e-5 x (1 + max|twin|) for the
forward (sums in another order, 3xTF32 products); the backward by
TOL_K7_BWD's rule, |kernel - twin| <= 5 x max(|twin - float64|, 1e-6 x
max|float64|). Samples within KINK = 5e-6 of a ReLU kink get a zero
cotangent, as in chip_smoke.py's phase 6c: float32 routes put them on
either side of it.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

TOL_K7, TOL_K7_BWD, KINK = 1e-5, 5.0, 5e-6
CSRC = Path(__file__).resolve().parents[1] / "mvsnerf_tpu_torch" / "csrc"


def _mlp(seed=0, dtype=torch.float32, device="cpu"):
    """The v0 MLP with chip_smoke.py's seeded draw: weights uniform in
    +-1/sqrt(fan_in), biases N(0, 0.05)."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    gen = torch.Generator().manual_seed(seed)
    m = MVSNeRF()
    with torch.no_grad():
        for _, p in m.named_parameters():
            if p.dim() > 1:
                b = 1.0 / math.sqrt(p[0].numel())
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * b)
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return m.to(device=device, dtype=dtype).eval()


def _inputs(seed, n, device="cpu"):
    """x (n, 86) as the fine-tune step builds it: PE of NDC in [0, 1],
    20 features, a unit view direction; and a cotangent g (n, 4)."""
    from mvsnerf_tpu_torch.ops.encoding import positional_encoding
    rng = np.random.default_rng(seed)
    ndc = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32))
    feats = torch.tensor(rng.standard_normal((n, 20)).astype(np.float32))
    d = rng.standard_normal((n, 3))
    dirs = torch.tensor((d / np.linalg.norm(d, axis=-1, keepdims=True))
                        .astype(np.float32))
    x = torch.cat([positional_encoding(ndc, 10), feats, dirs], -1)
    g = torch.tensor(rng.standard_normal((n, 4)).astype(np.float32)) / n
    return x.contiguous().to(device), g.to(device)


def _kink_free(mlp, x, g):
    """g with the samples at a ReLU kink zeroed (chip_smoke.py's rule)."""
    from mvsnerf_tpu_torch.ops.mlp_train import relu_margin
    g = g.clone()
    g[relu_margin(mlp, x) <= KINK] = 0.0
    return g


def _bwd_tol(plain, ref):
    return TOL_K7_BWD * max(float((plain.double() - ref).abs().max()),
                            1e-6 * float(ref.abs().max()))


# ------------------------------------------------------- the layouts ----

def _header_offsets(prefix):
    text = (CSRC / "mlp_tc.cuh").read_text()
    return {name: int(v) for name, v in
            re.findall(rf"constexpr int ({prefix}_\w+) = (\d+);", text)}


def test_tct_offsets_match_the_header():
    from mvsnerf_tpu_torch.ops import render_fused as rf
    assert _header_offsets("TCT") == {**rf.TCT_OFFSETS,
                                      "TCT_TOTAL": rf.TCT_TOTAL}
    assert rf.TCT_TOTAL == 219136


def test_state_layout_matches_the_kernel():
    """STATE_FLOATS and TILE mirror ST_ROWS and ROWS of the kernel, and the
    scratch sizes follow them."""
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops.render_fused import N_WEIGHTS
    text = (CSRC / "mlp_v0_train.cu").read_text()
    assert f"static_assert(ST_ROWS == {k7.STATE_FLOATS}," in text
    assert re.search(rf"constexpr int ROWS = {k7.TILE};", text)
    assert k7.STATE_FLOATS <= 1092
    assert k7.scratch_floats(1) == 471040 + 128 * 1092
    assert k7.scratch_floats(129) - k7.scratch_floats(128) == 128 * 1092
    assert f"HEADS = HD_WV + NVD * WH;  // {k7.HEAD_FLOATS}" in text
    assert k7.work_floats(131072) == 131072 * 1092 + 1024 * 516 + \
        4 * k7.N_SPLITS * N_WEIGHTS


def _unpack(stream, off, k, n):
    """The (K, N) hi and lo matrices of the layer at `off` of a stream:
    the inverse of `fragment_order`."""
    blk = stream[off:off + k * n * 2].view(k // 8, n // 8, 32, 4)

    def inverse(f):
        return f.reshape(k // 8, n // 8, 8, 4, 2).permute(0, 4, 3, 1, 2) \
            .reshape(k, n)
    return inverse(blk[..., :2]), inverse(blk[..., 2:])


def _unpack_t(tct, name):
    """One layer of the transposed stream as (K, N) hi and lo."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    cols, k = next((c, k) for nm, _, c, k in rf.TCT_LAYERS if nm == name)
    return _unpack(tct, rf.TCT_OFFSETS[name], k, len(cols))


def _unpack_f(tc, name):
    """One layer of the forward stream as (K, N) hi and lo."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    rows, n = next((r, n) for nm, _, r, n in rf.TC_LAYERS if nm == name)
    return _unpack(tc, rf.TC_OFFSETS[name], len(rows), n)


def test_tct_packing_is_each_layer_transposed_and_split():
    """Layer name's (K, N) block holds W^T (K = its outputs, N = the input
    rows the deltas need), zero-padded, each weight as its TF32 split."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    mlp = _mlp(4)
    tct = rf.pack_v0_weights_tct(rf.pack_v0_weights(mlp))
    assert tct.shape == (rf.TCT_TOTAL,) and tct.dtype == torch.float32
    for name, layer, cols, k in rf.TCT_LAYERS:
        hi, lo = _unpack_t(tct, name)
        assert hi.shape == (k, len(cols))
        lin = mlp.nerf.get_submodule(layer)
        for n, r in enumerate(cols):
            if r < 0:  # zero padding of N
                assert not hi[:, n].any() and not lo[:, n].any(), (name, n)
                continue
            want = lin.weight[:, r].detach()
            assert torch.equal(hi[:, n], rf.split_tf32(want)[0]), (name, n)
            assert torch.equal(lo[:, n], rf.split_tf32(want)[1]), (name, n)


def test_tct_stream_reads_in_whole_chunks():
    """Each k-step of the delta kernel's products lies inside one 32 KB
    chunk of the stream (csrc/mlp_tc.cuh `WeightStream`)."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    chunk = 8192
    for name, _, cols, k in rf.TCT_LAYERS:
        step, off = 16 * len(cols), rf.TCT_OFFSETS[name]
        for kb in range(k // 8):
            lo = off + kb * step
            assert lo // chunk == (lo + step - 1) // chunk, (name, kb)


# --------------------------------------------------- the emulated kernel ----

def _trunc(v):
    """The TF32 bits the tensor core reads from a float32 (truncation)."""
    return (v.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split_act(a):
    """An activation's split as the kernel makes it: hi rounded to TF32,
    lo the remainder, read by the tensor core to TF32 (truncated)."""
    from mvsnerf_tpu_torch.ops.render_fused import split_tf32
    hi = split_tf32(a)[0]
    return hi, _trunc(a - hi)


def _mm3(a, wh, wl):
    """3xTF32: lo(a).hi(w) + hi(a).lo(w) + hi(a).hi(w), f32 sums."""
    ah, al = _split_act(a)
    return al @ wh + ah @ wl + ah @ wh


def _emulated_k7(x, g, mlp):
    """K7's arithmetic on the CPU, (out (N, 4), dx feats (N, 20), packed
    dW): every hidden-width product from the packed streams in 3xTF32;
    the heads, the views layer's direction term and every elementwise step
    in f32; dW = sum over samples of split input^T . split delta in
    3xTF32, the heads' weights and every bias as f32 sums."""
    from mvsnerf_tpu_torch.ops import render_fused as rf
    w = rf.pack_v0_weights(mlp).detach()
    tc, tct = rf.pack_v0_weights_tc(w), rf.pack_v0_weights_tct(w)
    nerf = mlp.nerf
    n = len(x)

    def fwd(a, name):
        return _mm3(a, *_unpack_f(tc, name))

    def bwd(a, name):
        return _mm3(a, *_unpack_t(tct, name))

    def zeros(c):
        return x.new_zeros(n, c)

    pe, ft, vd = x[:, :63], x[:, 63:83], x[:, 83:]
    pe64 = torch.cat([pe, zeros(1)], 1)
    bias = nerf.pts_bias.bias + fwd(torch.cat([ft, zeros(4)], 1),
                                    "TC_PTS_BIAS")
    pres = [nerf.pts_linears[0].bias + fwd(pe64, "TC_PTS_0")]
    hs = [torch.relu(pres[0] * bias)]
    for i in range(1, 5):
        pres.append(nerf.pts_linears[i].bias + fwd(hs[-1], f"TC_PTS_{i}"))
        hs.append(torch.relu(pres[-1] * bias))
    pres.append(nerf.pts_linears[5].bias +
                fwd(torch.cat([pe64, hs[-1]], 1), "TC_PTS_5"))
    hs.append(torch.relu(pres[-1] * bias))
    pre_a = hs[5] @ nerf.alpha_linear.weight[0] + nerf.alpha_linear.bias
    feat = nerf.feature_linear.bias + fwd(hs[5], "TC_FEATURE")
    views = nerf.views_linears[0]
    pre_v = views.bias + vd @ views.weight[:, 128:].T + fwd(feat, "TC_VIEWS")
    hv = torch.relu(pre_v)
    pre_r = hv @ nerf.rgb_linear.weight.T + nerf.rgb_linear.bias
    out = torch.cat([torch.sigmoid(pre_r), torch.relu(pre_a)[:, None]], 1)

    s = torch.sigmoid(pre_r)
    d_r = g[:, :3] * s * (1 - s)
    d_a = torch.where(pre_a > 0, g[:, 3], 0.0)
    d_v = torch.where(pre_v > 0, d_r @ nerf.rgb_linear.weight, 0.0)
    d_feat = bwd(d_v, "TCT_VIEWS")
    dh = nerf.alpha_linear.weight[0] * d_a[:, None] + bwd(d_feat,
                                                         "TCT_FEATURE")
    d_pre, d_bias = [None] * 6, torch.zeros_like(bias)
    for l in range(5, -1, -1):
        dt = torch.where(pres[l] * bias > 0, dh, 0.0)
        d_bias = d_bias + dt * pres[l]
        d_pre[l] = dt * bias
        if l:
            dh = bwd(d_pre[l], f"TCT_PTS_{l}")
    d_feats = bwd(d_bias, "TCT_PTS_BIAS")[:, :20]

    def dw3(a, d):
        """sum over samples of a^T d, both operands split as staged"""
        (ah, al), (dh_, dl) = _split_act(a), _split_act(d)
        return al.T @ dh_ + ah.T @ dl + ah.T @ dh_

    grads = {"pts_linears.0": (dw3(pe, d_pre[0]), d_pre[0].sum(0)),
             "pts_bias": (dw3(ft, d_bias), d_bias.sum(0)),
             "pts_linears.5": (torch.cat([dw3(pe, d_pre[5]),
                                          dw3(hs[4], d_pre[5])]),
                               d_pre[5].sum(0)),
             "alpha_linear": (hs[5].T @ d_a[:, None], d_a.sum(0, True)),
             "feature_linear": (dw3(hs[5], d_feat), d_feat.sum(0)),
             "views_linears.0": (torch.cat([dw3(feat, d_v), vd.T @ d_v]),
                                 d_v.sum(0)),
             "rgb_linear": (hv.T @ d_r, d_r.sum(0))}
    for i in range(1, 5):
        grads[f"pts_linears.{i}"] = (dw3(hs[i - 1], d_pre[i]),
                                     d_pre[i].sum(0))
    dw = torch.cat([torch.cat([grads[name][0].reshape(-1), grads[name][1]])
                    for name, _, _ in rf._LAYERS])
    return out, d_feats, dw


def test_emulated_3xtf32_k7_meets_its_tolerances_against_float64():
    """At full width on a few thousand samples, the emulated forward is
    within TOL_K7 of the twin and of float64, and its d feats and dW
    within TOL_K7_BWD's rule of the twin."""
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_bwd_plain
    mlp, m64 = _mlp(0), _mlp(0, torch.float64)
    x, g = _inputs(11, 3000)
    g = _kink_free(mlp, x, g)
    with torch.no_grad():
        out, d_feats, dw = _emulated_k7(x, g, mlp)
        twin, ref = mlp(x), m64(x.double())
    f_tol = TOL_K7 * (1 + float(twin.abs().max()))
    assert float((out - twin).abs().max()) <= f_tol
    assert float((out.double() - ref).abs().max()) <= f_tol
    dx_p, dw_p = mlp_v0_bwd_plain(mlp, x, g)
    dx_64, dw_64 = mlp_v0_bwd_plain(m64, x.double(), g.double())
    f = slice(63, 83)
    assert float((d_feats - dx_p[:, f]).abs().max()) <= \
        _bwd_tol(dx_p[:, f], dx_64[:, f])
    assert float((dw - dw_p).abs().max()) <= _bwd_tol(dw_p, dw_64)
    assert float((dw.double() - dw_64).abs().max()) <= \
        _bwd_tol(dw_p, dw_64)


# --------------------------------------------------------- the refusals ----

def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


FWD_CASES = {
    "x of 85 channels": (dict(x=_meta(8, 85)), "bad shapes"),
    "x 3-D": (dict(x=_meta(2, 4, 86)), "bad shapes"),
    "packed one short": (dict(packed=_meta(126787)), "bad shapes"),
    "x float64": (dict(x=_meta(8, 86, dtype=torch.float64)),
                  "x must be contiguous float32"),
    "x not contiguous": (dict(x=_meta(86, 8).t()), "x must be contiguous"),
    "packed on the CPU": (dict(packed=torch.empty(126788)),
                          "packed must be contiguous float32 on meta"),
    "scratch one short": (dict(scratch=-1), "not mlp_v0_scratch"),
    "scratch for another N": (dict(scratch=300), "not mlp_v0_scratch"),
    "scratch float16": (dict(scratch="half"), "not mlp_v0_scratch"),
}


def _fwd_args(change):
    from mvsnerf_tpu_torch.ops.mlp_train import scratch_floats
    args = dict(x=_meta(8, 86), packed=_meta(126788), scratch=0)
    args.update(change)
    s = args["scratch"]
    n = scratch_floats(len(args["x"]))
    args["scratch"] = _meta(n, dtype=torch.float16) if s == "half" else \
        _meta(scratch_floats(s) if s > 0 else n + s)
    return args


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_fwd_kernel_refuses(case):
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_fwd_kernel
    change, msg = FWD_CASES[case]
    with pytest.raises(ValueError, match=msg):
        mlp_v0_fwd_kernel(**_fwd_args(change))


BWD_CASES = {
    "cotangent of 3 channels": (dict(g=_meta(8, 3)), "bad cotangent"),
    "cotangent of another N": (dict(g=_meta(9, 4)), "bad cotangent"),
    "cotangent float64": (dict(g=_meta(8, 4, dtype=torch.float64)),
                          "bad cotangent"),
    "no samples": (dict(x=_meta(0, 86), g=_meta(0, 4)), "bad cotangent"),
    "x of 87 channels": (dict(x=_meta(8, 87)), "bad shapes"),
    "scratch one short": (dict(scratch=-1), "not mlp_v0_scratch"),
}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_kernel_refuses(case):
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_bwd_kernel
    change, msg = BWD_CASES[case]
    args = _fwd_args({k: v for k, v in change.items() if k != "g"})
    g = change.get("g", _meta(8, 4))
    with pytest.raises(ValueError, match=msg):
        mlp_v0_bwd_kernel(g, **args)


def test_streams_refuse_a_bad_pack():
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_streams
    with pytest.raises(ValueError, match="packed must be contiguous"):
        mlp_v0_streams(_meta(126788, dtype=torch.float64))


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_mlp_train_tc.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 129, 4099, 131072])
def test_k7_matches_twin_and_float64_on_the_card(card, n):
    from mvsnerf_tpu_torch.ops import mlp_train as k7
    from mvsnerf_tpu_torch.ops.render_fused import pack_v0_weights
    mlp, m64 = _mlp(1, device=card), _mlp(1, torch.float64, card)
    x, g = _inputs(n, n, card)
    g = _kink_free(mlp, x, g)
    with torch.no_grad():
        packed = pack_v0_weights(mlp)
        scratch = k7.mlp_v0_scratch(n, card)
        before = (k7.mlp_v0_train.launches, k7.mlp_v0_train.bwd_launches)
        out = k7.mlp_v0_fwd_kernel(x, packed, scratch)
        dx, dw = k7.mlp_v0_bwd_kernel(g, x, packed, scratch)
        dx2, dw2 = k7.mlp_v0_bwd_kernel(g, x, packed, scratch)
        torch.cuda.synchronize()
        twin, ref = mlp(x), m64(x.double())
    assert (k7.mlp_v0_train.launches, k7.mlp_v0_train.bwd_launches) == \
        (before[0] + 1, before[1] + 2)
    f_tol = TOL_K7 * (1 + float(twin.abs().max()))
    assert float((out - twin).abs().max()) <= f_tol
    assert float((out.double() - ref).abs().max()) <= f_tol
    dx_p, dw_p = k7.mlp_v0_bwd_plain(mlp, x, g)
    dx_64, dw_64 = k7.mlp_v0_bwd_plain(m64, x.double(), g.double())
    f = slice(63, 83)
    assert float((dx[:, f] - dx_p[:, f]).abs().max()) <= \
        _bwd_tol(dx_p[:, f], dx_64[:, f])
    assert float((dw - dw_p).abs().max()) <= _bwd_tol(dw_p, dw_64)
    assert torch.count_nonzero(dx[:, :63]) == 0
    assert torch.count_nonzero(dx[:, 83:]) == 0
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


@pytest.mark.cuda
def test_k7_streams_are_the_python_packings_on_the_card(card):
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_streams
    with torch.no_grad():
        packed = rf.pack_v0_weights(_mlp(5, device=card))
        streams = mlp_v0_streams(packed)
        assert torch.equal(streams[:rf.TC_TOTAL],
                           rf.pack_v0_weights_tc(packed))
        assert torch.equal(streams[rf.TC_TOTAL:],
                           rf.pack_v0_weights_tct(packed))


@pytest.mark.cuda
def test_k7_autograd_lands_on_the_module_on_the_card(card):
    """backward() through mlp_v0_train on the card fills each nn.Linear's
    .grad within TOL_K7_BWD's rule of the twin's, and x's gradient only
    in the feats slice."""
    from mvsnerf_tpu_torch.ops.mlp_train import mlp_v0_train
    mlp, m64 = _mlp(2, device=card), _mlp(2, torch.float64, card)
    x, g = _inputs(2, 2000, card)
    g = _kink_free(mlp, x, g)
    xr = x.clone().requires_grad_()
    mlp_v0_train(mlp, xr).backward(g)
    m64(x.double()).backward(g.double())
    got = {n: p.grad for n, p in mlp.named_parameters()}
    mlp.zero_grad()
    mlp(x).backward(g)
    for (n, p), p64 in zip(mlp.named_parameters(), m64.parameters()):
        assert float((got[n] - p.grad).abs().max()) <= \
            _bwd_tol(p.grad, p64.grad), n
    assert torch.count_nonzero(xr.grad[:, :63]) == 0
    assert torch.count_nonzero(xr.grad[:, 83:]) == 0
