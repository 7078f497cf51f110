"""K10's transposed stride-2 convolution (csrc/conv3d.cu
`conv3d_up_cell_kernel`): the up layers' forward and the stride-2
layers' input gradient on the dband route.

On the CPU: an emulation of the kernel's work split, each thread on a
cell of the 2 x 2 output rows (2 md + {0, 1}, 2 mh + {0, 1}) and the four
W outputs 4q .. 4q + 3 of each, from the inputs 2q, 2q + 1 and 2q + 2
(zero past the row's end) of the 2 x 2 input rows (md, mh) .. (md + 1,
mh + 1), held to the plain twin `conv3d_up_plain`, a float64
run of it and `torch.nn.functional.conv_transpose3d` within TOL_K10 x (1
+ max|twin|) (chip_smoke.py's K10 rule), with every output written once.
On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_costreg_up.py

the kernel at every up call of the dband U-Net at its DTU shape (conv7,
conv9 and conv11 forward; conv1, conv3 and conv5 input gradients), at odd
widths, widths that are not a multiple of 4, and Do < 2 Di, against the
twin and float64.
"""

import pytest
import torch
import torch.nn.functional as F

TOL_K10 = 1e-5


def _k10():
    from mvsnerf_tpu_torch.ops import costreg_conv
    return costreg_conv


def _emulate_up(x, w, size):
    """The kernel's split of y = conv_transpose(x, w) (stride 2, pad 1)
    into cells: each of the 2 x 2 output rows (2 md + ed, 2 mh + eh) and
    the four W outputs 4q .. 4q + 3, from the input rows (md, mh) ..
    (md + 1, mh + 1) through the 9 (row, kd, kh) taps; returns y and the
    number of times each output was written."""
    cin, di, hi, wi = x.shape[1:]
    cout = w.shape[1]
    do, ho, wo = size
    nmd, nmh, nq = (do + 1) // 2, (ho + 1) // 2, (wi + 1) // 2
    # inputs 2q .. 2q + 2 of every quad, zero past the row's end; rows
    # past the input's end read zeros
    xp = F.pad(x[0], (0, 2 * nq + 1 - wi, 0, nmh + 1 - hi, 0, nmd + 1 - di))
    q = torch.arange(nq)
    md, mh = torch.arange(nmd), torch.arange(nmh)
    acc = torch.zeros(4, 4, cout, nmd, nmh, nq, dtype=x.dtype)
    for td in range(3):           # 0: even (k 1), 1: odd k 0, 2: odd k 2
        for th in range(3):
            kd, kh = (1, 0, 2)[td], (1, 0, 2)[th]
            rows = xp[:, md + (td == 1)][:, :, mh + (th == 1)]
            x0, x1, x2 = (rows[..., 2 * q + k] for k in range(3))
            wk = [w[:, :, kd, kh, kw] for kw in range(3)]

            def mac(wm, xv):
                return torch.einsum("io,idhq->odhq", wm, xv)
            e = (td > 0) * 2 + (th > 0)
            acc[e, 0] += mac(wk[1], x0)
            acc[e, 1] += mac(wk[0], x1) + mac(wk[2], x0)
            acc[e, 2] += mac(wk[1], x1)
            acc[e, 3] += mac(wk[0], x2) + mac(wk[2], x1)
    y = torch.zeros(cout, do, ho, wo, dtype=x.dtype)
    writes = torch.zeros(do, ho, wo, dtype=torch.int64)
    for e in range(4):
        od, oh = 2 * md + (e >> 1), 2 * mh + (e & 1)
        kd_, kh_ = od < do, oh < ho
        for k in range(4):
            ow = 4 * q + k
            kw_ = ow < wo
            sel = (slice(None), od[kd_][:, None, None], oh[kh_][None, :, None],
                   ow[kw_][None, None])
            y[sel] = acc[e, k][:, kd_][:, :, kh_][..., kw_]
            writes[sel[1:]] += 1
    return y[None], writes


# (Cin, Cout, input grid, output size): the DTU up layers at a fraction of
# their grid, an odd width, widths not a multiple of 4, Do < 2 Di, W = 1
EMU_CASES = [(64, 32, (2, 3, 26), (4, 6, 52)),
             (16, 8, (3, 2, 13), (6, 4, 26)),
             (5, 7, (3, 4, 7), (6, 8, 14)),
             (5, 7, (3, 4, 7), (5, 7, 13)),
             (3, 9, (4, 5, 6), (7, 9, 11)),
             (17, 24, (2, 3, 1), (4, 6, 2))]


@pytest.mark.parametrize("cin,cout,dhw,size", EMU_CASES,
                         ids=[f"{c[0]}to{c[1]}-{'x'.join(map(str, c[2]))}-"
                              f"{'x'.join(map(str, c[3]))}"
                              for c in EMU_CASES])
def test_emulated_cells_meet_tol_k10(cin, cout, dhw, size):
    k10 = _k10()
    gen = torch.Generator().manual_seed(cin * 31 + cout)
    x = torch.randn(1, cin, *dhw, generator=gen)
    w = torch.randn(cin, cout, 3, 3, 3, generator=gen) * (27 * cin) ** -0.5
    got, writes = _emulate_up(x, w, size)
    assert bool((writes == 1).all())
    twin = k10.conv3d_up_plain(x, w, size)
    tol = TOL_K10 * (1 + float(twin.abs().max()))
    assert float((got - twin).abs().max()) <= tol
    ref = k10.conv3d_up_plain(x.double(), w.double(), size)
    assert float((got.double() - ref).abs().max()) <= tol
    full = F.conv_transpose3d(x.double(), w.double(), stride=2, padding=1,
                              output_padding=1)
    lib = full[..., :size[0], :size[1], :size[2]]
    assert float((got.double() - lib).abs().max()) <= tol


def test_up_kernel_refuses():
    k10 = _k10()
    x, w = torch.zeros(1, 4, 3, 3, 3), torch.zeros(4, 2, 3, 3, 3)
    with pytest.raises(ValueError, match="not a CUDA device"):
        k10.conv3d_up_kernel(x, w, (6, 6, 6))
    with pytest.raises(ValueError, match="channels"):
        k10.conv3d_up_kernel(x, torch.zeros(5, 2, 3, 3, 3), (6, 6, 6))


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_costreg_up.py`")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


# (name, Cin, Cout, input grid): every up call of a dband step at DTU size
# (the up layers' forward; the stride-2 layers' dgrad, on the layer's
# (Cout, Cin) kernel as stored, from its output's grid to its input's)
UP_LAYERS = [("conv7", 64, 32, (16, 22, 26)), ("conv9", 32, 16,
                                                 (32, 44, 52)),
             ("conv11", 16, 8, (64, 88, 104)),
             ("conv1_dgrad", 16, 8, (64, 88, 104)),
             ("conv3_dgrad", 32, 16, (32, 44, 52)),
             ("conv5_dgrad", 64, 32, (16, 22, 26))]
# odd widths, widths not a multiple of 4, Do < 2 Di, W = 1, a ragged grid
UP_ODD = [(5, 7, (3, 4, 7), (6, 8, 14)), (5, 7, (3, 4, 7), (5, 7, 13)),
          (3, 9, (4, 5, 6), (7, 9, 11)), (16, 8, (5, 6, 26), (10, 12, 52)),
          (17, 24, (2, 3, 1), (4, 6, 2)), (32, 16, (9, 21, 35), (17, 41, 70))]


def _check_up(card, cin, cout, dhw, size, seed):
    k10 = _k10()
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn(1, cin, *dhw, generator=gen, device=card)
    w = torch.randn(cin, cout, 3, 3, 3, generator=gen, device=card) * \
        (27 * cin) ** -0.5
    before = k10.launches["up"]
    y = k10.conv3d_up_kernel(x, w, size)
    torch.cuda.synchronize()
    assert k10.launches["up"] == before + 1
    assert tuple(y.shape) == (1, cout, *size)
    twin = k10.conv3d_up_plain(x, w, size)
    tol = TOL_K10 * (1 + float(twin.abs().max()))
    assert float((y - twin).abs().max()) <= tol
    del twin
    ref = k10.conv3d_up_plain(x.double(), w.double(), size)
    assert float((y.double() - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("layer", UP_LAYERS, ids=[c[0] for c in UP_LAYERS])
def test_up_layer_matches_twin_and_float64_on_the_card(card, layer):
    name, cin, cout, dhw = layer
    _check_up(card, cin, cout, dhw, [2 * n for n in dhw], seed=cin + cout)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,dhw,size", UP_ODD,
                         ids=[f"{c[0]}to{c[1]}-{'x'.join(map(str, c[2]))}-"
                              f"{'x'.join(map(str, c[3]))}" for c in UP_ODD])
def test_up_odd_shapes_on_the_card(card, cin, cout, dhw, size):
    _check_up(card, cin, cout, dhw, size, seed=3)
