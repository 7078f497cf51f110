"""K10: the CostRegNet U-Net's 3x3x3 convolutions on hand-written kernels
(the `--costreg_impl dband` route), and their plain twins.

Counterpart of mvsnerf_tpu/ops/pallas_costreg.py:752-908. Activations are
NCDHW with batch 1, as the sweep writes the cost volume; weights keep
PyTorch's layouts, Conv3d (Cout, Cin, 3, 3, 3) and ConvTranspose3d (Cin,
Cout, 3, 3, 3).

    conv3d_s1(x, w)   3x3x3, stride 1, pad 1 (Conv3d)
    conv3d_s2(x, w)   stride 2, pad 1 (Conv3d)
    conv3d_up(x, w)   transposed, stride 2, pad 1, output_padding 1
                      (ConvTranspose3d, models/mvsnet.py)

Each is a `torch.autograd.Function` whose backward is the decomposition of
the JAX custom VJPs, on three operations:

    conv3d_fwd(x, w, stride)     s1 forward, s1 dgrad (on `flip_swap(w)`),
                                 s2 forward, up dgrad (on the up kernel)
    conv3d_up_op(x, w, size)     up forward, s2 dgrad (on the s2 kernel)
    conv3d_wgrad(g, x, stride)   dW[a, b, k] = sum_o g[a, o] x[b, s o + k - 1]
                                 for all three (up by the duality of
                                 pallas_costreg.py:900-904: g = its input, x
                                 = its output's cotangent)

For CUDA tensors each operation launches its kernel in csrc/conv3d.cu (f32
only; stride 1 and every weight gradient on the tensor cores in 3xTF32,
float32-accurate) and counts the launch in `launches`; for CPU tensors it
runs its
plain twin, 27-tap sums of `einsum` over shifted (strided) slices that call
no convolution library; any other device raises. The Functions resolve the
operations through this module's globals, so a caller can put the twins in
their place on a card (chip_smoke.py's float64 reference).

The TPU kernels' layout contracts have no counterpart here: the banded
weight matrices (`build_a`, `build_a_up`), `_shift_lanes`, `_pad_w` to
128 lanes, `_pad_rows`, `_check_blocks`, `_check_vmem`, the even/odd column
split (`split_w`, `interleave_w`) and the block pickers (`_pick_block`,
`_pick_rows`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .._build import check, library, stream_of

# kernel launches by kernel: conv3d_fwd at stride 1 and 2, conv3d_up,
# conv3d_wgrad (which runs its partial-sum and reduction kernels together)
launches = {"s1": 0, "s2": 0, "up": 0, "wgrad": 0}
# the stride-2 conv3d_fwd launches by route (csrc/conv3d.cu
# `conv3d_s2_pairs`): "pair", conv3d_s2_pair_kernel (input widths that are
# a multiple of 4, DTU's 208 -> 104 -> 52); "generic", conv3d_fwd_kernel<2>
# (the others, Blender's 62 -> 31)
s2_routes = {"pair": 0, "generic": 0}


# input channels per chunk of the tensor-core kernels' K (forward) and M
# (wgrad) order: (chunk, tap, channel in the chunk); csrc/conv3d.cu `CC`
CC = 8


def k_steps(cin):
    """8-deep k-steps of the stride-1 GEMM's K over `cin` channels: 27 a
    full chunk, the last, partial chunk's 27 nc taps rounded up to 8."""
    return 27 * (cin // CC) + (27 * (cin % CC) + 7) // 8


def k_order(cin):
    """(channel, tap) of each k of the stride-1 GEMM's K, (-1, -1) for the
    padding (conv3d.cu `conv3d_pack_kernel`)."""
    order = []
    for c0 in range(0, cin, CC):
        nc = min(CC, cin - c0)
        order += [(c0 + c, tap) for tap in range(27) for c in range(nc)]
    return order + [(-1, -1)] * (8 * k_steps(cin) - len(order))


def packed_floats(cin, cout, stride):
    """Floats of the packed weights `conv3d_fwd` takes (0 at stride 2)."""
    return 0 if stride == 2 else k_steps(cin) * -(-cout // 8) * 128


def pack_weights_tc(w):
    """Plain twin of conv3d_pack_kernel: w (Cout, Cin, 3, 3, 3) -> the
    stride-1 GEMM's B = W^T in the k_order, zero-padded to whole k-steps
    and n-tiles of 8, as (k-step, n-tile, lane 4 g + t, {hi(b0), hi(b1),
    lo(b0), lo(b1)}) with b0 = B[8 ks + t, 8 nb + g], b1 four rows down;
    hi and lo rounded to TF32 (`render_fused.split_tf32`). Flat."""
    from .render_fused import fragment_order, split_tf32
    cout, cin = w.shape[:2]
    idx = torch.tensor([c * 27 + tap if c >= 0 else cin * 27
                        for c, tap in k_order(cin)])
    wf = torch.cat([w.reshape(cout, cin * 27), w.new_zeros(cout, 1)], 1)
    b = w.new_zeros(len(idx), 8 * -(-cout // 8))
    b[:, :cout] = wf[:, idx].t()
    hi, lo = (fragment_order(m) for m in split_tf32(b))
    return torch.cat([hi, lo], -1).reshape(-1)


def flip_swap(w):
    """(O, I, 3, 3, 3) -> (I, O, 3, 3, 3) spatially flipped: the dgrad
    kernel of a stride-1 'same' convolution (pallas_costreg.py:752)."""
    return w.flip(2, 3, 4).transpose(0, 1).contiguous()


def out_size(size, stride):
    """Output extent of a 3-tap convolution with pad 1."""
    return (size - 1) // stride + 1


# ------------------------------------------------------------ plain twins --

def _taps(xp, stride, size):
    """The 27 (tap, slice) pairs of the padded `xp` (C, D, H, W): for tap
    (kd, kh, kw) the (C, *size) slice xp[:, kd + s o, kh + s o, kw + s o]."""
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                yield (kd, kh, kw), xp[
                    :, kd:kd + stride * (size[0] - 1) + 1:stride,
                    kh:kh + stride * (size[1] - 1) + 1:stride,
                    kw:kw + stride * (size[2] - 1) + 1:stride]


def _pad_for(x, stride, size):
    """x (C, D, H, W) zero-padded by 1 in front and enough behind for
    `size` outputs at `stride`."""
    hi = [max(0, stride * (n - 1) + 2 - s) for n, s in zip(size, x.shape[1:])]
    return F.pad(x, (1, hi[2], 1, hi[1], 1, hi[0]))


def conv3d_fwd_plain(x, w, stride):
    """Plain twin of conv3d_fwd: (1, Cin, D, H, W) -> (1, Cout, ...)."""
    size = [out_size(s, stride) for s in x.shape[2:]]
    y = None
    for (kd, kh, kw), xs in _taps(_pad_for(x[0], stride, size), stride, size):
        t = torch.einsum("oc,cdhw->odhw", w[:, :, kd, kh, kw], xs)
        y = t if y is None else y + t
    return y[None]


def conv3d_up_plain(x, w, size):
    """Plain twin of conv3d_up_op: x (1, Cin, D, H, W), w (Cin, Cout, 3, 3,
    3) -> (1, Cout, *size), y[o] = sum over o = 2 i - 1 + k of w[k] x[i]:
    each tap's product lands on the strided slice 2 i + k of a buffer
    shifted by the pad."""
    d, h, wd = x.shape[2:]
    buf = x.new_zeros((w.shape[1], 2 * d + 1, 2 * h + 1, 2 * wd + 1))
    for kd in range(3):
        for kh in range(3):
            for kw in range(3):
                buf[:, kd:kd + 2 * d:2, kh:kh + 2 * h:2, kw:kw + 2 * wd:2] += \
                    torch.einsum("io,idhw->odhw", w[:, :, kd, kh, kw], x[0])
    return buf[None, :, 1:1 + size[0], 1:1 + size[1], 1:1 + size[2]]


def conv3d_wgrad_plain(g, x, stride):
    """Plain twin of conv3d_wgrad: g (1, A, Dg, Hg, Wg), x (1, B, Dx, Hx,
    Wx) -> (A, B, 3, 3, 3)."""
    size = g.shape[2:]
    dw = g.new_empty((g.shape[1], x.shape[1], 3, 3, 3))
    for (kd, kh, kw), xs in _taps(_pad_for(x[0], stride, size), stride, size):
        dw[:, :, kd, kh, kw] = torch.einsum("adhw,bdhw->ab", g[0], xs)
    return dw


# ---------------------------------------------------------------- kernels --

def _check(name, x, w, w_layout):
    """Shapes, dtype, device and contiguity the kernels take."""
    if x.dim() != 5 or x.shape[0] != 1 or w.dim() != 5 or \
            tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"{name}: needs x (1, C, D, H, W) and a 3x3x3 "
                         f"kernel, got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.shape[1] != w.shape[w_layout]:
        raise ValueError(f"{name}: x has {x.shape[1]} channels, the kernel "
                         f"{tuple(w.shape)}")
    for what, t in (("x", x), ("kernel", w)):
        if t.dtype != torch.float32 or t.device != x.device or \
                not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous float32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")


def _on_card(name, x):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: {x.device} is not a CUDA device")


def conv3d_fwd_kernel(x, w, stride, packed=None):
    """conv3d_fwd on the card: x (1, Cin, D, H, W), w (Cout, Cin, 3, 3,
    3). At stride 1 the call first splits w into `packed` (scratch of
    `packed_floats` floats, allocated when not given; it then holds
    `pack_weights_tc(w)`)."""
    _check("conv3d_fwd kernel", x, w, 1)
    if stride not in (1, 2):
        raise ValueError(f"conv3d_fwd kernel: stride {stride}")
    n_packed = packed_floats(x.shape[1], w.shape[0], stride)
    if packed is None:
        packed = torch.empty(n_packed, device=x.device)
    elif packed.shape != (n_packed,) or packed.dtype != torch.float32 or \
            packed.device != x.device or not packed.is_contiguous():
        raise ValueError(f"conv3d_fwd kernel: packed must be contiguous "
                         f"float32 ({n_packed},) on {x.device}, got "
                         f"{packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
    _on_card("conv3d_fwd kernel", x)
    size = [out_size(s, stride) for s in x.shape[2:]]
    y = torch.empty((1, w.shape[0], *size), device=x.device)
    rc = library().conv3d_fwd(x.data_ptr(), w.data_ptr(), packed.data_ptr(),
                              y.data_ptr(), x.shape[1], w.shape[0],
                              *x.shape[2:], *size, stride, n_packed,
                              stream_of(x))
    check(rc, "conv3d_fwd")
    launches[f"s{stride}"] += 1
    if stride == 2:
        pairs = library().conv3d_s2_pairs(x.shape[4], size[2])
        s2_routes["pair" if pairs else "generic"] += 1
    return y


def conv3d_up_kernel(x, w, size):
    """conv3d_up_op on the card: x (1, Cin, D, H, W), w (Cin, Cout, 3, 3,
    3) -> (1, Cout, *size), each extent at most twice x's."""
    _check("conv3d_up kernel", x, w, 0)
    _on_card("conv3d_up kernel", x)
    size = [int(s) for s in size]
    if any(not 0 < s <= 2 * n for s, n in zip(size, x.shape[2:])):
        raise ValueError(f"conv3d_up kernel: output {size} for input "
                         f"{tuple(x.shape[2:])}")
    y = torch.empty((1, w.shape[1], *size), device=x.device)
    rc = library().conv3d_up(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                             x.shape[1], w.shape[1], *x.shape[2:], *size,
                             stream_of(x))
    check(rc, "conv3d_up")
    launches["up"] += 1
    return y


def conv3d_wgrad_kernel(g, x, stride):
    """conv3d_wgrad on the card: g (1, A, Dg, Hg, Wg), x (1, B, Dx, Hx, Wx)
    -> (A, B, 3, 3, 3), deterministic (partial sums per fixed run of
    voxel boxes, added in order)."""
    for name, t in (("g", g), ("x", x)):
        if t.dim() != 5 or t.shape[0] != 1 or t.dtype != torch.float32 or \
                t.device != g.device or not t.is_contiguous():
            raise ValueError(f"conv3d_wgrad kernel: {name} must be a "
                             f"contiguous float32 (1, C, D, H, W) on "
                             f"{g.device}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if stride not in (1, 2) or any(
            out_size(n, stride) < s for s, n in zip(g.shape[2:],
                                                     x.shape[2:])):
        raise ValueError(f"conv3d_wgrad kernel: g {tuple(g.shape)} does not "
                         f"fit x {tuple(x.shape)} at stride {stride}")
    _on_card("conv3d_wgrad kernel", g)
    A, B = g.shape[1], x.shape[1]
    lib = library()
    n_splits = lib.conv3d_wgrad_splits(A, B, *g.shape[2:], stride)
    if n_splits < 1:
        raise ValueError(f"conv3d_wgrad kernel: sizes {tuple(g.shape)} "
                         f"exceed int32")
    partial = torch.empty((n_splits, A, B * 27), device=g.device)
    dw = torch.empty((A, B, 3, 3, 3), device=g.device)
    rc = lib.conv3d_wgrad(g.data_ptr(), x.data_ptr(), partial.data_ptr(),
                          dw.data_ptr(), A, B, *g.shape[2:], *x.shape[2:],
                          stride, n_splits, stream_of(g))
    check(rc, "conv3d_wgrad")
    launches["wgrad"] += 1
    return dw


def _route(kernel, plain, name):
    def op(a, b, c):
        if a.device.type == "cpu":
            return plain(a, b, c)
        if a.device.type != "cuda":
            raise ValueError(f"{name}: no kernel for {a.device}")
        return kernel(a, b, c)
    op.__name__ = name
    op.__doc__ = f"{kernel.__name__} on CUDA, {plain.__name__} on the CPU."
    return op


conv3d_fwd = _route(conv3d_fwd_kernel, conv3d_fwd_plain, "conv3d_fwd")
conv3d_up_op = _route(conv3d_up_kernel, conv3d_up_plain, "conv3d_up_op")
conv3d_wgrad = _route(conv3d_wgrad_kernel, conv3d_wgrad_plain,
                      "conv3d_wgrad")


# -------------------------------------------------------------- autograd --

class _Conv(torch.autograd.Function):
    """Stride-1 or stride-2 Conv3d, pad 1, no bias."""

    @staticmethod
    def forward(ctx, x, w, stride):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.stride = stride
        return conv3d_fwd(x, w, stride)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = conv3d_fwd(gy, flip_swap(w), 1) if ctx.stride == 1 else \
                conv3d_up_op(gy, w, x.shape[2:])
        if ctx.needs_input_grad[1]:
            gw = conv3d_wgrad(gy, x, ctx.stride)
        return gx, gw, None


class _ConvUp(torch.autograd.Function):
    """ConvTranspose3d, stride 2, pad 1, output_padding 1, no bias."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv3d_up_op(x, w, [2 * s for s in x.shape[2:]])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = conv3d_fwd(gy, w, 2)
        if ctx.needs_input_grad[1]:
            gw = conv3d_wgrad(x, gy, 2)
        return gx, gw


def conv3d_s1(x, w):
    """3x3x3 'same' convolution: x (1, Cin, D, H, W), w (Cout, Cin, 3, 3,
    3) -> (1, Cout, D, H, W), differentiable in both."""
    return _Conv.apply(x, w, 1)


def conv3d_s2(x, w):
    """Stride-2 3x3x3 convolution, pad 1: -> (1, Cout, ceil(D / 2), ...)."""
    return _Conv.apply(x, w, 2)


def conv3d_up(x, w):
    """Transposed stride-2 convolution (ConvTranspose3d semantics, pad 1,
    output_padding 1): x (1, Cin, D, H, W), w (Cin, Cout, 3, 3, 3) -> (1,
    Cout, 2D, 2H, 2W)."""
    return _ConvUp.apply(x, w)
