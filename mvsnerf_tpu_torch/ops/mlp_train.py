"""K7: the v0 MLP for training losses, forward and backward, and the
plain twin.

`mlp_v0_train(mlp, x)` maps x (..., 86) laid out [PE 63 | feats 20 |
viewdirs 3] (the layout of `run_network`) to (..., 4) [rgb, alpha], as the
module does. Gradient contract as in JAX
(mvsnerf_tpu/ops/pallas_mlp.py:35-40, 372-375): exact dW, db and d feats;
zeros for the PE and view-direction slices of x (geometry and view
directions are never trainable).

For CUDA tensors it is a `torch.autograd.Function` over (x, packed
weights) that launches csrc/mlp_v0_train.cu on the tensor cores (3xTF32,
float32-equivalent): the forward (one kernel that splits the weights into
the forward and transposed TF32 streams, then the MLP, which saves 1,092
floats a sample of state into a buffer held until the backward) and the
backward's three kernels (every delta; dW and db over fixed sample
ranges; the fixed-order sum). The packed vector is `pack_v0_weights(mlp)`,
built without detaching, so its gradient flows back through `torch.cat`
onto the module's own nn.Linear parameters. For CPU tensors it is the
module's forward with the PE and view-direction slices of x detached,
which gives the same contract; any other device raises.
`mlp_v0_train_plain` is the module's forward under autograd, the twin the
kernel is held against.

Replaces mvsnerf_tpu/ops/pallas_mlp.py:318 `mlp_v0_train`, reached from
the fine-tune step through `resolve_mlp_impl(training=True)`
(render/renderer.py:212-232, 254-261). What bounds it on the H100: the
products, ~1.25e5 multiply-adds a sample forward and twice that backward,
each run three times on the tensor cores, and the state and delta traffic,
~3.2 GB per 131,072 samples (4.4 KB a sample written by the forward and
read by the deltas, 4.3 KB of deltas written, ~12 KB read by dW)."""

from __future__ import annotations

import torch

from .._build import check, library, stream_of
from .render_fused import _LAYERS, N_WEIGHTS, TC_TOTAL, TCT_TOTAL, \
    pack_v0_weights

IN_PTS, IN_FEAT, IN_VIEWS = 63, 20, 3
IN_CH = IN_PTS + IN_FEAT + IN_VIEWS
# sample ranges a block-unit of the dW kernel (csrc/mlp_v0_train.cu: 33
# units, so 33 x N_SPLITS blocks: 132, one wave on the H100's 132 SMs)
N_SPLITS = 4
STATE_FLOATS = 1092  # floats K7's forward saves a sample (ST_ROWS)
TILE = 128  # samples a block of K7's forward and delta kernels (ROWS)
HEAD_FLOATS = 516  # the heads' weight gradients a tile (HEADS)


def mlp_v0_train_plain(mlp, x):
    """Plain twin of K7: the module's forward under autograd."""
    return mlp(x)


def mlp_v0_bwd_plain(mlp, x, g):
    """Plain twin of K7's backward: autograd of the module's forward, as
    (dx (N, 86), every slice exact; dW in the packed layout)."""
    lins = [mlp.nerf.get_submodule(name) for name, _, _ in _LAYERS]
    params = [p for lin in lins for p in (lin.weight, lin.bias)]
    with torch.enable_grad():
        xs = x.detach().requires_grad_()
        dx, *grads = torch.autograd.grad(mlp(xs), [xs, *params], g)
    return dx, torch.cat([(gr.t() if gr.dim() == 2 else gr).reshape(-1)
                          for gr in grads])


def relu_margin(mlp, x):
    """(N,) relative distance of each sample's nearest ReLU decision from
    its kink, in float64: the smallest |v| / (|W| |input| + |b|) over
    every pre-activation v that a ReLU mask depends on (the trunk's pre_i
    and the bias they multiply, alpha, the views head). Two float32 routes
    sum in other orders, with relative errors of ~1e-7 of that scale, and
    may then put a sample on different sides of a kink; its gradient then
    differs by design. The parity checks leave such samples out. This is
    the one float64 copy of the v0 forward, kept for those checks: it
    needs each layer's scale beside its pre-activation."""
    x = x.detach().double().reshape(-1, IN_CH)
    pe, ft, vd = torch.split(x, [IN_PTS, IN_FEAT, IN_VIEWS], dim=-1)
    margin = torch.full((len(x),), float("inf"), dtype=x.dtype,
                        device=x.device)

    def lin(name, v, kink=True):
        nonlocal margin
        layer = mlp.nerf.get_submodule(name)
        w, b = layer.weight.detach().double(), layer.bias.detach().double()
        pre = v @ w.t() + b
        if kink:
            scale = (v.abs() @ w.abs().t() + b.abs()).clamp_min(1e-300)
            margin = torch.minimum(margin, (pre.abs() / scale).amin(-1))
        return pre

    bias = lin("pts_bias", ft)
    h = pe
    for i in range(6):
        h = torch.relu(lin(f"pts_linears.{i}",
                           torch.cat([pe, h], -1) if i == 5 else h) * bias)
    lin("alpha_linear", h)
    lin("views_linears.0",
        torch.cat([lin("feature_linear", h, kink=False), vd], -1))
    return margin


def _check_args(x, packed):
    dev = x.device
    if x.dim() != 2 or x.shape[1] != IN_CH or packed.shape != (N_WEIGHTS,):
        raise ValueError(f"mlp kernel: bad shapes x {tuple(x.shape)}, "
                         f"weights {tuple(packed.shape)}")
    for name, t in (("x", x), ("packed", packed)):
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"mlp kernel: {name} must be contiguous "
                             f"float32 on {dev}")
    if x.shape[0] * IN_CH >= 2 ** 31:
        raise ValueError(f"mlp kernel: {x.shape[0]} samples exceed int32")


def scratch_floats(n: int) -> int:
    """Floats of the buffer K7's forward fills for its backward (csrc
    checks the count): the two weight streams, then STATE_FLOATS a sample
    in whole tiles of TILE samples."""
    return TC_TOTAL + TCT_TOTAL + -(-n // TILE) * TILE * STATE_FLOATS


def work_floats(n: int) -> int:
    """Floats of the backward's own buffer: the deltas (as many as the
    state), the heads' weight gradients a tile, then the dW kernel's
    partial sums."""
    return -(-n // TILE) * (TILE * STATE_FLOATS + HEAD_FLOATS) + \
        4 * N_SPLITS * N_WEIGHTS


def _check_scratch(scratch, n, dev):
    if scratch.device != dev or scratch.dtype != torch.float32 or \
            not scratch.is_contiguous() or scratch.numel() != \
            scratch_floats(n):
        raise ValueError("mlp kernel: scratch is not mlp_v0_scratch(N)")


def mlp_v0_scratch(n: int, device):
    """The buffer K7's forward fills for its backward, for n samples."""
    return torch.empty(scratch_floats(n), device=device)


def mlp_v0_streams(packed):
    """The weight streams K7's forward writes (`mlp_pack_kernel`): the
    forward stream, as `pack_v0_weights_tc`, then the transposed one, as
    `pack_v0_weights_tct`; (TC_TOTAL + TCT_TOTAL,). For checks: the
    forward writes its own."""
    if packed.shape != (N_WEIGHTS,) or packed.dtype != torch.float32 or \
            not packed.is_contiguous():
        raise ValueError("mlp kernel: packed must be contiguous float32 "
                         f"({N_WEIGHTS},)")
    out = torch.empty(TC_TOTAL + TCT_TOTAL, device=packed.device)
    rc = library().mlp_v0_pack(packed.data_ptr(), out.data_ptr(), N_WEIGHTS,
                               stream_of(packed))
    check(rc, "mlp_v0_pack")
    return out


def mlp_v0_fwd_kernel(x, packed, scratch, save=True):
    """K7 forward on the card: (N, 4) from (N, 86) x (no autograd); fills
    `scratch`, a `mlp_v0_scratch(N)`, with the weight streams and (with
    `save`) the state the backward reads."""
    _check_args(x, packed)
    _check_scratch(scratch, len(x), x.device)
    out = torch.empty((x.shape[0], 4), device=x.device)
    rc = library().mlp_v0_fwd(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(), x.shape[0],
        N_WEIGHTS, scratch.data_ptr(), scratch.numel(), int(save),
        stream_of(x))
    check(rc, "mlp_v0_fwd")
    mlp_v0_train.launches += 1
    return out


def mlp_v0_bwd_kernel(g, x, packed, scratch):
    """K7 backward on the card, from the scratch its forward filled on the
    same x: (dx (N, 86) with only the feats slice non-zero, packed dW
    (N_WEIGHTS,)) for the (N, 4) cotangent `g`."""
    _check_args(x, packed)
    n = x.shape[0]
    if g.shape != (n, 4) or n < 1 or g.device != x.device or \
            g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"mlp kernel: bad cotangent {tuple(g.shape)} "
                         f"{g.dtype} for {n} samples")
    _check_scratch(scratch, n, x.device)
    work = torch.empty(work_floats(n), device=g.device)
    dw = torch.empty(N_WEIGHTS, device=g.device)
    dx = torch.empty((n, IN_CH), device=g.device)
    rc = library().mlp_v0_bwd(
        g.data_ptr(), x.data_ptr(), packed.data_ptr(), scratch.data_ptr(),
        scratch.numel(), work.data_ptr(), work.numel(), dw.data_ptr(),
        dx.data_ptr(), n, N_SPLITS, N_WEIGHTS, stream_of(g))
    check(rc, "mlp_v0_bwd")
    mlp_v0_train.bwd_launches += 1
    return dx, dw


class _MLPv0Train(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, packed):
        ctx.save_for_backward(x, packed)
        ctx.scratch = mlp_v0_scratch(len(x), x.device)
        return mlp_v0_fwd_kernel(x, packed, ctx.scratch)

    @staticmethod
    def backward(ctx, g):
        x, packed = ctx.saved_tensors
        dx, dw = mlp_v0_bwd_kernel(g.contiguous(), x, packed, ctx.scratch)
        del ctx.scratch
        return dx, dw


def mlp_v0_train(mlp, x):
    """The v0 MLP on x (..., 86) -> (..., 4) for training losses, with the
    gradient contract of the module docstring."""
    if x.device.type == "cpu":
        feats = slice(IN_PTS, IN_PTS + IN_FEAT)
        return mlp(torch.cat([x[..., :IN_PTS].detach(), x[..., feats],
                              x[..., feats.stop:].detach()], -1))
    if x.device.type != "cuda":
        raise ValueError(f"mlp_v0_train: no kernel for {x.device}")
    lead = x.shape[:-1]
    out = _MLPv0Train.apply(x.reshape(-1, IN_CH).contiguous(),
                            pack_v0_weights(mlp))
    return out.reshape(*lead, 4)


mlp_v0_train.launches = 0      # forward kernels
mlp_v0_train.bwd_launches = 0  # backward kernels (each with its reduction)
