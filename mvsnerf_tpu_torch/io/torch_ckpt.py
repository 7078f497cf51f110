"""Reference-checkpoint state dicts for the port's modules.

The reference saves `{global_step, network_fn_state_dict,
network_mvs_state_dict[, volume]}`; the module keys here ARE those keys, so
a reference checkpoint loads with `load_state_dict(strict=True)`.

`state_dicts_from_jax` converts the JAX package's channel-last parameter
pytrees (nested dicts/lists of arrays) into the same state dicts, with the
inverse of the JAX importer's transforms (mvsnerf_tpu/io/torch_ckpt.py:
253-330): linear (in, out) -> (out, in); conv2d HWIO -> OIHW; conv3d DHWIO
-> OIDHW; the transposed conv's pre-flipped (k3, I, O) kernel -> (I, O, k3)
with the spatial flip undone. `jax_from_state_dicts` is its inverse: the
port's state dicts (or any tensors keyed like them, such as Adam's moments)
back to the JAX package's pytrees.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mvsnet import MVSNet
from ..models.nerf_mlp import MVSNeRF

_COSTREG_ENC = ("conv0", "conv1", "conv2", "conv3", "conv4", "conv5",
                "conv6")
_COSTREG_DEC = ("conv7", "conv9", "conv11")


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _put_linear(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _put_abn(sd, prefix, bn):
    sd[f"{prefix}.weight"] = _t(bn["scale"])
    sd[f"{prefix}.bias"] = _t(bn["bias"])
    sd[f"{prefix}.running_mean"] = _t(bn["mean"])
    sd[f"{prefix}.running_var"] = _t(bn["var"])
    sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)


# the fusion MLP's heads are Sequentials: their Linear is `<head>.0`
_SEQUENTIAL_HEADS = ("feature_linear", "alpha_linear", "rgb_out")


def _mlp_state_dict(p, net_type):
    """A JAX MLP pytree of `net_type` -> its network_fn state dict."""
    fn_sd = {}
    for i, lin in enumerate(p["pts_linears"]):
        _put_linear(fn_sd, f"nerf.pts_linears.{i}", lin)
    for i, lin in enumerate(p.get("views_linears", [])):
        _put_linear(fn_sd, f"nerf.views_linears.{i}", lin)
    for name in ("pts_bias", "feature_linear", "alpha_linear", "rgb_linear",
                 "weight_out", "rgb_out"):
        if name in p:
            seq = net_type == "fusion" and name in _SEQUENTIAL_HEADS
            _put_linear(fn_sd, f"nerf.{name}.0" if seq else f"nerf.{name}",
                        p[name])
    for attn in ("color_attention", "ray_attention"):
        if attn in p:
            for lin in ("w_qs", "w_ks", "w_vs", "fc"):
                _put_linear(fn_sd, f"nerf.{attn}.{lin}", p[attn][lin])
            ln = p[attn]["layer_norm"]
            fn_sd[f"nerf.{attn}.layer_norm.weight"] = _t(ln["scale"])
            fn_sd[f"nerf.{attn}.layer_norm.bias"] = _t(ln["bias"])
    return fn_sd


def state_dicts_from_jax(mlp_params, mvsnet_params, net_type: str = "v0"):
    """JAX MLP (of `net_type`) + MVSNet pytrees (numpy leaves) ->
    (network_fn state dict, network_mvs state dict) with the reference's
    keys; the second is None without `mvsnet_params`. The attention blocks
    (v1's `color_attention`, fusion's `ray_attention`) and fusion's
    Sequential heads (`*.0`) are written here: JAX's
    `export_reference_checkpoint` writes neither."""
    fn_sd = _mlp_state_dict(mlp_params, net_type)
    if mvsnet_params is None:
        return fn_sd, None

    mvs_sd = {}
    feat = mvsnet_params["feature"]
    for group in ("conv0", "conv1", "conv2"):
        for i, blk in enumerate(feat[group]):
            mvs_sd[f"feature.{group}.{i}.conv.weight"] = _t(
                np.transpose(np.asarray(blk["conv"]["kernel"]), (3, 2, 0, 1)))
            _put_abn(mvs_sd, f"feature.{group}.{i}.bn", blk["bn"])
    top = feat["toplayer"]
    mvs_sd["feature.toplayer.weight"] = _t(
        np.transpose(np.asarray(top["kernel"]), (3, 2, 0, 1)))
    mvs_sd["feature.toplayer.bias"] = _t(top["bias"])

    cr = mvsnet_params["cost_reg_2"]
    for name in _COSTREG_ENC:
        mvs_sd[f"cost_reg_2.{name}.conv.weight"] = _t(
            np.transpose(np.asarray(cr[name]["conv"]["kernel"]),
                         (4, 3, 0, 1, 2)))
        _put_abn(mvs_sd, f"cost_reg_2.{name}.bn", cr[name]["bn"])
    for name in _COSTREG_DEC:
        w = np.transpose(np.asarray(cr[name]["deconv"]["kernel"]),
                         (3, 4, 0, 1, 2))[:, :, ::-1, ::-1, ::-1]
        mvs_sd[f"cost_reg_2.{name}.0.weight"] = _t(w)
        _put_abn(mvs_sd, f"cost_reg_2.{name}.1", cr[name]["bn"])
    return fn_sd, mvs_sd


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(x, np.float32)


def _get_linear(sd, prefix):
    p = {"kernel": _np(sd[f"{prefix}.weight"]).T.copy()}
    if f"{prefix}.bias" in sd:
        p["bias"] = _np(sd[f"{prefix}.bias"])
    return p


def _get_abn(sd, prefix):
    return {"scale": _np(sd[f"{prefix}.weight"]),
            "bias": _np(sd[f"{prefix}.bias"]),
            "mean": _np(sd[f"{prefix}.running_mean"]),
            "var": _np(sd[f"{prefix}.running_var"])}


def _count(sd, prefix):
    """How many `<prefix>.<i>.` entries the state dict holds."""
    n = 0
    while any(k.startswith(f"{prefix}.{n}.") for k in sd):
        n += 1
    return n


def _mlp_tree(sd, net_type):
    """A network_fn state dict of `net_type` -> the JAX MLP pytree."""
    p = {}
    for group in ("pts_linears", "views_linears"):
        n = _count(sd, f"nerf.{group}")
        if n:
            p[group] = [_get_linear(sd, f"nerf.{group}.{i}")
                        for i in range(n)]
    for name in ("pts_bias", "feature_linear", "alpha_linear", "rgb_linear",
                 "weight_out", "rgb_out"):
        seq = net_type == "fusion" and name in _SEQUENTIAL_HEADS
        prefix = f"nerf.{name}.0" if seq else f"nerf.{name}"
        if f"{prefix}.weight" in sd:
            p[name] = _get_linear(sd, prefix)
    for attn in ("color_attention", "ray_attention"):
        if f"nerf.{attn}.fc.weight" in sd:
            p[attn] = {lin: _get_linear(sd, f"nerf.{attn}.{lin}")
                       for lin in ("w_qs", "w_ks", "w_vs", "fc")}
            p[attn]["layer_norm"] = {
                "scale": _np(sd[f"nerf.{attn}.layer_norm.weight"]),
                "bias": _np(sd[f"nerf.{attn}.layer_norm.bias"])}
    return p


def _mvsnet_tree(sd):
    """A network_mvs state dict -> the JAX MVSNet pytree."""
    feat = {}
    for group in ("conv0", "conv1", "conv2"):
        feat[group] = [
            {"conv": {"kernel": np.transpose(_np(
                sd[f"feature.{group}.{i}.conv.weight"]), (2, 3, 1, 0))},
             "bn": _get_abn(sd, f"feature.{group}.{i}.bn")}
            for i in range(_count(sd, f"feature.{group}"))]
    feat["toplayer"] = {
        "kernel": np.transpose(_np(sd["feature.toplayer.weight"]),
                               (2, 3, 1, 0)),
        "bias": _np(sd["feature.toplayer.bias"])}
    cr = {}
    for name in _COSTREG_ENC:
        cr[name] = {"conv": {"kernel": np.transpose(_np(
            sd[f"cost_reg_2.{name}.conv.weight"]), (2, 3, 4, 1, 0))},
            "bn": _get_abn(sd, f"cost_reg_2.{name}.bn")}
    for name in _COSTREG_DEC:
        w = _np(sd[f"cost_reg_2.{name}.0.weight"])[:, :, ::-1, ::-1, ::-1]
        cr[name] = {"deconv": {"kernel": np.transpose(w, (2, 3, 4, 0, 1))},
                    "bn": _get_abn(sd, f"cost_reg_2.{name}.1")}
    return {"feature": feat, "cost_reg_2": cr}


def _c_order(tree):
    """Every array C-contiguous (the transposes above are views)."""
    if isinstance(tree, dict):
        return {k: _c_order(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_c_order(v) for v in tree]
    return np.ascontiguousarray(tree)


def jax_from_state_dicts(fn_sd, mvs_sd=None, net_type: str = "v0"):
    """The inverse of `state_dicts_from_jax`: a network_fn state dict of
    `net_type` (and a network_mvs one) -> the JAX MLP (and MVSNet) pytrees
    with float32 numpy leaves, in init_mlp's / init_mvsnet's structure.
    ABN's running statistics become JAX's `mean` / `var` parameters;
    `num_batches_tracked` has no JAX counterpart. The second is None
    without `mvs_sd`."""
    mlp = _c_order(_mlp_tree(fn_sd, net_type))
    return mlp, (None if mvs_sd is None else _c_order(_mvsnet_tree(mvs_sd)))


def modules_from_state_dicts(fn_sd, mvs_sd, device=None,
                             costreg_impl: str = "auto",
                             net_type: str = "v0", D: int = 6,
                             W: int = 128):
    """Build the MLP of `net_type` at depth D and width W, and MVSNet (its
    U-Net on `costreg_impl`'s route: "auto" takes K10 on a card and cuDNN
    elsewhere, "dband" K10, "plain" cuDNN), on `device` and load
    both state dicts strictly. The type is the caller's, never read from
    the keys: v0 and v2 have the same keys and shapes (JAX
    nerf_mlp.py:184-200)."""
    mlp = MVSNeRF(net_type, D, W, device=device)
    mlp.load_state_dict(fn_sd, strict=True)
    mvsnet = MVSNet(device=device, costreg_impl=costreg_impl)
    mvsnet.load_state_dict(mvs_sd, strict=True)
    return mlp, mvsnet


def volume_from_jax(volume):
    """The JAX fine-tune trainer's `params["volume"]` ((D, h, w, C),
    channel-last, the port's layout too) -> a float32 tensor."""
    return _t(volume)


def volume_from_state(vol_sd):
    """A reference checkpoint's `volume` entry (RefVolume.feat_volume
    (1, C, D, h, w)) -> the (D, h, w, C) channel-last volume."""
    return vol_sd["feat_volume"][0].permute(1, 2, 3, 0).float().contiguous()


def load_reference_checkpoint(path: str, device=None,
                              costreg_impl: str = "auto",
                              net_type: str = "v0", D: int = 6,
                              W: int = 128):
    """torch.load a reference-format checkpoint -> (MVSNeRF, MVSNet,
    volume): both modules loaded with strict=True, the MLP of the caller's
    `net_type` at depth D and width W (`--net_type`, `--netdepth`,
    `--netwidth`), the MVSNet's U-Net on `costreg_impl`'s route (as in
    `modules_from_state_dicts`); the fine-tuned (D, h, w, C) volume when
    the checkpoint holds one, else None."""
    ck = torch.load(path, map_location=device, weights_only=True)
    mlp, mvsnet = modules_from_state_dicts(ck["network_fn_state_dict"],
                                           ck["network_mvs_state_dict"],
                                           device, costreg_impl, net_type,
                                           D, W)
    volume = volume_from_state(ck["volume"]) if ck.get("volume") else None
    return mlp, mvsnet, volume
