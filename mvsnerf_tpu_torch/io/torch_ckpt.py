"""Reference-checkpoint state dicts for the port's modules.

The reference saves `{global_step, network_fn_state_dict,
network_mvs_state_dict[, volume]}`; the module keys here ARE those keys, so
a reference checkpoint loads with `load_state_dict(strict=True)`.

`state_dicts_from_jax` converts the JAX package's channel-last parameter
pytrees (nested dicts/lists of arrays) into the same state dicts, with the
inverse of the JAX importer's transforms (mvsnerf_tpu/io/torch_ckpt.py:
253-330): linear (in, out) -> (out, in); conv2d HWIO -> OIHW; conv3d DHWIO
-> OIDHW; the transposed conv's pre-flipped (k3, I, O) kernel -> (I, O, k3)
with the spatial flip undone.
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


def state_dicts_from_jax(mlp_params, mvsnet_params):
    """JAX v0 MLP + MVSNet pytrees (numpy leaves) -> (network_fn state
    dict, network_mvs state dict) with the reference's keys."""
    fn_sd = {}
    for i, lin in enumerate(mlp_params["pts_linears"]):
        _put_linear(fn_sd, f"nerf.pts_linears.{i}", lin)
    for i, lin in enumerate(mlp_params["views_linears"]):
        _put_linear(fn_sd, f"nerf.views_linears.{i}", lin)
    for name in ("pts_bias", "feature_linear", "alpha_linear", "rgb_linear"):
        _put_linear(fn_sd, f"nerf.{name}", mlp_params[name])

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


def modules_from_state_dicts(fn_sd, mvs_sd, device=None):
    """Build the v0 MLP and MVSNet on `device` and load both state dicts
    strictly."""
    mlp = MVSNeRF(device=device)
    mlp.load_state_dict(fn_sd, strict=True)
    mvsnet = MVSNet(device=device)
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


def load_reference_checkpoint(path: str, device=None):
    """torch.load a reference-format checkpoint -> (MVSNeRF, MVSNet,
    volume): both modules loaded with strict=True; the fine-tuned (D, h, w,
    C) volume when the checkpoint holds one, else None."""
    ck = torch.load(path, map_location=device, weights_only=True)
    mlp, mvsnet = modules_from_state_dicts(ck["network_fn_state_dict"],
                                           ck["network_mvs_state_dict"],
                                           device)
    volume = volume_from_state(ck["volume"]) if ck.get("volume") else None
    return mlp, mvsnet, volume
