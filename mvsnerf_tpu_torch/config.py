"""Flags with the reference's public surface (opt.py:3-96), counterpart of
mvsnerf_tpu/config.py, on plain argparse.

`--config FILE` holds `key = value` lines applied as defaults before the
command line. The JAX package's TPU-only implementation switches are
parsed, so the same command lines work, and do nothing here: the port has
one implementation of each path. Setting one prints a line saying so.
`--costreg_impl` is the exception: `auto`, the default, runs the
CostRegNet U-Net's convolutions on the hand-written K10 kernels
(ops/costreg_conv.py) on a CUDA card and on cuDNN elsewhere,
`dband` always on K10, `plain` always on cuDNN (`packed`, a TPU layout,
runs on cuDNN and prints a line saying so).
`--device` is the port's own: the CLIs run on the CUDA card unless it says
`cpu`, and raise when there is no card.
"""

from __future__ import annotations

import argparse
import shlex

# TPU-only switches of the JAX package: flag -> default
TPU_ONLY = {
    "warp_mode": "auto", "featurenet_impl": "auto",
    "color_warp_mode": "auto", "volume_gather_impl": "auto",
    "eval_gather": "auto", "mlp_impl": "auto", "precision": "float32",
}


def _read_config_file(path: str) -> dict:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = (s.strip() for s in line.split("=", 1))
            out[k] = v
    return out


def config_parser(cmd=None):
    """Parse flags. `cmd` may be a string or an argv list (unknown flags
    are then ignored); None reads sys.argv."""
    parser = argparse.ArgumentParser()
    add = parser.add_argument
    add("--config", type=str, default=None, help="config file path")
    add("--expname", type=str, help="experiment name")
    add("--basedir", type=str, default="./logs/")
    add("--datadir", type=str, default="./data/llff/fern")
    add("--with_depth", action="store_true")
    add("--with_depth_loss", action="store_true")
    add("--with_rgb_loss", action="store_true")
    add("--imgScale_train", type=float, default=1.0)
    add("--imgScale_test", type=float, default=1.0)
    add("--img_downscale", type=float, default=1.0)
    add("--pad", type=int, default=24)
    add("--render_mode", type=str, default="chunked",
        choices=["chunked", "tiled", "hybrid"])
    add("--fixed_sources", action="store_true")
    add("--lpips_weights", type=str, default="lpips_vgg.npz")

    # TPU-only implementation switches: parsed, ignored (but for
    # --costreg_impl)
    add("--warp_mode", type=str, default="auto",
        choices=["auto", "pallas", "packed", "banded", "gather"])
    add("--costreg_impl", type=str, default="auto",
        choices=["auto", "packed", "plain", "dband"],
        help="CostRegNet convolutions: 'auto' = the hand-written K10 "
             "kernels (ops/costreg_conv.py) on a CUDA card, "
             "cuDNN elsewhere; 'dband' = always K10; 'plain' and 'packed' "
             "= cuDNN ('packed' is a TPU layout of the JAX package)")
    add("--featurenet_impl", type=str, default="auto",
        choices=["auto", "packed", "plain"])
    add("--color_warp_mode", type=str, default="auto",
        choices=["auto", "gather", "pallas"])
    add("--volume_gather_impl", type=str, default="auto",
        choices=["auto", "banded", "pallas", "pallas_bf16", "pallas2"])
    add("--eval_gather", type=str, default="auto",
        choices=["auto", "exact", "fast"])
    add("--mlp_impl", type=str, default="auto",
        choices=["auto", "xla", "pallas", "pallas_high"])
    add("--precision", type=str, default="float32",
        choices=["float32", "bfloat16"])

    # loader options
    add("--batch_size", type=int, default=1024)
    add("--num_epochs", type=int, default=8)
    add("--pts_dim", type=int, default=3)
    add("--dir_dim", type=int, default=3)
    add("--alpha_feat_dim", type=int, default=8)
    add("--net_type", type=str, default="v0")
    add("--dataset_name", type=str, default="blender",
        choices=["dtu", "blender", "llff", "dtu_ft"])
    add("--use_color_volume", default=False, action="store_true")
    add("--use_density_volume", default=False, action="store_true")

    # training options
    add("--netdepth", type=int, default=6)
    add("--netwidth", type=int, default=128)
    add("--netdepth_fine", type=int, default=6)
    add("--netwidth_fine", type=int, default=128)
    add("--lrate", type=float, default=5e-4)
    add("--decay_step", nargs="+", type=int, default=[5000, 8000, 9000])
    add("--decay_gamma", type=float, default=0.5)
    add("--lr_scheduler", type=str, default="steplr",
        choices=["steplr", "cosine", "poly"])
    add("--warmup_epochs", type=int, default=0)
    add("--chunk", type=int, default=1024)
    add("--netchunk", type=int, default=1024)
    add("--ckpt", type=str, default=None)

    # rendering options
    add("--N_samples", type=int, default=128)
    add("--N_importance", type=int, default=0)
    add("--use_disp", default=False, action="store_true")
    add("--perturb", type=float, default=1.0)
    add("--use_viewdirs", action="store_true")
    add("--i_embed", type=int, default=0)
    add("--multires", type=int, default=10)
    add("--multires_views", type=int, default=4)
    add("--raw_noise_std", type=float, default=0.0)
    add("--white_bkgd", action="store_true")
    add("--N_vis", type=int, default=20)

    # additions of the JAX package
    add("--num_devices", type=int, default=0)
    add("--max_steps", type=int, default=0,
        help="cap training steps (0 = schedule default)")
    add("--ckpt_every", type=int, default=20000)
    add("--val_every", type=int, default=0)
    add("--scan_list", type=str, default="")

    # the port's own
    add("--device", type=str, default="cuda",
        help="cuda (default; raises without a card) or cpu")

    if isinstance(cmd, str):
        cmd = shlex.split(cmd)
    args = parser.parse_known_args(cmd)[0] if cmd is not None else \
        parser.parse_args()

    if args.config:
        known = {a.dest: a for a in parser._actions}
        for k, v in _read_config_file(args.config).items():
            if k in known and getattr(args, k) == known[k].default:
                action = known[k]
                if isinstance(action, argparse._StoreTrueAction):
                    setattr(args, k, v.lower() in ("1", "true", "yes"))
                elif action.nargs in ("+", "*"):
                    setattr(args, k, [action.type(x) for x in v.split()])
                elif action.type is not None:
                    setattr(args, k, action.type(v))
                else:
                    setattr(args, k, v)
    for flag, default in TPU_ONLY.items():
        if getattr(args, flag) != default:
            print(f"--{flag} {getattr(args, flag)}: a TPU-only switch of "
                  f"the JAX package; the port ignores it")
    if args.costreg_impl == "packed":
        print("--costreg_impl packed: a TPU layout of the JAX package; the "
              "port runs the U-Net on cuDNN")
    return args
