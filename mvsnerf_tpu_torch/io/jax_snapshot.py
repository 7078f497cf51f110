"""The JAX package's `.msgpack` snapshots <-> the port trainers' `state()`
dicts (mvsnerf_tpu/io/checkpoint.py:17-59; the trainers' `save` /
`restore`: train/finetune.py:343-364, generalizable.py:329-359,
fusion.py:346-368).

A JAX snapshot is flax's `to_bytes` of `{"params", "opt_state",
"global_step"}` (io/flax_msgpack.py reads and writes it):

- `params`: fine-tune `{mlp, volume[, mvsnet]}` (no MVSNet with
  `--use_color_volume`, whose volume has 8 + 12 channels), generalizable
  `{mlp, mvsnet}`, fusion `{mlp, volume}` with the fused (D, H, W, 20)
  volume; the MLP's tree follows `--net_type`.
- `opt_state`: `optax.adam(schedule)`'s `(ScaleByAdamState(count, mu,
  nu), ScaleByScheduleState(count))`, `mu` and `nu` shaped like
  `params`, the counts int32 scalars.

JAX's `save_checkpoint` passes the tree through `jax.device_get`, so every
dict in it, the top level included, is in sorted key order.

Reading maps `params` through `state_dicts_from_jax` / `volume_from_jax`
and `mu` and `nu` through the same transforms, so each moment lands on
its parameter's layout. The first count is every Adam state's `step`
(a float32 tensor, on the parameter's device when the optimizer is fused
or capturable, else on the CPU, as PyTorch keeps it); the second is the
LambdaLR's `last_epoch`, and each group's lr is the trainer's own schedule
at it. Moments with no slot in the port must be zero, else reading
raises: ABN's `mean` and `var` (JAX parameters with zero gradients in
batch-statistics mode, buffers in the port), and the fine-tune MVSNet
(which never runs in the step, so torch's Adam holds no state for it).
Parts of the port's state that the JAX tree lacks (the MVSNet of the
colour-volume and fusion trainers) are the trainer's current ones. The
density volume is in neither package's snapshot.

Writing is the inverse, atomic as JAX's `save_checkpoint` (a `.tmp` file,
then `os.replace`), and gives the bytes flax writes for JAX's tree.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import flax_msgpack
from .torch_ckpt import jax_from_state_dicts, state_dicts_from_jax, \
    volume_from_jax

KINDS = ("finetune", "generalizable", "fusion")
# ABN buffers: JAX parameters whose moments the port has no slot for
_ABN_STATS = ("running_mean", "running_var")


def _jax_parts(kind, system):
    """The parts of the JAX `params` tree of `kind`, sorted."""
    if kind not in KINDS:
        raise ValueError(f"snapshot kind {kind!r} is not one of {KINDS}")
    if kind == "generalizable":
        return ("mlp", "mvsnet")
    if kind == "finetune" and not system.args.use_color_volume:
        return ("mlp", "mvsnet", "volume")
    return ("mlp", "volume")


def _optimizer_slots(system):
    """(index in the optimizer's state, part, name) of every parameter
    Adam holds, in its order: part is "mlp", "mvsnet" or "volume"."""
    names = {id(p): ("mlp", n) for n, p in system.mlp.named_parameters()}
    names.update({id(p): ("mvsnet", n)
                  for n, p in system.mvsnet.named_parameters()})
    if getattr(system, "volume", None) is not None:
        names[id(system.volume)] = ("volume", None)
    params = [p for g in system.optimizer.param_groups for p in g["params"]]
    return [(i, *names[id(p)]) for i, p in enumerate(params)]


def _lists(tree):
    """flax's maps of lists ("0", "1", ...) back to lists."""
    if isinstance(tree, dict):
        out = {k: _lists(v) for k, v in tree.items()}
        if out and set(out) == {str(i) for i in range(len(out))}:
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree


def _sorted(tree):
    """Every dict in sorted key order (a jitted step's output order)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _port_parts(tree, parts, net_type):
    """A JAX tree of `parts` -> {part: port state dict or volume}."""
    fn_sd, mvs_sd = state_dicts_from_jax(tree["mlp"], tree.get("mvsnet"),
                                         net_type)
    out = {"mlp": fn_sd}
    if "mvsnet" in parts:
        out["mvsnet"] = mvs_sd
    if "volume" in parts:
        out["volume"] = volume_from_jax(tree["volume"])
    return out


def _moment(parts, part, name):
    return parts["volume"] if part == "volume" else parts[part][name]


def read_jax_snapshot(path: str, kind: str, system):
    """The `.msgpack` snapshot at `path`, written by the JAX trainer of
    `kind` ("finetune", "generalizable", "fusion"), as the `state()` dict
    of `system`, the port's trainer it restores into (its modules and
    optimizer give the layout, its schedule the lr, its MVSNet the part
    the JAX tree lacks). Raises ValueError naming the file when it is not
    such a snapshot."""
    try:
        with open(path, "rb") as f:
            tree = _lists(flax_msgpack.from_bytes(f.read()))
        return _state_from_tree(tree, kind, system)
    except (ValueError, KeyError, TypeError) as e:
        raise ValueError(f"{path} is not a JAX {kind} snapshot: "
                         f"{type(e).__name__}: {e}") from e


def _state_from_tree(tree, kind, system):
    parts = _jax_parts(kind, system)
    net_type = system.args.net_type
    if not isinstance(tree, dict) or \
            set(tree) != {"params", "opt_state", "global_step"}:
        raise ValueError("the top level is not {params, opt_state, "
                         "global_step}")
    if set(tree["params"]) != set(parts):
        raise ValueError(f"params {sorted(tree['params'])}, not the {kind} "
                         f"trainer's {list(parts)}")
    device = system.device
    params = _port_parts(tree["params"], parts, net_type)
    mvsnet = params.pop("mvsnet", None)
    if mvsnet is None:
        mvsnet = {k: v.detach().clone()
                  for k, v in system.mvsnet.state_dict().items()}
    port = {"mlp": {k: v.to(device) for k, v in params["mlp"].items()},
            "mvsnet": {k: v.to(device) for k, v in mvsnet.items()}}
    if "volume" in params:
        port["volume"] = params["volume"].to(device)

    template = system.optimizer.state_dict()
    groups = template["param_groups"]
    opt_state, count, last_epoch = {}, 0, 0
    if tree["opt_state"] is not None:
        adam, sched = tree["opt_state"]
        count, last_epoch = int(adam["count"]), int(sched["count"])
        mu = _port_parts(adam["mu"], parts, net_type)
        nu = _port_parts(adam["nu"], parts, net_type)
        for moments in (mu, nu):
            for key, v in moments.get("mvsnet", {}).items():
                if key.endswith(_ABN_STATS) and bool(v.any()):
                    raise ValueError(f"nonzero Adam moment for ABN's {key}: "
                                     f"the port keeps it as a buffer")
        for i, part, name in _optimizer_slots(system):
            m, v = _moment(mu, part, name), _moment(nu, part, name)
            if part == "mvsnet" and kind == "finetune" or count == 0:
                # no gradient reaches it, so torch's Adam holds no state
                if bool(m.any()) or bool(v.any()):
                    raise ValueError(
                        f"nonzero Adam moments for {part} {name} (step "
                        f"{count}), which the port's {kind} trainer never "
                        f"updates")
                continue
            group = next(g for g in groups if i in g["params"])
            on_device = group.get("fused") or group.get("capturable")
            opt_state[i] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=device if on_device else "cpu"),
                "exp_avg": m.to(device), "exp_avg_sq": v.to(device)}

    scheduler = system.scheduler.state_dict()
    lrs = [base * fn(last_epoch) for base, fn in
           zip(scheduler["base_lrs"], system.scheduler.lr_lambdas)]
    groups = [dict(g, lr=lr) for g, lr in zip(groups, lrs)]
    scheduler.update(last_epoch=last_epoch, _step_count=last_epoch + 1,
                     _last_lr=list(lrs))
    return {"params": port,
            "optimizer": {"state": opt_state, "param_groups": groups},
            "scheduler": scheduler,
            "global_step": int(tree["global_step"])}


def jax_tree(state, kind: str, system):
    """The JAX tree (numpy leaves, JAX's key order) of a port `state()`
    dict of `system`, a trainer of `kind`."""
    parts = _jax_parts(kind, system)
    net_type = system.args.net_type

    def tree_of(by_part):
        mlp, mvsnet = jax_from_state_dicts(
            by_part["mlp"], by_part["mvsnet"] if "mvsnet" in parts else None,
            net_type)
        out = {"mlp": mlp}
        if "mvsnet" in parts:
            out["mvsnet"] = mvsnet
        if "volume" in parts:
            out["volume"] = np.ascontiguousarray(
                by_part["volume"].detach().cpu().numpy(), np.float32)
        return _sorted(out)

    params = state["params"]
    opt = state["optimizer"]["state"]
    steps = {float(s["step"]) for s in opt.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam states at different steps {sorted(steps)}: "
                         f"JAX keeps one count")
    count = int(steps.pop()) if steps else 0
    moments = []
    for key in ("exp_avg", "exp_avg_sq"):
        by_part = {"mlp": {}, "mvsnet": {
            k: torch.zeros_like(v) for k, v in params["mvsnet"].items()
            if k.endswith(_ABN_STATS)}}
        for i, part, name in _optimizer_slots(system):
            ref = params[part] if part == "volume" else params[part][name]
            m = opt[i][key] if i in opt else torch.zeros_like(ref)
            if part == "volume":
                by_part["volume"] = m
            else:
                by_part[part][name] = m
        moments.append(tree_of(by_part))
    last_epoch = int(state["scheduler"]["last_epoch"])
    # JAX's save_checkpoint passes the tree through jax.device_get, which
    # sorts the top level's keys too
    return {"global_step": int(state["global_step"]),
            "opt_state": ({"count": np.array(count, np.int32),
                           "mu": moments[0], "nu": moments[1]},
                          {"count": np.array(last_epoch, np.int32)}),
            "params": tree_of(params)}


def write_jax_snapshot(path: str, state, kind: str, system) -> str:
    """Write a port `state()` dict of `system` (a trainer of `kind`) as
    the JAX trainer's snapshot at `path`: the bytes of flax's `to_bytes`
    of JAX's tree, written to `path + ".tmp"` and moved into place with
    `os.replace`. Returns the path."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for piece in flax_msgpack.pieces(jax_tree(state, kind, system)):
            f.write(piece)
    os.replace(tmp, path)
    return path
