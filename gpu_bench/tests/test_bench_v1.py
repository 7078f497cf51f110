"""The `dtu_v1` configuration and its cell `dtu_v1.view` on the CPU: the
cell at toy size takes K11's route (its plain twin here) and agrees with
the plain reference `reference/mvsnerf_v1.py`; faults in the v1 MLP's
attention, planted in the program's timed path, turn it not correct; the
reference's seeded weights load into the program's v1 MLP, its
LayerNorm drawn as a norm; the v1 cost module and K11's roofline reader.

    python -m pytest gpu_bench/tests/test_bench_v1.py -q   (~20 s)
"""

import importlib.util
import os

import pytest
import torch

import toy
from gpu_bench import core, readers
from gpu_bench.costs import bound_s, mlp_v1
from gpu_bench.reference import mvsnerf_v0, mvsnerf_v1
from test_bench_cells import run_toy
from test_bench_trace import CUDA, K8, Ev, Prof

CELL = "dtu_v1.view"
SEED = 2 ** 31 + 977


def _no_residual(monkeypatch):
    """The attention's residual dropped: LayerNorm(fc(o))."""
    from mvsnerf_tpu_torch.models import layers
    orig = layers.MultiHeadAttention.forward

    def forward(self, q, k, v, mask=None):
        _, attn = orig(self, q, k, v, mask)
        B, L, _ = q.shape
        vh = self.w_vs(v).view(B, L, self.n_head, self.d_v).transpose(1, 2)
        out = (attn @ vh).transpose(1, 2).reshape(B, L, -1)
        return self.layer_norm(self.fc(out)), attn

    monkeypatch.setattr(layers.MultiHeadAttention, "forward", forward)


def _sigmoid_after_sum(monkeypatch):
    """The colour as the sigmoid of weight_out summed over the views."""
    from mvsnerf_tpu_torch.models.nerf_mlp import RendererAttention

    def color(self, feats):
        n_views = (feats.shape[-1] - 8) // 4
        tok = torch.cat([feats[..., 8:].reshape(-1, n_views, 4),
                         feats[..., :8].reshape(-1, 1, 8).expand(
                             -1, n_views, 8)], -1)
        out, _ = self.color_attention(tok, tok, tok)
        return torch.sigmoid(self.weight_out(out).sum(-2)).reshape(
            *feats.shape[:-1], 3)

    monkeypatch.setattr(RendererAttention, "_color", color)


def test_the_cell_takes_k11s_route_and_agrees(monkeypatch):
    from mvsnerf_tpu_torch.render import renderer
    calls = {"render_v0_feats": 0, "render_v1_feats": 0}
    for name in calls:
        orig = getattr(renderer, name)

        def counted(*a, _n=name, _o=orig, **kw):
            calls[_n] += 1
            return _o(*a, **kw)
        monkeypatch.setattr(renderer, name, counted)
    res = run_toy(CELL)
    assert res["correct"] is True, res["compared"]
    assert calls["render_v1_feats"] > 0 and calls["render_v0_feats"] == 0


@pytest.mark.parametrize("plant", [_no_residual, _sigmoid_after_sum],
                         ids=["residual_dropped", "sigmoid_after_sum"])
def test_a_fault_in_the_attention_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    res = run_toy(CELL)
    assert res["correct"] is False
    assert res["compared"]["rgb_gap"]["value"] > \
        res["compared"]["rgb_gap"]["limit"]


def test_the_seeded_weights_load_into_the_programs_v1_mlp():
    """The table is the program's v1 state dict, key for key and shape for
    shape; its LayerNorm's scale and shift are drawn as a norm's."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    table = mvsnerf_v1.param_table()
    fn = core.make_weights(table, SEED, "cpu")["network_fn_state_dict"]
    want = {k: tuple(v.shape) for k, v in MVSNeRF("v1").state_dict().items()}
    assert {k: tuple(v.shape) for k, v in fn.items()} == want
    scale = fn["nerf.color_attention.layer_norm.weight"]
    shift = fn["nerf.color_attention.layer_norm.bias"]
    assert ((scale - 1).abs() <= 0.1).all() and (scale - 1).abs().max() > .05
    assert (shift.abs() <= 0.1).all() and shift.abs().max() > 0.05
    assert table["network_mvs_state_dict"] == \
        mvsnerf_v0.param_table()["network_mvs_state_dict"]


def test_the_v1_costs_come_from_the_layer_lists():
    assert mlp_v1.MACS == 116480 and mlp_v1.ATTENTION_MACS == 2700
    assert mlp_v1.FLOPS == 238360
    assert mlp_v1.render_flops(10) == 2383600.0
    # K8's 25 floats a sample read and written, and K11's alpha and
    # folded features
    assert mlp_v1.render_bytes(2, 8) == 4.0 * (16 * 40 + 2 * 8)


K11 = "void (anonymous namespace)::render_v1_kernel(float const*)"


def _metric(name):
    path = os.path.join(toy.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(events, launches):
    return {"trace": core.Trace(Prof(events)), "window_s": 0.1,
            "launches": launches, "stats": {"rendered_rays": 640 * 512},
            "config": {"samples_per_ray": 128}}


def test_k11_roofline_reads_k11_alone_and_none_without_it():
    read = _metric("k11_roofline.view_v1")
    both = [Ev(K8, CUDA, 0, 20), Ev(K11, CUDA, 20, 30), Ev(K11, CUDA, 50, 10)]
    # 4 launches at the traced mean of 20 ms each
    want = 100 * bound_s(mlp_v1.render_flops(640 * 512 * 128),
                         mlp_v1.render_bytes(640 * 512, 128)) / 0.08
    got = read(_ctx(both, {"render_v1_feats.launches": 4, "k8": 1}))
    assert abs(got - want) < 1e-9
    # K8's reading is the same with K11 beside it
    k8 = readers.k8_roofline(_ctx(both, {"k8": 1}))
    assert k8 is not None
    assert k8 == readers.k8_roofline(_ctx(both[:1], {"k8": 1}))
    # K11 never launched: the parent's program, or a counter at 0
    for launches in ({}, {"render_v1_feats.launches": 0, "k8": 1}):
        assert read(_ctx(both, launches)) is None
    assert read(_ctx(both[:1], {"render_v1_feats.launches": 4})) is None
    assert read(dict(_ctx(both, {"render_v1_feats.launches": 4}),
                     trace=None)) is None
