"""The fusion trainer's two new roles for the port's kernels: K8 handing
back each sample's alpha beside its weight (the local renders), and K5's
splat as the scatter-add of the fuse, with the rows of the samples JAX's
splat drops zeroed first, at 24 channels a sample.

On the CPU: the masked route (K5's twin, `volume_splat_plain`, added to
the accumulator) against the `index_add_` twin `splat_trilinear_plain` on
rays through the box, within TOL_K5 x (1 + max|twin|); K8's twin with
alpha against `raw2outputs` of the module's MLP, exactly.

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest; this file imports no JAX):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_fusion_tc.py

K8 with alpha on a 16384-ray chunk of 128 samples against its twin at
TOL_K6 (chip_smoke.py's), and without alpha bit-identical to with it; the
masked splat at one local view's full size (20480 rays x 128 samples x 24
channels into (128, 128, 128, 24)) against the twin within TOL_K5 x (1 +
max|twin|) per channel (its float32 atomics add in an order that changes
from run to run), with its counters against `splat_merges`.
"""

import pytest
import torch

TOL_K5, TOL_K6 = 1e-5, 1e-4
BOX = ((-1.0, -1.0, 2.2), (1.0, 1.0, 4.2))   # the DTU box of dtu_ft


def _box_samples(n_rays, n_samples, seed, device="cpu"):
    """(N, S, 3) box coordinates of rays from the origin's neighbourhood
    through the box, 128 samples over [2.125, 4.525] (the DTU near and far,
    so the first and last samples lie outside the box)."""
    from mvsnerf_tpu_torch.ops.geometry import get_ndc_coordinate_bbox
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher
    gen = torch.Generator().manual_seed(seed)
    o = (torch.rand(n_rays, 3, generator=gen) - 0.5) * 0.2
    d = torch.cat([(torch.rand(n_rays, 2, generator=gen) - 0.5) * 0.7,
                   torch.ones(n_rays, 1)], -1)
    rays = torch.cat([o, d, torch.full((n_rays, 1), 2.125),
                      torch.full((n_rays, 1), 4.525)], -1).to(device)
    pts = ray_marcher(rays, n_samples)[0]
    box = torch.tensor(BOX, device=device)
    return get_ndc_coordinate_bbox(box[0], box[1], pts).contiguous()


def _cotangent(ndc, seed, channels=24):
    """Values a sample: random features and alpha, the weight's 1, 0, 0."""
    gen = torch.Generator().manual_seed(seed)
    vals = torch.randn((*ndc.shape[:2], channels), generator=gen)
    vals[..., 21] = 1.0
    vals[..., 22:] = 0.0
    return vals.to(ndc.device)


def test_masked_splat_route_matches_the_index_add_twin():
    from mvsnerf_tpu_torch.ops.volume_gather import volume_splat_plain
    from mvsnerf_tpu_torch.train.fusion import splat_keep, \
        splat_trilinear_plain
    ndc = _box_samples(96, 128, 0)
    vals = _cotangent(ndc, 1)
    keep = splat_keep(ndc, (24, 20, 16))
    assert 0.5 < float(keep.float().mean()) < 1.0  # some samples drop
    twin = splat_trilinear_plain(torch.zeros(24, 20, 16, 24), ndc, vals)
    acc = torch.zeros(24, 20, 16, 24)
    route = acc + volume_splat_plain(vals * keep[..., None], ndc, acc)
    err = (route - twin).abs().max()
    assert err <= TOL_K5 * (1 + twin.abs().max()), err
    # the weight channel counts the kept samples, the padding stays 0
    assert abs(float(twin[..., 21].sum()) - int(keep.sum())) < 1e-2
    assert not twin[..., 22:].any()


def test_k8_twin_alpha_is_raw2outputs_alpha():
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops.compositing import raw2outputs
    from mvsnerf_tpu_torch.ops.encoding import positional_encoding
    from mvsnerf_tpu_torch.ops.render_fused import render_v0_feats
    torch.manual_seed(0)
    mlp = MVSNeRF()
    ndc = torch.rand(32, 16, 3)
    feats, dirs = torch.randn(32, 16, 20), torch.randn(32, 3)
    z = torch.linspace(2.0, 4.0, 16).expand(32, 16).contiguous()
    with torch.no_grad():
        out = render_v0_feats(ndc, feats, dirs, z, mlp, with_alpha=True)
        bare = render_v0_feats(ndc, feats, dirs, z, mlp)
        x = torch.cat([positional_encoding(ndc, 10), feats,
                       dirs[:, None].expand(-1, 16, -1)], -1)
        ref = raw2outputs(mlp(x), z)
    assert "alpha" not in bare
    assert torch.equal(out["alpha"], ref["alpha"])
    assert 0.05 < float((out["alpha"] > 0.01).float().mean()) < 1.0
    for k in bare:
        assert torch.equal(out[k], bare[k]), k


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_fusion_tc.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_k8_alpha_matches_twin_on_a_chunk(dev):
    from mvsnerf_tpu_torch import set_precision_policy
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    from mvsnerf_tpu_torch.ops import render_fused as rf
    set_precision_policy()
    torch.manual_seed(0)
    mlp = MVSNeRF(device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    n, s = 16384, 128
    ndc = torch.rand((n, s, 3), device=dev, generator=gen)
    feats = torch.randn((n, s, 20), device=dev, generator=gen)
    dirs = torch.randn((n, 3), device=dev, generator=gen)
    z = torch.linspace(2.125, 4.525, s, device=dev).expand(n, s).contiguous()
    with torch.no_grad():
        before = rf.render_v0_feats.launches
        out = rf.render_v0_feats(ndc, feats, dirs, z, mlp, with_alpha=True)
        bare = rf.render_v0_feats(ndc, feats, dirs, z, mlp)
        twin = rf.render_v0_feats_plain(ndc, feats, dirs, z, mlp, True)
        torch.cuda.synchronize()
    assert rf.render_v0_feats.launches == before + 2
    for k in ("rgb", "depth", "acc", "weights", "alpha"):
        err = float((out[k] - twin[k]).abs().max())
        assert err <= TOL_K6, (k, err)
    for k in bare:
        assert torch.equal(out[k], bare[k]), k
    assert 0.05 < float((out["alpha"] > 0.01).float().mean()) < 1.0


@pytest.mark.cuda
def test_masked_k5_splat_matches_twin_at_one_view(dev):
    from mvsnerf_tpu_torch.ops import volume_gather as k5
    from mvsnerf_tpu_torch.train.fusion import splat_keep, splat_trilinear, \
        splat_trilinear_plain
    ndc = _box_samples(20480, 128, 2, dev)
    vals = _cotangent(ndc, 3)
    shape = (128, 128, 128, 24)
    before = splat_trilinear.launches
    acc = splat_trilinear(torch.zeros(shape, device=dev), ndc, vals)
    twin = splat_trilinear_plain(torch.zeros(shape, device=dev), ndc, vals)
    torch.cuda.synchronize()
    assert splat_trilinear.launches == before + 1
    scale = 1 + twin.abs().amax(dim=(0, 1, 2))
    err = (acc - twin).abs().amax(dim=(0, 1, 2))
    assert (err <= TOL_K5 * scale).all(), (err / scale).max()
    # its adds: K5's rule on the masked cotangent
    g = (vals * splat_keep(ndc, shape)[..., None]).contiguous()
    adds = torch.zeros(2, dtype=torch.int64, device=dev)
    k5.volume_splat_kernel(g, ndc, shape, adds=adds)
    assert tuple(adds.tolist()) == k5.splat_merges(ndc, shape)[1]
