"""The kernels that importance sampling (`--N_importance`) feeds new
shapes: K5's splat on sorted, unevenly spaced samples (several in one
z-cell of the volume, where its merge rule takes no merge), and the render
body's K6b and K8 at S = N_samples + N_importance > 128, where a block
walks 128-row tiles of one ray and carries its transmittance between them.

The samples are `ray_marcher_fine`'s: coarse depths over the volume, then
inverse-CDF draws from a density volume of a few bumps, sorted in.

On the CPU: the emulated splat (tests/test_torch_volume_splat_merge.py's
emulation of the kernel's adds under `splat_merges`) against the plain twin
within TOL_K5 x (1 + max|twin|), at C = 8 and C = 20, on rays that put
several samples in one z-cell.

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest; this file imports no JAX):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_density_tc.py

K5's splat against its twin and a float64 run of the twin, its add
counters against `splat_merges`, at the fine-tune step's 1024 rays x (128 +
64) samples; K6b and K8 on one full 16384-ray chunk at S = 192 and 256
against their twins and a float64 twin (chip_smoke.py's TOL_K6).
"""

import numpy as np
import pytest
import torch

from test_torch_volume_splat_merge import TOL_ATOMIC, TOL_K5, _emulate_splat

TOL_K6 = 1e-4


def _importance_ndc(n_rays, n_samples, n_imp, seed, device="cpu"):
    """(N, n_samples + n_imp, 3) NDC of rays nearly along z through the
    unit cube: n_samples stratified coarse depths over [-0.02, 1.02], then
    n_imp `ray_marcher_fine` draws from a (64, 24, 24, 1) density of a few
    narrow bumps, so the draws crowd into a few z-cells."""
    from mvsnerf_tpu_torch.ops.sampling import ray_marcher_fine, \
        stratified_z_vals
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    o = np.concatenate([rng.uniform(0.02, 0.98, (n_rays, 2)),
                        np.full((n_rays, 1), -0.02)], -1)
    d = np.concatenate([rng.normal(0, 0.02, (n_rays, 2)),
                        np.ones((n_rays, 1))], -1)
    rays = torch.tensor(np.concatenate(
        [o, d, np.zeros((n_rays, 1)), np.full((n_rays, 1), 1.04)], -1),
        dtype=torch.float32, device=device)
    z = stratified_z_vals(rays[:, 6:7], rays[:, 7:8], n_rays, n_samples,
                          perturb=1.0, generator=gen)
    pts = rays[:, None, :3] + rays[:, None, 3:6] * z[..., None]
    zz = torch.linspace(0, 1, 64, device=device)[:, None, None, None]
    density = sum(40.0 * torch.exp(-((zz - c) / 0.01) ** 2)
                  for c in (0.3, 0.55, 0.8)).expand(64, 24, 24, 1)
    xyz = ray_marcher_fine(rays, density.contiguous(), z, pts, n_imp,
                           generator=gen)[0]
    return xyz.contiguous()


def _shared_z_cells(ndc, depth):
    """Consecutive samples of a ray in one z-cell of a `depth`-plane
    volume."""
    cell = (ndc[..., 2] * (depth - 1)).floor()
    return int((cell[:, 1:] == cell[:, :-1]).sum())


@pytest.mark.parametrize("channels", [8, 20])
def test_emulated_splat_on_importance_samples_meets_tol_k5(channels):
    from mvsnerf_tpu_torch.ops import volume_gather as vg
    shape = (64, 20, 22, channels)
    ndc = _importance_ndc(24, 32, 16, seed=channels)
    rng = np.random.default_rng(channels)
    g = torch.tensor(rng.standard_normal((*ndc.shape[:2], channels)),
                     dtype=torch.float32)
    volume = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    got, (n_add, n_merged) = _emulate_splat(g, ndc, shape)
    twin = vg.volume_splat_plain(g, ndc, volume)
    assert float((got - twin).abs().max()) <= \
        TOL_K5 * (1 + float(twin.abs().max()))
    # the rays put several samples in one z-cell and still merge elsewhere
    assert _shared_z_cells(ndc, shape[0]) > 50
    assert n_add > n_merged > 0


def test_importance_samples_are_sorted_and_crowd_the_bumps():
    ndc = _importance_ndc(16, 32, 16, seed=1)
    z = ndc[..., 2]
    assert ndc.shape == (16, 48, 3) and bool((z.diff(dim=-1) >= 0).all())
    near_bump = sum(((z - c).abs() < 0.03) for c in (0.3, 0.55, 0.8))
    # 16 draws a ray, most of them at the bumps (6 % of the depth range)
    assert float(near_bump.float().sum(-1).mean()) > 16


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_density_tc.py`")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [8, 20])
def test_splat_counters_on_importance_samples_on_the_card(card, channels):
    from mvsnerf_tpu_torch.ops import volume_gather as vg
    shape = (128, 176, 208, channels)
    ndc = _importance_ndc(1024, 128, 64, seed=channels, device=card)
    gen = torch.Generator(device=card).manual_seed(channels)
    g = torch.randn(*ndc.shape[:2], channels, generator=gen, device=card)
    volume = torch.randn(shape, generator=gen, device=card)
    adds = torch.zeros(2, dtype=torch.int64, device=card)
    got = vg.volume_splat_kernel(g, ndc, shape, adds=adds)
    torch.cuda.synchronize()
    twin = vg.volume_splat_plain(g, ndc, volume)
    assert float((got - twin).abs().max()) <= \
        TOL_K5 * (1 + float(twin.abs().max()))
    ref = vg.volume_splat_plain(g.double(), ndc.double(), volume.double())
    own = max(float((twin.double() - ref).abs().max()),
              1e-6 * float(ref.abs().max()))
    assert float((got.double() - ref).abs().max()) <= TOL_ATOMIC * own
    assert tuple(adds.tolist()) == vg.splat_merges(ndc, shape)[1]
    assert _shared_z_cells(ndc, shape[0]) > 0 and int(adds[1]) > 0


def _mlp(device, dtype=torch.float32):
    """Seeded v0 weights, the alpha head scaled by 0.2 so that a ray of
    192 or 256 samples stays short of opaque and every tile counts."""
    from mvsnerf_tpu_torch.models.nerf_mlp import MVSNeRF
    gen = torch.Generator().manual_seed(5)
    mlp = MVSNeRF()
    with torch.no_grad():
        for p in mlp.parameters():
            b = 1.0 / np.sqrt(p.shape[-1]) if p.dim() > 1 else 0.05
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * b)
        for p in mlp.nerf.alpha_linear.parameters():
            p.mul_(0.2)
    return mlp.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [192, 256])
@pytest.mark.parametrize("form", ["K6b", "K8"])
def test_render_body_at_importance_sample_counts_on_the_card(card, form, s):
    from mvsnerf_tpu_torch.ops import render_fused as rf
    from mvsnerf_tpu_torch.ops.interp import index_point_feature
    n = 16384  # 128 + 64 samples (phase 11's) and 192 + 64
    ndc = _importance_ndc(n, s - 64, 64, seed=s, device=card)
    gen = torch.Generator(device=card).manual_seed(s)
    z = (2.0 + 3.0 * ndc[..., 2]).contiguous()
    dirs = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=gen, device=card), dim=-1)
    vol = torch.randn(64, 44, 52, 20, generator=gen, device=card) * 0.5
    mlp, m64 = _mlp(card), _mlp(card, torch.float64)
    with torch.no_grad():
        if form == "K8":
            feats = index_point_feature(vol, ndc).contiguous()
            args = (ndc, feats, dirs, z)
            before = rf.render_v0_feats.launches
            k = rf.render_v0_feats(*args, mlp)
            counted = rf.render_v0_feats.launches - before
            twin = rf.render_v0_feats_plain(*args, mlp)
            ref = rf.render_v0_feats_plain(*(a.double() for a in args), m64)
        else:
            args = (ndc, z, None, dirs, vol)
            before = rf.render_v0.baked_launches
            k = rf.render_v0(*args, mlp)
            counted = rf.render_v0.baked_launches - before
            twin = rf.render_v0_plain(*args, mlp)
            ref = rf.render_v0_plain(ndc.double(), z.double(), None,
                                     dirs.double(), vol.double(), m64)
        torch.cuda.synchronize()
    assert counted == 1
    for key in ("rgb", "depth", "acc"):
        assert float((k[key] - twin[key]).abs().max()) <= TOL_K6, key
        assert float((k[key].double() - ref[key]).abs().max()) <= TOL_K6, key
    assert 0.05 < float(twin["acc"].mean()) < 0.999
