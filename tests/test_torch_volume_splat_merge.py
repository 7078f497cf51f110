"""K5's backward, the splat of the (N, S, C) cotangent into the dense
volume gradient, as csrc/volume_gather.cu `splat_kernel` computes it: one
thread per (sample, 4 channels), one 16-byte add a corner, and a sample's
upper 4 corners merged into the next sample's lower 4 (the thread CG lanes
on in its warp) where both have the same x and y taps and z taps one plane
apart (`splat_merges`, ops/volume_gather.py, is the rule).

On the CPU: a torch emulation of the kernel's adds under that rule (each
thread's corner adds, the merged ones carried into the next sample's
atomic), held to the plain twin `volume_splat_plain` within TOL_K5 x
(1 + max|twin|) (chip_smoke.py's rule for K5: the atomics add in another
order than the twin) and to `jax.grad` of JAX's `index_point_feature` and
of JAX's K9 in interpret mode (the volume gradients
tests/test_torch_volume_gather.py compares against), at C = 8 and C = 20,
on rays that leave the volume, samples on its faces and a ray whose z step
skips a plane; and the rule's counts on such rays.

On a card (tests/conftest.py imports JAX, which the card's machine does
not have, hence --noconftest; this file imports JAX only inside the CPU
tests that call it):

    python -m pytest -m cuda --noconftest -p no:cacheprovider \\
        tests/test_torch_volume_splat_merge.py

the kernel against its twin (TOL_K5) and a float64 run of the twin (at
most 5 x the float32 twin's own distance, chip_smoke.py's TOL_K7_BWD rule
for atomic sums) at C = 8 and C = 20, and its add counters against
`splat_merges`.
"""

import numpy as np
import pytest
import torch

TOL_K5 = 1e-5
# chip_smoke.py's TOL_K7_BWD: an atomic sum against a float64 run of the
# twin, at most this many times the float32 twin's own distance
TOL_ATOMIC = 5.0


def _vg():
    from mvsnerf_tpu_torch.ops import volume_gather
    return volume_gather


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _emulate_splat(g, ndc, volume_shape):
    """The splat as the kernel adds it, on the CPU: every thread's in-volume
    corners, its upper ones left to the next sample's thread where the rule
    merges them and added there together with that thread's lower ones.
    Returns the (D, hp, wp, C) gradient and the adds (to device memory,
    merged)."""
    vg = _vg()
    D, hp, wp, C = volume_shape
    cg = C // 4
    take, counts = vg.splat_merges(ndc, volume_shape)
    p = ndc.reshape(-1, 3)
    gs = g.reshape(-1, cg, 4)
    size = torch.tensor([wp, hp, D])
    ix = (p * 2.0 - 1.0 + 1.0) / 2.0 * (size - 1)
    on = ((ix > -1) & (ix < size)).all(-1)
    base = ix.floor()
    wts = [base + 1 - ix, ix - base]                 # per axis: corner 0, 1
    give = torch.zeros_like(take)
    give[:-1] = take[1:]
    out = torch.zeros(D * hp * wp, cg, 4)
    n_add = n_merged = 0
    for k in range(8):
        dx, dy, dz = k & 1, k >> 1 & 1, k >> 2
        cell = base.long() + torch.tensor([dx, dy, dz])
        ok = on & ((cell >= 0) & (cell < size)).all(-1)
        w = wts[dx][:, 0] * wts[dy][:, 1] * wts[dz][:, 2]
        v = w[:, None, None] * gs                    # (N * S, CG, 4)
        send = ok[:, None] & (give if dz else torch.zeros_like(give))
        if dz == 0:                    # the previous sample's upper corner
            up = torch.zeros_like(v)
            wu = wts[dx][:, 0] * wts[dy][:, 1] * wts[1][:, 2]
            up[1:] = wu[:-1, None, None] * gs[:-1]
            v = v + up * take[..., None]
        add = ok[:, None] & ~send
        n_add += int(add.sum())
        n_merged += int(send.sum())
        flat = (cell[:, 2] * hp + cell[:, 1]) * wp + cell[:, 0]
        for j in range(cg):
            out[:, j].index_add_(0, flat[add[:, j]], v[add[:, j], j])
    assert (n_add, n_merged) == counts
    return out.reshape(D, hp, wp, C), counts


def _rays(seed, n_rays, n_samples, skip=False, faces=False):
    """(N, S, 3) NDC of rays as the fine-tune step samples them: x and y
    nearly constant along a ray (a small drift), z stratified with jitter
    over [-0.05, 1.05], so each sample steps about one plane and some lie
    outside the volume. `skip`: the last ray's z steps ~2.4 planes a sample
    at D = 16, so no merge is possible there; `faces`: a ray on the x = 0
    face, one on the y = 1 face, one with samples at z = 0 and z = 1."""
    rng = np.random.default_rng(seed)
    edges = np.linspace(-0.05, 1.05, n_samples + 1)
    z = edges[:-1] + (edges[1:] - edges[:-1]) * rng.uniform(
        size=(n_rays, n_samples))
    xy = rng.uniform(-0.1, 1.1, (n_rays, 1, 2)) + np.cumsum(
        rng.normal(0, 2e-3, (n_rays, n_samples, 2)), 1)
    ndc = np.concatenate([np.broadcast_to(xy, (n_rays, n_samples, 2)),
                          z[..., None]], -1).astype(np.float32)
    if skip:
        ndc[-1, :, 2] = np.arange(n_samples) * 0.16
    if faces:
        ndc[0, :, 0] = 0.0
        ndc[1, :, 1] = 1.0
        ndc[2, ::2, 2] = 0.0
        ndc[2, 1::2, 2] = 1.0
    return ndc


# name -> (volume shape, rays, samples, keywords)
CASES = {"c8": ((16, 12, 14, 8), 12, 16, dict(faces=True)),
         "c20": ((16, 12, 14, 20), 10, 16, dict(faces=True)),
         "c8_skip": ((16, 10, 9, 8), 6, 7, dict(skip=True)),
         "c20_skip": ((16, 10, 9, 20), 6, 7, dict(skip=True))}


def _case(name, seed=0):
    shape, n, s, kw = CASES[name]
    rng = np.random.default_rng(seed + 1)
    ndc = _rays(seed, n, s, **kw)
    g = rng.standard_normal((n, s, shape[-1])).astype(np.float32)
    volume = rng.standard_normal(shape).astype(np.float32)
    return volume, ndc, g


@pytest.mark.parametrize("name", list(CASES))
def test_emulated_splat_meets_tol_k5_against_the_twin(name):
    volume, ndc, g = _case(name)
    got, (n_add, n_merged) = _emulate_splat(t(g), t(ndc), volume.shape)
    twin = _vg().volume_splat_plain(t(g), t(ndc), t(volume))
    tol = TOL_K5 * (1 + float(twin.abs().max()))
    assert float((got - twin).abs().max()) <= tol
    # some corners lie outside, some merge, most are added directly
    assert n_add > n_merged > 0
    assert int(torch.count_nonzero(twin)) < twin.numel()


def test_merge_rule_on_rays_that_skip_planes_and_leave_the_volume():
    """No merge across a skipped plane, nor into or out of a sample with no
    corner in the volume, nor across a warp; merges of a sample's upper
    corners that lie outside are not counted."""
    vg = _vg()
    shape = (16, 10, 9, 8)
    ndc = t(_rays(0, 6, 7, skip=True))
    take, (n_add, n_merged) = vg.splat_merges(ndc, shape)
    cg = shape[-1] // 4
    s = ndc.reshape(-1, 3)
    ix = (s * 2.0 - 1.0 + 1.0) / 2.0 * (torch.tensor(shape[2::-1]) - 1)
    on = ((ix > -1) & (ix < torch.tensor(shape[2::-1]))).all(-1)
    # the skipping ray (the last 7 samples) merges nothing
    assert not take[-7:].any()
    # a taker and the sample before it both have corners in the volume
    rows = torch.nonzero(take.any(-1))[:, 0]
    assert len(rows) and bool(on[rows].all()) and bool(on[rows - 1].all())
    # a thread takes only from a lane of its own warp
    lane = (torch.arange(len(s))[:, None] * cg + torch.arange(cg)) % 32
    assert not take[lane < cg].any()
    # the counts: every in-volume corner of every thread, once
    z0 = ix[:, 2].floor()
    upper_in = on & (z0 + 1 < shape[0]) & (z0 + 1 >= 0)
    assert n_merged <= 4 * int(take.sum()) and n_merged > 0
    assert n_add + n_merged <= 8 * int(on.sum()) * cg
    assert bool(upper_in[rows - 1].any())


@pytest.mark.parametrize("name", ["c8", "c20"])
def test_emulated_splat_matches_jax(name):
    """The emulated splat against the volume gradient of JAX's
    `index_point_feature` under `jax.grad`, within the tolerance of
    tests/test_torch_volume_gather.py (abs <= 1e-4 x (1 + max|g|))."""
    import jax
    import jax.numpy as jnp
    from mvsnerf_tpu.ops.interp import index_point_feature
    volume, ndc, g = _case(name, seed=3)
    got, _ = _emulate_splat(t(g), t(ndc), volume.shape)
    ref = np.asarray(jax.grad(lambda v: jnp.sum(
        index_point_feature(v, jnp.asarray(ndc)) * g))(jnp.asarray(volume)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


def test_emulated_splat_matches_jax_k9_kernel():
    """Against JAX's K9 (`sample_volume_pallas`, run in interpret mode as
    tests/test_torch_volume_gather.py runs it) on its stratified rays, at
    C = 8."""
    import jax
    import jax.numpy as jnp
    from mvsnerf_tpu.ops.pallas_volgather import sample_volume_pallas
    rng = np.random.default_rng(11)
    volume = rng.standard_normal((16, 12, 14, 8)).astype(np.float32)
    edges = np.linspace(0, 1, 17)
    z = edges[:-1] + (edges[1:] - edges[:-1]) * rng.uniform(size=(8, 16))
    xy = np.broadcast_to(rng.uniform(-0.1, 1.1, (8, 1, 2)), (8, 16, 2))
    ndc = np.concatenate([xy, z[..., None]], -1).astype(np.float32)
    g = rng.standard_normal((8, 16, 8)).astype(np.float32)
    got, (_, n_merged) = _emulate_splat(t(g), t(ndc), volume.shape)
    assert n_merged > 0
    ref = np.asarray(jax.grad(lambda v: jnp.sum(
        sample_volume_pallas(v, jnp.asarray(ndc), 4) * g))(
            jnp.asarray(volume)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-4 * (1 + np.abs(ref).max()))


# ------------------------------------------------------- on the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with "
                    "`python -m pytest -m cuda --noconftest "
                    "tests/test_torch_volume_splat_merge.py`")
    return torch.device("cuda", 0)


# (volume shape, rays, samples): chip_smoke.py's fine-tune volume at C = 8
# and C = 20 with the step's batch, and a small odd one
CARD_CASES = [((128, 176, 208, 8), 1024, 128),
              ((128, 176, 208, 20), 1024, 128),
              ((37, 19, 23, 12), 77, 41)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES,
                         ids=["x".join(map(str, c[0])) for c in CARD_CASES])
def test_splat_kernel_matches_twin_and_float64_on_the_card(card, case):
    vg = _vg()
    shape, n, s = case
    ndc = torch.tensor(_rays(n + s, n, s, faces=True), device=card)
    gen = torch.Generator(device=card).manual_seed(n)
    g = torch.randn(n, s, shape[-1], generator=gen, device=card)
    volume = torch.randn(shape, generator=gen, device=card)
    adds = torch.zeros(2, dtype=torch.int64, device=card)
    before = vg.sample_volume.bwd_launches
    got = vg.volume_splat_kernel(g, ndc, shape, adds=adds)
    torch.cuda.synchronize()
    assert vg.sample_volume.bwd_launches == before + 1
    twin = vg.volume_splat_plain(g, ndc, volume)
    assert float((got - twin).abs().max()) <= \
        TOL_K5 * (1 + float(twin.abs().max()))
    ref = vg.volume_splat_plain(g.double(), ndc.double(), volume.double())
    own = max(float((twin.double() - ref).abs().max()),
              1e-6 * float(ref.abs().max()))
    assert float((got.double() - ref).abs().max()) <= TOL_ATOMIC * own
    # the kernel's adds are the rule's
    assert tuple(adds.tolist()) == vg.splat_merges(ndc, shape)[1]
    assert int(adds[1]) > 0
