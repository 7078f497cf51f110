"""The port's native host library (mvsnerf_tpu_torch/native, its own copy
of the C++ source, built with g++ into mvsnerf_tpu_torch/_build/) against
the JAX package's native library and the numpy routes, on seeded inputs.

Bit-equal everywhere but two places, where the C++ arithmetic itself
differs from numpy's (in both packages' libraries alike, which agree bit
for bit): `imagenet_normalize` multiplies by 1 / std where numpy divides
by std, and `dtu_depth_pipeline` scales the depths in double where numpy
scales float32; each is held to numpy within one float32 rounding (the
test says by how much). The batch iterator's batches are identical with
and without the native gather, and equal to the JAX iterator's."""

import numpy as np
import pytest

from mvsnerf_tpu import native as jax_native
from mvsnerf_tpu_torch import native
from mvsnerf_tpu_torch.data.common import (normalize_imagenet, read_pfm,
                                           resize_nearest, write_pfm)

RNG = np.random.default_rng(23)


@pytest.fixture(scope="module")
def built():
    """Both libraries, built (g++ is on this machine and on the card's)."""
    assert native.available(), "the port's native library did not build"
    assert jax_native.available()
    assert native._lib_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    return native


@pytest.fixture
def numpy_route(monkeypatch):
    """The port's native module with its library missing: every entry
    point takes its numpy route."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)
    assert not native.available()
    return native


@pytest.mark.parametrize("color", [False, True])
def test_pfm_decode_bit_equal(built, tmp_path, color):
    shape = (37, 53, 3) if color else (64, 80)
    depth = RNG.uniform(0, 900, shape).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    write_pfm(path, depth)
    raw = open(path, "rb").read()
    ours = native.pfm_decode(raw)
    assert ours.shape == shape and ours.dtype == np.float32
    np.testing.assert_array_equal(ours, depth)
    np.testing.assert_array_equal(ours, jax_native.pfm_decode(raw))
    np.testing.assert_array_equal(ours, read_pfm(path)[0])


def test_pfm_decode_big_endian(built, tmp_path):
    """A positive scale marks a big-endian payload: byte-swapped."""
    depth = RNG.uniform(0, 9, (5, 7)).astype(np.float32)
    raw = b"Pf\n7 5\n1.0\n" + np.flipud(depth).astype(">f").tobytes()
    np.testing.assert_array_equal(native.pfm_decode(raw), depth)
    with pytest.raises(ValueError):
        native.pfm_decode(b"Pf\n7 5\n1.0\n" + b"\0" * 8)


@pytest.mark.parametrize("down", [1.0, 0.5, 0.25])
def test_dtu_depth_pipeline(built, down):
    depth = RNG.uniform(400, 900, (1200, 1600)).astype(np.float32)
    ref = resize_nearest(depth, 0.5, 0.5)[44:556, 80:720]
    if down != 1.0:
        ref = resize_nearest(ref, down, down)
    ours = native.dtu_depth_pipeline(depth, down)
    assert ours.shape == (round(512 * down), round(640 * down))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, jax_native.dtu_depth_pipeline(
        depth, down))
    # the value scale runs in double in C++: one float32 rounding from
    # numpy's float32 product (2.4e-7 relative), bit-equal to JAX's library
    scaled = native.dtu_depth_pipeline(depth, down, 1 / 200)
    np.testing.assert_array_equal(scaled, jax_native.dtu_depth_pipeline(
        depth, down, 1 / 200))
    np.testing.assert_allclose(scaled, (ref * (1 / 200)).astype(np.float32),
                               rtol=2 ** -23, atol=0)


@pytest.mark.parametrize("m", [1024, 8192])
def test_ray_gather_bit_equal(built, m):
    """Below 4096 rows one thread copies, above it four."""
    rays = RNG.standard_normal((20000, 8)).astype(np.float32)
    rgbs = RNG.uniform(0, 1, (20000, 3)).astype(np.float32)
    idx = RNG.permutation(20000)[:m]
    r, c = native.ray_gather(rays, rgbs, idx)
    np.testing.assert_array_equal(r, rays[idx])
    np.testing.assert_array_equal(c, rgbs[idx])
    jr, jc = jax_native.ray_gather(rays, rgbs, idx)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(c, jc)


def test_ray_gather_refuses_bad_indices(built):
    rays = np.zeros((10, 8), np.float32)
    rgbs = np.zeros((10, 3), np.float32)
    with pytest.raises(IndexError):
        native.ray_gather(rays, rgbs, np.array([3, 10]))
    with pytest.raises(IndexError):
        native.ray_gather(rays, rgbs, np.array([-1]))
    with pytest.raises(ValueError):
        native.ray_gather(rays, rgbs[:9], np.array([0]))


@pytest.mark.parametrize("dtype,shape", [(np.float64, (50, 8)),
                                         (np.float32, (50, 2, 4))])
def test_ray_gather_other_buffers_take_numpy(built, dtype, shape):
    """Buffers that are not 2-D float32 take numpy's gather, dtype kept."""
    rays = RNG.standard_normal(shape).astype(dtype)
    rgbs = RNG.uniform(0, 1, (50, 3)).astype(dtype)
    idx = RNG.permutation(50)[:20]
    r, c = native.ray_gather(rays, rgbs, idx)
    assert r.dtype == dtype
    np.testing.assert_array_equal(r, rays[idx])
    np.testing.assert_array_equal(c, rgbs[idx])


def test_imagenet_normalize(built):
    img = RNG.uniform(0, 1, (32, 24, 3)).astype(np.float32)
    ours = native.imagenet_normalize_inplace(img.copy())
    np.testing.assert_array_equal(
        ours, jax_native.imagenet_normalize_inplace(img.copy()))
    # x (1 / std) against numpy's / std: within one rounding of |x| <= 2.7
    ref = normalize_imagenet(img)
    assert np.abs(ours - ref).max() <= 2 * 2 ** -23 * np.abs(ref).max()
    buf = img.copy()
    assert native.imagenet_normalize_inplace(buf) is buf


def test_numpy_routes(built, numpy_route, tmp_path):
    """Without the library every entry point still runs, on numpy, with
    numpy's own results."""
    depth = RNG.uniform(0, 900, (40, 30)).astype(np.float32)
    path = str(tmp_path / "d.pfm")
    write_pfm(path, depth)
    np.testing.assert_array_equal(
        numpy_route.pfm_decode(open(path, "rb").read()), depth)
    big = RNG.uniform(400, 900, (1200, 1600)).astype(np.float32)
    ref = resize_nearest(resize_nearest(big, 0.5, 0.5)[44:556, 80:720],
                         0.5, 0.5)
    np.testing.assert_array_equal(numpy_route.dtu_depth_pipeline(big, 0.5),
                                  ref)
    rays = RNG.standard_normal((100, 8)).astype(np.float32)
    rgbs = RNG.uniform(0, 1, (100, 3)).astype(np.float32)
    idx = RNG.permutation(100)[:40]
    r, c = numpy_route.ray_gather(rays, rgbs, idx)
    np.testing.assert_array_equal(r, rays[idx])
    np.testing.assert_array_equal(c, rgbs[idx])
    img = RNG.uniform(0, 1, (4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        numpy_route.imagenet_normalize_inplace(img.copy()),
        normalize_imagenet(img))


def test_failed_build_is_logged(monkeypatch, tmp_path, caplog):
    """A failed build says so in the log, and `available()` is False."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ["-DNOT_A_FLAG",
                                              "--not-a-g++-flag"])
    with caplog.at_level("WARNING", logger="mvsnerf_tpu_torch.native"):
        assert not native.available()
    assert "native library not built" in caplog.text
    assert not list(tmp_path.glob("*.so")) and not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("with_native", [True, False])
def test_batch_iterator_routes_match_jax(built, monkeypatch, with_native):
    """RayBatchIterator's {rays, rgbs} batches go through
    `native.ray_gather`; on its native route and on its numpy one they are
    the JAX iterator's batch for batch (same seed, over two epochs); other
    key sets take numpy's gather."""
    from mvsnerf_tpu.train.common import RayBatchIterator as JaxIterator
    from mvsnerf_tpu_torch.train.common import RayBatchIterator
    if not with_native:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_failed", True)
    calls = []
    gather = native.ray_gather
    monkeypatch.setattr(native, "ray_gather",
                        lambda *a: calls.append(1) or gather(*a))
    rays = RNG.standard_normal((3000, 8)).astype(np.float32)
    rgbs = RNG.uniform(0, 1, (3000, 3)).astype(np.float32)
    ours = RayBatchIterator({"rays": rays, "rgbs": rgbs}, 1024, seed=3)
    ref = JaxIterator({"rays": rays, "rgbs": rgbs}, 1024, seed=3)
    for _ in range(5):
        a, b = next(ours), next(ref)
        assert a.keys() == b.keys() == {"rays", "rgbs"}
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])
    assert len(calls) == 5 and native.available() == with_native
    # three keys: numpy's gather
    calls.clear()
    third = RayBatchIterator({"rays": rays, "rgbs": rgbs,
                              "idx": np.arange(3000)}, 1024, seed=3)
    batch = next(third)
    np.testing.assert_array_equal(batch["rays"], rays[batch["idx"]])
    assert not calls
