"""The port's MessagePack codec (mvsnerf_tpu_torch/io/flax_msgpack.py)
against flax.serialization, byte for byte: `to_bytes` gives flax's
`to_bytes` bytes on trees of every scalar width, 0-d and empty arrays,
empty maps, nested tuples and named tuples and each dtype the trainers
write; `from_bytes` gives `msgpack_restore`'s tree (types, dtypes, shapes
and values exact) with the arrays viewing the buffer; arrays over
MAX_CHUNK_SIZE are chunked as flax chunks them (the limit monkeypatched
small on both sides); whatever lies outside the subset raises ValueError
naming it."""

import collections

import numpy as np
import pytest

from flax import serialization

from mvsnerf_tpu_torch.io import flax_msgpack

Adam = collections.namedtuple("Adam", "count mu nu")


def _ints():
    """Each boundary of MessagePack's int forms, both sides."""
    edges = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 63, 2 ** 64 - 1]
    return edges + [-1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
                    -2 ** 31 - 1, -2 ** 63]


def _trees():
    rng = np.random.default_rng(0)
    return {
        "ints": {"ints": _ints(), "step": 20000},
        "floats": {"f": [0.0, -0.0, 0.5, -1e300, float("inf"), 1e-310]},
        "strings": {"s": ["", "x" * 31, "y" * 32, "z" * 255, "w" * 256,
                          "v" * 65536, "ä"], "b": [b"", b"q" * 255,
                                                   b"r" * 256,
                                                   b"t" * 65536]},
        "scalars": {"none": None, "t": True, "f": False, "c": 1 + 2j,
                    "np": [np.float32(1.5), np.float64(-2.0), np.int32(-7),
                           np.int64(2 ** 40), np.uint8(255), np.bool_(True),
                           np.float16(0.25), np.complex64(1j)]},
        "containers": {"empty": {}, "empty_list": [], "tuple": (1, (2, 3)),
                       "many": {str(i): i for i in range(20)},
                       "long": list(range(70000))},
        "arrays": {"zero_d": np.zeros((), np.float32),
                   "count": np.array(3, np.int32),
                   "empty": np.zeros((0, 3), np.float32),
                   "f32": rng.standard_normal((3, 4)).astype(np.float32),
                   "f64": rng.standard_normal(5),
                   "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
                   "bool": np.array([True, False]),
                   "strided": np.arange(20, dtype=np.int8).reshape(4, 5)[
                       :, ::2],
                   "fortran": np.asfortranarray(
                       rng.standard_normal((3, 5)).astype(np.float32)),
                   "big": rng.standard_normal(70000).astype(np.float32)},
        # the shape of a trainer's snapshot: optax.adam's state as JAX's
        # save_checkpoint gives it to flax
        "snapshot": {"global_step": 2, "opt_state": (
            Adam(np.array(2, np.int32),
                 {"volume": np.zeros((4, 3, 2, 8), np.float32)},
                 {"volume": np.ones((4, 3, 2, 8), np.float32)}),
            {"count": np.array(2, np.int32)}),
            "params": {"mlp": {"pts_linears": [
                {"bias": np.zeros(4, np.float32),
                 "kernel": np.ones((3, 4), np.float32)}]},
                "volume": rng.standard_normal((4, 3, 2, 8)).astype(
                    np.float32)}},
    }


def _same(ours, ref, path="."):
    assert type(ours) is type(ref), (path, type(ours), type(ref))
    if isinstance(ref, dict):
        assert list(ours) == list(ref), path
        for k in ref:
            _same(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, list):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            _same(a, b, f"{path}/{i}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert ours == ref or (ours != ours and ref != ref), path


@pytest.mark.parametrize("name", sorted(_trees()))
def test_to_bytes_equals_flax(name):
    tree = _trees()[name]
    assert flax_msgpack.to_bytes(tree) == serialization.to_bytes(tree)


@pytest.mark.parametrize("name", sorted(_trees()))
def test_from_bytes_equals_flax(name):
    buf = serialization.to_bytes(_trees()[name])
    _same(flax_msgpack.from_bytes(buf), serialization.msgpack_restore(buf))


def test_arrays_view_the_buffer():
    """Decoding copies no array: each is a read-only view of the bytes."""
    buf = serialization.to_bytes({"a": np.arange(1000, dtype=np.float32)})
    a = flax_msgpack.from_bytes(buf)["a"]
    assert not a.flags.writeable and not a.flags.owndata
    assert np.shares_memory(a, np.frombuffer(buf, np.uint8))


@pytest.mark.parametrize("shape,dtype", [((30, 17), np.float32),
                                         ((600,), np.int16),
                                         ((7, 11, 3), np.float64)])
def test_chunked_arrays_match_flax(monkeypatch, shape, dtype):
    """Arrays over MAX_CHUNK_SIZE bytes (1000 here, 2**30 in both
    packages) go out as flax's chunk maps and come back whole."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 1000)
    rng = np.random.default_rng(1)
    arr = (rng.standard_normal(shape) * 100).astype(dtype)
    tree = {"x": arr, "nested": [{"y": arr[..., :1]}], "small": arr.flat[0]}
    buf = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in buf
    assert flax_msgpack.to_bytes(tree) == buf
    ours = flax_msgpack.from_bytes(buf)
    _same(ours, serialization.msgpack_restore(buf))
    np.testing.assert_array_equal(ours["x"], arr)


@pytest.mark.parametrize("code", [0, 4, 5, 127, -1])
def test_unknown_ext_codes_raise(code):
    """An ext type other than flax's 1 (ndarray), 2 (complex) and 3 (numpy
    scalar) raises, naming its code."""
    buf = bytes([0x81, 0xa1, ord("a"), 0xd4, code & 0xff, 0])
    with pytest.raises(ValueError, match=f"ext code {code}"):
        flax_msgpack.from_bytes(buf)


@pytest.mark.parametrize("buf,match", [
    (b"\xc1", "0xc1"), (b"\x92\x01", "truncated"), (b"\x01\x02", "after"),
    (b"\xc7\x10\x01\x93\x91\x01\xa8bfloat16\xc4\x02\x00\x00", "bfloat16")])
def test_outside_the_subset_raises(buf, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.from_bytes(buf)


def test_unpackable_leaf_raises():
    with pytest.raises(ValueError, match="set"):
        flax_msgpack.to_bytes({"a": {1, 2}})
