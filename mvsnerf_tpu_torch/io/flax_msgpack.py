"""The MessagePack subset that `flax.serialization.to_bytes` writes, read
and written without `msgpack` or `flax` (the JAX package's `.msgpack`
snapshots, mvsnerf_tpu/io/checkpoint.py:26).

A tree is first turned into flax's state dict: dicts keep their insertion
order with `str` keys, lists and tuples become maps keyed "0", "1", ...,
and named tuples maps of their fields. Arrays over `MAX_CHUNK_SIZE` bytes
become `{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{...}}`. Then it is packed as msgpack-python packs it with
`strict_types=True`:

- nil, bool, ints in their smallest form, Python floats as float64, str,
  bin, arrays and maps;
- ext 1, an ndarray: its payload is itself packed, `[list(shape),
  dtype.name, bytes in C order]`;
- ext 2, a Python complex: `[real, imag]`;
- ext 3, a numpy scalar: an ndarray payload of shape ().

The same tree then gives the same bytes as flax. Decoding takes every
MessagePack type flax can write (float32 too) and reads each array with
`np.frombuffer` over the given buffer, so a snapshot's arrays are views
of the file's bytes, not copies. Anything outside the subset (ext codes
other than 1-3, the unused code 0xc1, bfloat16) raises ValueError naming
it.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit per leaf is 2**31 - 1
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------- encode --

def state_dict(tree):
    """flax's `to_state_dict`: containers to str-keyed dicts, leaves as
    they are."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: state_dict(getattr(tree, k)) for k in tree._fields}
    if isinstance(tree, dict):
        out = {str(k): state_dict(v) for k, v in tree.items()}
        if len(out) != len(tree):
            raise ValueError(f"dict keys without unique str forms: "
                             f"{list(tree)}")
        return out
    if isinstance(tree, (list, tuple)):
        return {str(i): state_dict(v) for i, v in enumerate(tree)}
    return tree


def _chunk(arr):
    """flax's `_chunk`: an oversized array as flat chunks of at most
    MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, flat.size, size))}}


def _chunked(tree):
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def _sized(n, small, codes, fix=None, fix_limit=0):
    """The header of a length-prefixed item: `fix | n` below `fix_limit`,
    else the first of `codes` (8-, 16-, 32-bit lengths) that holds n."""
    if fix is not None and n < fix_limit:
        return bytes([fix | n])
    for code, fmt in zip(codes, small):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return struct.pack(">B" + fmt, code, n)
    raise ValueError(f"length {n} does not fit MessagePack")


def _int(v):
    if 0 <= v < 128 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v > 0:
        for code, fmt in ((0xcc, "B"), (0xcd, "H"), (0xce, "I"),
                          (0xcf, "Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                return struct.pack(">B" + fmt, code, v)
    else:
        for code, fmt in ((0xd0, "b"), (0xd1, "h"), (0xd2, "i"),
                          (0xd3, "q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                return struct.pack(">B" + fmt, code, v)
    raise ValueError(f"int {v} does not fit MessagePack's 64 bits")


def _ndarray_pieces(arr):
    """The inner packing of an ndarray: [shape, dtype name, C bytes]."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct or \
            arr.dtype.names is not None:
        raise ValueError(f"dtype {arr.dtype} is not serialisable")
    if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    head = [b"\x93", _sized(arr.ndim, "HI", (0xdc, 0xdd), 0x90, 16)]
    head += [_int(int(d)) for d in arr.shape]
    name = arr.dtype.name.encode()
    head += [_sized(len(name), "BHI", (0xd9, 0xda, 0xdb), 0xa0, 32), name,
             _sized(arr.nbytes, "BHI", (0xc4, 0xc5, 0xc6))]
    return head, memoryview(arr.reshape(-1).view(np.uint8))


def _ext(code, pieces):
    n = sum(len(p) for p in pieces)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return [bytes([fixed[n], code]), *pieces]
    return [_sized(n, "BHI", (0xc7, 0xc8, 0xc9)), bytes([code]), *pieces]


def _pieces(obj, out):
    """Append obj's packing to `out` (msgpack-python, strict types)."""
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(struct.pack(">Bd", 0xcb, obj))
    elif type(obj) is str:
        b = obj.encode("utf-8")
        out += [_sized(len(b), "BHI", (0xd9, 0xda, 0xdb), 0xa0, 32), b]
    elif type(obj) is bytes:
        out += [_sized(len(obj), "BHI", (0xc4, 0xc5, 0xc6)), obj]
    elif isinstance(obj, dict):
        out.append(_sized(len(obj), "HI", (0xde, 0xdf), 0x80, 16))
        for k, v in obj.items():
            _pieces(k, out)
            _pieces(v, out)
    elif type(obj) is list:
        out.append(_sized(len(obj), "HI", (0xdc, 0xdd), 0x90, 16))
        for v in obj:
            _pieces(v, out)
    elif isinstance(obj, np.ndarray):
        head, data = _ndarray_pieces(obj)
        out += _ext(EXT_NDARRAY, [*head, data])
    elif isinstance(obj, np.generic):
        head, data = _ndarray_pieces(np.asarray(obj))
        out += _ext(EXT_NPSCALAR, [*head, bytes(data)])
    elif type(obj) is complex:
        out += _ext(EXT_COMPLEX, [b"\x92", struct.pack(">Bd", 0xcb, obj.real),
                                  struct.pack(">Bd", 0xcb, obj.imag)])
    else:
        raise ValueError(f"type {type(obj).__name__} is outside flax's "
                         f"MessagePack subset")


def pieces(tree):
    """The packing of `tree` as a list of bytes-like pieces (arrays are
    memoryviews of their data, not copies), for writing to a file."""
    out = []
    _pieces(_chunked(state_dict(tree)), out)
    return out


def to_bytes(tree) -> bytes:
    """`flax.serialization.to_bytes(tree)`'s bytes."""
    return b"".join(pieces(tree))


# ---------------------------------------------------------------- decode --

_FIXED = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
          0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LENGTH = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xc7: ">B", 0xc8: ">H",
           0xc9: ">I", 0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xdc: ">H",
           0xdd: ">I", 0xde: ">H", 0xdf: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, buf, pos: int = 0, end: int | None = None,
                 raw: bool = False):
        self.buf, self.pos = buf, pos
        self.end = len(buf) if end is None else end
        self.raw = raw

    def take(self, n: int) -> int:
        start = self.pos
        if n < 0 or start + n > self.end:
            raise ValueError(f"truncated MessagePack at byte {start}: "
                             f"{n} bytes wanted, {self.end - start} left")
        self.pos += n
        return start

    def unpack(self, fmt: str):
        return struct.unpack_from(fmt, self.buf, self.take(
            struct.calcsize(fmt)))[0]

    def read(self):
        code = self.buf[self.take(1)]
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code <= 0x8f:
            return self._map(code & 0x0f)
        if 0x90 <= code <= 0x9f:
            return [self.read() for _ in range(code & 0x0f)]
        if 0xa0 <= code <= 0xbf:
            return self._str(code & 0x1f)
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _FIXED:
            return self.unpack(_FIXED[code])
        if code in _FIXEXT:
            return self._ext(_FIXEXT[code])
        if code in _LENGTH:
            n = self.unpack(_LENGTH[code])
            if code <= 0xc6:
                start = self.take(n)
                return bytes(self.buf[start:start + n])
            if code <= 0xc9:
                return self._ext(n)
            if code <= 0xdb:
                return self._str(n)
            if code <= 0xdd:
                return [self.read() for _ in range(n)]
            return self._map(n)
        raise ValueError(f"MessagePack type code 0x{code:02x} is outside "
                         f"flax's subset")

    def _str(self, n: int):
        start = self.take(n)
        b = bytes(self.buf[start:start + n])
        return b if self.raw else b.decode("utf-8")

    def _map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = struct.unpack_from(">b", self.buf, self.take(1))[0]
        start = self.take(n)
        inner = _Reader(self.buf, start, start + n, raw=True)
        if code == EXT_NDARRAY:
            out = inner.ndarray()
        elif code == EXT_NPSCALAR:
            out = inner.ndarray()[()]
        elif code == EXT_COMPLEX:
            re, im = inner.read()
            out = complex(re, im)
        else:
            raise ValueError(f"MessagePack ext code {code} is outside "
                             f"flax's subset (1 ndarray, 2 complex, 3 numpy "
                             f"scalar)")
        if inner.pos != inner.end:
            raise ValueError(f"ext {code} payload has "
                             f"{inner.end - inner.pos} trailing bytes")
        return out

    def ndarray(self):
        """[shape, dtype name, bin] -> a view of the buffer."""
        if self.buf[self.take(1)] != 0x93:
            raise ValueError("an ndarray payload is not a 3-array")
        shape = self.read()
        name = self.read()
        name = name.decode() if isinstance(name, bytes) else name
        if name == "bfloat16":
            raise ValueError("dtype bfloat16 is not readable without JAX's "
                             "ml_dtypes")
        dtype = np.dtype(name)
        code = self.buf[self.take(1)]
        if code not in (0xc4, 0xc5, 0xc6):
            raise ValueError(f"ndarray data has type code 0x{code:02x}, "
                             f"not bin")
        n = self.unpack(_LENGTH[code])
        start = self.take(n)
        return np.frombuffer(self.buf, dtype, n // dtype.itemsize,
                             start).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def from_bytes(buf):
    """The state dict in `buf` (bytes, bytearray, memoryview or mmap):
    str-keyed dicts, lists, scalars and numpy arrays viewing `buf`, with
    chunked arrays joined (flax's `msgpack_restore`)."""
    reader = _Reader(memoryview(buf).cast("B") if not isinstance(
        buf, (bytes, bytearray)) else buf)
    tree = reader.read()
    if reader.pos != reader.end:
        raise ValueError(f"{reader.end - reader.pos} bytes after the "
                         f"MessagePack object")
    return _unchunk(tree)
