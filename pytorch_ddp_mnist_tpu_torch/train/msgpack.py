"""The subset of msgpack that flax's checkpoints use, in pure Python and
numpy (the JAX package writes its `.msgpack` checkpoints with
`flax.serialization.to_bytes` and reads them with `from_bytes` /
`msgpack_restore`; the card's machine has neither flax nor msgpack).

What is written is what `flax.serialization.to_bytes` writes for a tree of
dicts with str keys and numpy leaves, byte for byte:

  * a dict: a map in the dict's own key order (fixmap, map16, map32);
  * an ndarray: ext type 1, whose payload is msgpack of the 3-array
    (shape, dtype name, the C-order bytes), the name a str and the bytes a
    bin;
  * a numpy scalar: ext type 3 with the payload of its 0-d array;
  * ints, floats (float64), str, bin, bool, None, lists and tuples (as
    arrays), each in msgpack's smallest form, as the msgpack package
    packs them.

Leaves over flax's chunking size (2**30 bytes) are refused by name: flax
would split them into a chunked map, which no model of this repository
comes near. `unpackb` reads the same subset plus float32 and the other
int forms, and gives ndarrays (read-only views of the payload, as flax's)
for ext 1 and numpy scalars for ext 3.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
# flax.serialization.MAX_CHUNK_SIZE: larger leaves are written chunked
MAX_CHUNK_SIZE = 2 ** 30


class MsgpackError(ValueError):
    """Bytes that are not the msgpack subset this module reads."""


def _int(n: int, out: list) -> None:
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif n >= 0:
        for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(struct.pack("B", code) + struct.pack(fmt, n))
                return
        raise MsgpackError(f"integer {n} does not fit in 64 bits")
    elif n >= -32:
        out.append(struct.pack("b", n))
    else:
        for code, fmt, low in ((0xD0, "b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(struct.pack("B", code) + struct.pack(fmt, n))
                return
        raise MsgpackError(f"integer {n} does not fit in 64 bits")


def _sized(n: int, fix, fix_max: int, codes, out: list) -> None:
    """A length header: the fix form below `fix_max`, else the 8/16/32-bit
    forms in `codes` ((code, struct format, largest length), ...)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
        return
    for code, fmt, top in codes:
        if code is not None and n <= top:
            out.append(struct.pack("B", code) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"length {n} is too long for msgpack")


_STR = ((0xD9, "B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, "B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((None, "", 0), (0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((None, "", 0), (0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, "B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def ndarray_payload(arr: np.ndarray) -> bytes:
    """The ext-1 payload of an array: msgpack of (shape, dtype name, the
    C-order bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise MsgpackError("object and structured dtypes have no msgpack "
                           "form")
    return packb((tuple(int(d) for d in arr.shape), arr.dtype.name,
                  arr.tobytes("C")))


def _ext(code: int, payload: bytes, out: list) -> None:
    n = len(payload)
    if n in _FIXEXT:
        out.append(struct.pack("Bb", _FIXEXT[n], code))
    else:
        _sized(n, None, 0, _EXT, out)
        out.append(struct.pack("b", code))
    out.append(payload)


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, np.ndarray):
        if obj.size * obj.dtype.itemsize > MAX_CHUNK_SIZE:
            raise MsgpackError(
                f"an array of {obj.size * obj.dtype.itemsize} bytes is over "
                f"flax's chunking size ({MAX_CHUNK_SIZE}); chunked leaves "
                f"are not written here")
        _ext(EXT_NDARRAY, ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _ext(EXT_NPSCALAR, ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _int(obj, out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _sized(len(raw), 0xA0, 32, _STR, out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _sized(len(raw), None, 0, _BIN, out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _sized(len(obj), 0x90, 16, _ARR, out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _sized(len(obj), 0x80, 16, _MAP, out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise MsgpackError(f"{type(obj).__name__} has no msgpack form here")


def packb(obj) -> bytes:
    """`obj` as msgpack bytes (see the module docstring)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def to_bytes(tree) -> bytes:
    """`flax.serialization.to_bytes` of a params tree of numpy arrays (or
    of anything `np.asarray` takes), with its str keys."""
    def host(node):
        if isinstance(node, dict):
            return {str(k): host(v) for k, v in node.items()}
        return node if isinstance(node, (np.ndarray, np.generic)) else \
            np.asarray(node)
    return packb(host(tree))


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset "
                               f"{self.pos} of {len(self.data)}")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise MsgpackError(f"ext type {code} is not one flax writes for "
                               f"arrays")
        arr = ndarray_from_payload(payload)
        return arr[()] if code == EXT_NPSCALAR else arr

    def obj(self):
        b = self.num("B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        nums = {0xCA: ">f", 0xCB: ">d", 0xCC: "B", 0xCD: ">H", 0xCE: ">I",
                0xCF: ">Q", 0xD0: "b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in nums:
            return self.num(nums[b])
        sizes = {0xC4: "B", 0xC5: ">H", 0xC6: ">I", 0xD9: "B", 0xDA: ">H",
                 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                 0xC7: "B", 0xC8: ">H", 0xC9: ">I"}
        if b in sizes:
            n = self.num(sizes[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self.str_(n)
            if b in (0xDC, 0xDD):
                return self.array(n)
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(self.num("b"), n)
        fixext = {v: k for k, v in _FIXEXT.items()}
        if b in fixext:
            code = self.num("b")
            return self.ext(code, fixext[b])
        raise MsgpackError(f"byte {b:#04x} at offset {self.pos - 1} starts "
                           f"no msgpack object this module reads")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if isinstance(k, list):
                k = tuple(k)
            out[k] = self.obj()
        return out


def ndarray_from_payload(payload: bytes) -> np.ndarray:
    """An ext-1 payload -> the array (read-only, over the payload)."""
    r = _Reader(payload, raw=True)
    shape, name, buf = r.obj()
    if r.pos != len(payload):
        raise MsgpackError("trailing bytes after an ndarray payload")
    try:
        dtype = np.dtype(name.decode() if isinstance(name, bytes) else name)
    except TypeError as e:
        raise MsgpackError(f"dtype {name!r} is not a numpy dtype") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape, order="C")


def unpackb(data: bytes):
    """Decode msgpack bytes written by flax (`msgpack_restore`) or by
    `packb`. Raises MsgpackError on bytes it cannot read (truncated,
    trailing data, an unknown form)."""
    r = _Reader(bytes(data), raw=False)
    obj = r.obj()
    if r.pos != len(r.data):
        raise MsgpackError(f"{len(r.data) - r.pos} trailing bytes after the "
                           f"object")
    return obj
