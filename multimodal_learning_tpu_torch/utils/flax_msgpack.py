"""flax's msgpack state encoding, read and written without flax or msgpack.

``flax.serialization.to_bytes(x)`` turns ``x`` into a state dict
(``to_state_dict``: dataclass fields by name, tuples and lists as maps
keyed ``"0"``, ``"1"``, ..., namedtuples such as optax's
``ScaleByAdamState`` by field name, dicts with their keys as strings) and
packs that with ``msgpack.packb(..., default=_msgpack_ext_pack,
strict_types=True)``; ``msgpack_restore`` unpacks it.  This module does
both for the subset those calls use:

- nil, bool, int (the shortest msgpack form), float (64-bit), str (UTF-8),
  bin, array and map;
- flax's ext types: 1, an ``np.ndarray`` as the packed triple ``(shape,
  dtype name, C-order bytes)``; 2, a Python ``complex`` as the packed pair
  ``(real, imag)``; 3, a numpy scalar, packed as a 0-d array.

Anything else raises ``TypeError`` (writing) or ``ValueError`` (reading),
as do the dtypes numpy does not know (flax's ``bfloat16``) and flax's
chunked form of arrays above 1 GiB.  ``to_bytes(from_bytes(b)) == b`` for
every ``b`` that flax wrote, since maps keep their order.
"""
from __future__ import annotations

import dataclasses
import struct
from typing import Any, List, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def to_state_dict(x: Any) -> Any:
    """flax's state-dict layout of ``x``; leaves stay as they are."""
    if isinstance(x, dict):
        out = {str(k): to_state_dict(v) for k, v in x.items()}
        if len(out) != len(x):
            raise ValueError(f"keys {list(x)} collide as strings")
        return out
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_state_dict(getattr(x, k)) for k in x._fields}
    if isinstance(x, (tuple, list)):
        return {str(i): to_state_dict(v) for i, v in enumerate(x)}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: to_state_dict(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


def _head(n: int, fix: int, fix_max: int,
          codes: Tuple[int, int, int]) -> bytes:
    """A length header: the fix form up to ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; 0 where msgpack has no such form)."""
    if n <= fix_max:
        return bytes((fix | n,))
    if codes[0] and n <= 0xFF:
        return bytes((codes[0], n))
    if n <= 0xFFFF:
        return bytes((codes[1],)) + struct.pack(">H", n)
    if n <= 0xFFFFFFFF:
        return bytes((codes[2],)) + struct.pack(">I", n)
    raise ValueError(f"a msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80 or -0x20 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) \
        if v > 0 else ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        try:
            return bytes((code,)) + struct.pack(fmt, v)
        except struct.error:
            continue
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext(parts: List, code: int, inner: List) -> None:
    n = sum(len(p) for p in inner)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    parts.append(bytes((fixed[n],)) if n in fixed
                 else _head(n, 0, -1, (0xC7, 0xC8, 0xC9)))
    parts.append(struct.pack(">b", code))
    parts.extend(inner)


def _ndarray(arr: np.ndarray) -> List:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise TypeError(f"cannot encode an array of dtype {arr.dtype}")
    data = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    inner: List = []
    _pack(inner, [[int(d) for d in arr.shape], arr.dtype.name,
                  memoryview(data)])
    return inner


def _pack(parts: List, x: Any) -> None:
    """Append the msgpack encoding of ``x`` to ``parts`` (bytes-likes)."""
    t = type(x)
    if x is None:
        parts.append(b"\xc0")
    elif t is bool:
        parts.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        parts.append(_int(x))
    elif t is float:
        parts.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        data = x.encode("utf-8")
        parts += (_head(len(data), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB)), data)
    elif t in (bytes, bytearray, memoryview):
        parts += (_head(len(x), 0, -1, (0xC4, 0xC5, 0xC6)), x)
    elif t in (list, tuple):
        parts.append(_head(len(x), 0x90, 0x0F, (0, 0xDC, 0xDD)))
        for v in x:
            _pack(parts, v)
    elif t is dict:
        parts.append(_head(len(x), 0x80, 0x0F, (0, 0xDE, 0xDF)))
        for k, v in x.items():
            _pack(parts, k)
            _pack(parts, v)
    elif isinstance(x, np.ndarray):
        _ext(parts, EXT_NDARRAY, _ndarray(x))
    elif isinstance(x, np.generic):
        _ext(parts, EXT_NPSCALAR, _ndarray(np.asarray(x)))
    elif t is complex:
        inner: List = []
        _pack(inner, [x.real, x.imag])
        _ext(parts, EXT_COMPLEX, inner)
    else:
        raise TypeError(f"cannot encode a {t.__module__}.{t.__qualname__} "
                        "in flax's msgpack layout")


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists,
    tuples, namedtuples and dataclasses over the leaves listed above."""
    parts: List = []
    _pack(parts, to_state_dict(tree))
    return b"".join(parts)


class _Reader:
    """Reads one msgpack object; ``bin`` objects come back as bytes, or
    with ``views`` as memoryviews into ``data``."""

    def __init__(self, data, views: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends early")
        chunk = self.buf[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.num(">B")
        if b < 0x80 or b >= 0xE0:
            return struct.unpack(">b", bytes((b,)))[0] if b >= 0xE0 else b
        if b < 0x90:
            return self.map(b & 0x0F)
        if b < 0xA0:
            return self.array(b & 0x0F)
        if b < 0xC0:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            v = self.num(ints[b])
            return float(v) if b in (0xCA, 0xCB) else v
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"), 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.num(fmt)
            if kind == "bin":
                return self.take(n) if self.views else bytes(self.take(n))
            return getattr(self, kind)(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"msgpack type byte 0x{b:02x} at offset "
                         f"{self.pos - 1} is outside flax's subset")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked arrays (above 1 GiB) are not "
                             "read")
        return out

    def ext(self, n: int) -> Any:
        code = self.num(">b")
        data = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, name, buf = _Reader(data, views=True).value()
            try:
                dtype = np.dtype(name)
            except TypeError:
                raise ValueError(f"array dtype {name!r} is not a numpy "
                                 "dtype") from None
            # one copy, into a writable buffer
            arr = np.frombuffer(bytearray(buf), dtype=dtype).reshape(shape)
            return arr[()] if code == EXT_NPSCALAR else arr
        if code == EXT_COMPLEX:
            re, im = _Reader(data).value()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def from_bytes(data) -> Any:
    """``flax.serialization.msgpack_restore(data)``: the state dict, with
    writable numpy arrays (and numpy scalars, complex numbers) as leaves."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes follow the "
                         "msgpack object")
    return tree
