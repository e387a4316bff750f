r"""The committed runs' parameters, read once by the benchmark and handed to
both the program and the plain reference.

A frozen msgpack decoder for ``flax.serialization.to_bytes`` trees: maps of
maps whose leaves are ext objects (type 1 an ndarray as the triple ``(shape,
dtype name, raw C-order bytes)``, type 3 a numpy scalar, type 2 a complex
pair), large arrays as ``{'__msgpack_chunked_array__': ...}`` maps. A
configuration without ``weights`` takes parameters drawn from the seed
instead, by its arch's ``init_tree`` (``portbench.run.parameters``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Tuple

import numpy as np

_SCALARS = {
    0xca: '>f', 0xcb: '>d',
    0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
    0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q',
}
_SIZED = {
    0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
    0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
    0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
    0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
    0xde: ('map', '>H'), 0xdf: ('map', '>I'),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _unpack(fmt: str, view: memoryview, pos: int) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    if pos + size > len(view):
        raise ValueError('msgpack: truncated input')
    return struct.unpack(fmt, view[pos:pos + size])[0], pos + size


def _take(view: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(view):
        raise ValueError('msgpack: truncated input')
    return view[pos:pos + n], pos + n


def _decode(view: memoryview, pos: int) -> Tuple[Any, int]:
    byte, pos = _unpack('>B', view, pos)
    if byte <= 0x7f:
        return byte, pos
    if byte >= 0xe0:
        return byte - 0x100, pos
    if 0x80 <= byte <= 0x8f:
        return _decode_items(view, pos, byte & 0x0f, True)
    if 0x90 <= byte <= 0x9f:
        return _decode_items(view, pos, byte & 0x0f, False)
    if 0xa0 <= byte <= 0xbf:
        raw, pos = _take(view, pos, byte & 0x1f)
        return str(raw, 'utf-8'), pos
    if byte in (0xc0, 0xc2, 0xc3):
        return {0xc0: None, 0xc2: False, 0xc3: True}[byte], pos
    if byte in _SCALARS:
        return _unpack(_SCALARS[byte], view, pos)
    if byte in _FIXEXT:
        code, pos = _unpack('>b', view, pos)
        raw, pos = _take(view, pos, _FIXEXT[byte])
        return _ext(code, raw), pos
    if byte in _SIZED:
        kind, fmt = _SIZED[byte]
        n, pos = _unpack(fmt, view, pos)
        if kind in ('array', 'map'):
            return _decode_items(view, pos, n, kind == 'map')
        if kind == 'ext':
            code, pos = _unpack('>b', view, pos)
            raw, pos = _take(view, pos, n)
            return _ext(code, raw), pos
        raw, pos = _take(view, pos, n)
        return (str(raw, 'utf-8') if kind == 'str' else bytes(raw)), pos
    raise ValueError(f'msgpack: invalid first byte 0x{byte:02x}')


def _decode_items(view: memoryview, pos: int, n: int, mapping: bool) -> Tuple[Any, int]:
    out = {} if mapping else []
    for _ in range(n):
        item, pos = _decode(view, pos)
        if mapping:
            out[item], pos = _decode(view, pos)
        else:
            out.append(item)
    return out, pos


def _unpackb(data) -> Any:
    view = memoryview(data)
    obj, pos = _decode(view, 0)
    if pos != len(view):
        raise ValueError(f'msgpack: {len(view) - pos} trailing bytes')
    return obj


def _ext(code: int, payload: memoryview) -> Any:
    if code == 2:
        re, im = _unpackb(payload)
        return complex(re, im)
    if code not in (1, 3):
        raise ValueError(f'msgpack: ext type {code} is not one flax writes')
    shape, dtype, buffer = _unpackb(payload)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == 'bfloat16':
        array = (np.frombuffer(buffer, dtype='<u2').astype(np.uint32) << 16).view(np.float32)
    else:
        array = np.frombuffer(buffer, dtype=np.dtype(dtype))
    array = array.reshape(shape)
    return array[()] if code == 3 else array


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        chunks = [tree['chunks'][k] for k in sorted(tree['chunks'], key=int)]
        shape = tuple(tree['shape'][k] for k in sorted(tree['shape'], key=int))
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_tree(path: Path) -> dict:
    r"""A ``state.msgpack`` parameter tree: nested dicts of float32 numpy
    arrays under flax's module names (``ScoreUNet_0/UNet_0/Conv_0/kernel``)."""

    return _unchunk(_unpackb(Path(path).read_bytes()))


def flat(tree: dict, prefix: str = '') -> dict:
    r"""``{'ScoreUNet_0/UNet_0/Conv_0/kernel': array, ...}``."""

    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat(value, f'{prefix}{key}/'))
        else:
            out[prefix + key] = value
    return out
