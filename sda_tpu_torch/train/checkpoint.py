r"""Reading the JAX package's ``state.msgpack`` checkpoints without flax.

``sda_tpu.train.checkpoint`` writes parameter trees with
``flax.serialization.to_bytes``: a msgpack map of maps whose leaves are
msgpack *ext* objects. Ext type 1 is an ndarray whose payload is itself
msgpack, the triple ``(shape, dtype_name, raw C-order bytes)``; ext type 3 is
a numpy scalar in the same encoding; ext type 2 a complex pair. Arrays over
flax's chunk size are stored as ``{'__msgpack_chunked_array__': ...}`` maps.

The port reads that format with its own decoder (no ``msgpack`` or ``flax``
on the machines it runs on) and maps the tree onto its modules with
:func:`params_from_flax`.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def unpackb(data: bytes) -> Any:
    r"""Decodes one msgpack object; maps become dicts, arrays lists, str keys
    are UTF-8 strings and flax's ndarray/scalar/complex ext types become numpy
    values (``bfloat16`` widens exactly to ``float32``)."""

    view = memoryview(data)
    obj, pos = _decode(view, 0)
    if pos != len(view):
        raise ValueError(f'msgpack: {len(view) - pos} trailing bytes')
    return obj


def _take(view: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(view):
        raise ValueError('msgpack: truncated input')
    return view[pos:pos + n], pos + n


def _unpack(fmt: str, view: memoryview, pos: int) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    raw, pos = _take(view, pos, size)
    return struct.unpack(fmt, raw)[0], pos


# Fixed-width scalars: first byte -> struct format (big-endian).
_SCALARS = {
    0xca: '>f', 0xcb: '>d',
    0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
    0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q',
}
# Length-prefixed payloads: first byte -> (kind, struct format of the length).
_SIZED = {
    0xc4: ('bin', '>B'), 0xc5: ('bin', '>H'), 0xc6: ('bin', '>I'),
    0xc7: ('ext', '>B'), 0xc8: ('ext', '>H'), 0xc9: ('ext', '>I'),
    0xd9: ('str', '>B'), 0xda: ('str', '>H'), 0xdb: ('str', '>I'),
    0xdc: ('array', '>H'), 0xdd: ('array', '>I'),
    0xde: ('map', '>H'), 0xdf: ('map', '>I'),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _decode(view: memoryview, pos: int) -> Tuple[Any, int]:
    byte, pos = _unpack('>B', view, pos)

    if byte <= 0x7f:
        return byte, pos
    if byte >= 0xe0:
        return byte - 0x100, pos
    if 0x80 <= byte <= 0x8f:
        return _decode_map(view, pos, byte & 0x0f)
    if 0x90 <= byte <= 0x9f:
        return _decode_array(view, pos, byte & 0x0f)
    if 0xa0 <= byte <= 0xbf:
        raw, pos = _take(view, pos, byte & 0x1f)
        return str(raw, 'utf-8'), pos
    if byte == 0xc0:
        return None, pos
    if byte == 0xc2:
        return False, pos
    if byte == 0xc3:
        return True, pos
    if byte in _SCALARS:
        return _unpack(_SCALARS[byte], view, pos)
    if byte in _FIXEXT:
        code, pos = _unpack('>b', view, pos)
        raw, pos = _take(view, pos, _FIXEXT[byte])
        return _ext(code, raw), pos
    if byte in _SIZED:
        kind, fmt = _SIZED[byte]
        n, pos = _unpack(fmt, view, pos)
        if kind == 'array':
            return _decode_array(view, pos, n)
        if kind == 'map':
            return _decode_map(view, pos, n)
        if kind == 'ext':
            code, pos = _unpack('>b', view, pos)
            raw, pos = _take(view, pos, n)
            return _ext(code, raw), pos
        raw, pos = _take(view, pos, n)
        return (str(raw, 'utf-8') if kind == 'str' else bytes(raw)), pos

    raise ValueError(f'msgpack: invalid first byte 0x{byte:02x}')


def _decode_array(view: memoryview, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _decode(view, pos)
        out.append(item)
    return out, pos


def _decode_map(view: memoryview, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, pos = _decode(view, pos)
        value, pos = _decode(view, pos)
        out[key] = value
    return out, pos


def _ndarray(payload: memoryview) -> np.ndarray:
    shape, dtype, buffer = unpackb(payload)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == 'bfloat16':
        # bf16 is the top half of an f32: widen exactly.
        bits = np.frombuffer(buffer, dtype='<u2').astype(np.uint32) << 16
        array = bits.view(np.float32)
    else:
        array = np.frombuffer(buffer, dtype=np.dtype(dtype))
    return array.reshape(shape)


def _ext(code: int, payload: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(payload)
        return complex(re, im)
    raise ValueError(f'msgpack: ext type {code} is not one flax writes')


def _unchunk(tree: Any) -> Any:
    r"""Reassembles flax's chunked array leaves."""

    if not isinstance(tree, dict):
        return tree
    if '__msgpack_chunked_array__' in tree:
        chunks = tree['chunks']
        chunks = [chunks[k] for k in sorted(chunks, key=int)]
        shape = tuple(tree['shape'][k] for k in sorted(tree['shape'], key=int))
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    r"""The port's ``flax.serialization.msgpack_restore``: bytes -> tree of
    dicts with numpy leaves."""

    return _unchunk(unpackb(data))


def load_params(path: Path) -> Dict[str, Any]:
    r"""Reads a ``state.msgpack`` parameter tree (``sda_tpu.train.load_params``
    without the template: the port maps the tree with
    :func:`params_from_flax`)."""

    return msgpack_restore(Path(path).read_bytes())


#: Flax module name -> the port's attribute. Singletons (``X_0``) become the
#: attribute itself; the others are ``nn.ModuleList``s in flax creation
#: order, so ``Conv_3`` is ``convs.3``.
_SINGLE = {
    'ScoreUNet': 'score',
    'UNet': 'unet',
    'TimeEmbedding': 'embedding',
    'ResMLP': 'mlp',
}
_LISTS = {
    'Conv': 'convs',
    'Dense': 'denses',
    'ModResidualBlock': 'blocks',
}


def _flax_name(name: str) -> str:
    kind, _, index = name.rpartition('_')
    if kind in _SINGLE and index == '0':
        return _SINGLE[kind]
    if kind in _LISTS and index.isdigit():
        return f'{_LISTS[kind]}.{index}'
    raise KeyError(f'no counterpart for flax module {name!r}')


def params_from_flax(tree: Dict[str, Any], prefix: str = '') -> Dict[str, torch.Tensor]:
    r"""Maps a flax parameter tree onto the port's ``state_dict`` keys.

    - ``kernel`` becomes ``weight``: Dense ``(in, out)`` -> ``(out, in)``;
      Conv ``(*spatial, in, out)`` (HWIO) -> ``(out, in, *spatial)`` (OIHW).
    - ``bias`` stays.
    - Module names follow the flax creation order (see ``_SINGLE``/``_LISTS``).
    """

    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(params_from_flax(value, f'{prefix}{_flax_name(name)}.'))
            continue

        array = np.asarray(value, dtype=np.float32)
        if name == 'kernel':
            name = 'weight'
            if array.ndim == 2:
                array = array.T
            else:
                array = np.moveaxis(array, (-1, -2), (0, 1))
        elif name != 'bias':
            raise KeyError(f'unexpected flax parameter {prefix}{name}')

        out[prefix + name] = torch.tensor(array)
    return out
