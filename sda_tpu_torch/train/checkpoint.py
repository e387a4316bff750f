r"""Reading and writing the JAX package's ``state.msgpack`` checkpoints
without flax.

``sda_tpu.train.checkpoint`` writes parameter trees with
``flax.serialization.to_bytes``: a msgpack map of maps whose leaves are
msgpack *ext* objects. Ext type 1 is an ndarray whose payload is itself
msgpack, the triple ``(shape, dtype_name, raw C-order bytes)``; ext type 3 is
a numpy scalar in the same encoding; ext type 2 a complex pair. Arrays over
flax's chunk size are stored as ``{'__msgpack_chunked_array__': ...}`` maps.

The port reads that format with its own decoder (no ``msgpack`` or ``flax``
on the machines it runs on) and maps the tree onto its modules with
:func:`params_from_flax`. It writes it with its own encoder, byte for byte as
``flax.serialization.to_bytes`` would, after :func:`params_to_flax` has mapped
a module's parameters back: ``sda_tpu.train.load_params`` reads the port's
``state.msgpack`` and the port reads the JAX package's. The trainer's full
state (:func:`save_checkpoint`) goes through the same encoder; only the port
reads it back.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

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


# -- Writing ---------------------------------------------------------------

#: flax's ``MAX_CHUNK_SIZE``: larger arrays would be written in chunks.
_MAX_ARRAY_BYTES = 2**30


def packb(obj: Any) -> bytes:
    r"""Encodes ``obj`` as ``flax.serialization.to_bytes`` does: dicts (in
    their own order), lists and tuples, ``str``, ``bytes``, ``int``, ``float`` (as
    doubles), ``bool``, ``None``, complex numbers and numpy arrays and
    scalars (flax's ext types), each in msgpack's shortest form."""

    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes: Tuple[int, ...]) -> None:
    r"""A length prefix: ``fix | n`` if ``n < fix_max`` (``fix`` may be
    ``None``), else the 8/16/32-bit forms in ``codes`` (``0`` = none)."""

    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, ('>B', '>H', '>I'), (2**8, 2**16, 2**32)):
        if code and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f'msgpack: length {n} too large')


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _encode_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack('>d', obj)
    elif isinstance(obj, str):
        raw = obj.encode('utf-8')
        _header(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _header(out, len(raw), None, 0, (0xc4, 0xc5, 0xc6))
        out += raw
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (0, 0xde, 0xdf))
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (0, 0xdc, 0xdd))
        for item in obj:
            _encode(item, out)
    elif isinstance(obj, np.ndarray):
        _encode_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _encode_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    elif isinstance(obj, complex):
        _encode_ext(_EXT_COMPLEX, packb((obj.real, obj.imag)), out)
    else:
        raise TypeError(f'msgpack: cannot encode {type(obj).__name__}')


def _encode_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n + 0x100)
    elif n >= 0:
        for code, fmt, limit in ((0xcc, '>B', 2**8), (0xcd, '>H', 2**16), (0xce, '>I', 2**32), (0xcf, '>Q', 2**64)):
            if n < limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f'msgpack: integer {n} too large')
    else:
        for code, fmt, limit in ((0xd0, '>b', 2**7), (0xd1, '>h', 2**15), (0xd2, '>i', 2**31), (0xd3, '>q', 2**63)):
            if n >= -limit:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f'msgpack: integer {n} too small')


def _ndarray_bytes(array: np.ndarray) -> bytes:
    if array.dtype.hasobject or array.dtype.fields is not None:
        raise ValueError('msgpack: object and structured arrays are not written')
    if array.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError(f'msgpack: an array of {array.nbytes} bytes would need flax\'s chunked layout')
    return packb((array.shape, array.dtype.name, array.tobytes('C')))


def _encode_ext(code: int, payload: bytes, out: bytearray) -> None:
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if len(payload) in fixext:
        out.append(fixext[len(payload)])
    else:
        _header(out, len(payload), None, 0, (0xc7, 0xc8, 0xc9))
    out += struct.pack('>b', code)
    out += payload


def _write(data: bytes, path: Path) -> None:
    r"""Writes ``data`` through ``path.tmp``, so that a reader or a killed
    run never sees a partial file."""

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + '.tmp')
    tmp.write_bytes(data)
    tmp.replace(path)


def save_params(module: nn.Module, path: Path) -> None:
    r"""Writes ``module``'s parameters as a ``state.msgpack`` that
    ``sda_tpu.train.load_params`` reads (``sda_tpu.train.save_params``)."""

    _write(packb(params_to_flax(module.state_dict())), path)


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
_FLAX_SINGLE = {attr: f'{kind}_0' for kind, attr in _SINGLE.items()}
_FLAX_LISTS = {attr: kind for kind, attr in _LISTS.items()}


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


def params_to_flax(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    r"""The inverse of :func:`params_from_flax`: a ``state_dict`` becomes a
    flax parameter tree of float32 numpy arrays."""

    tree = {}
    for key, value in params.items():
        *path, name = key.split('.')
        names = []
        parts = iter(path)
        for attr in parts:
            if attr in _FLAX_SINGLE:
                names.append(_FLAX_SINGLE[attr])
            elif attr in _FLAX_LISTS:
                names.append(f'{_FLAX_LISTS[attr]}_{next(parts)}')
            else:
                raise KeyError(f'no flax counterpart for {key!r}')

        array = value.detach().to('cpu', torch.float32).numpy()
        if name == 'weight':
            name = 'kernel'
            array = array.T if array.ndim == 2 else np.moveaxis(array, (0, 1), (-1, -2))
        elif name != 'bias':
            raise KeyError(f'unexpected parameter {key!r}')

        node = tree
        for part in names:
            node = node.setdefault(part, {})
        node[name] = np.ascontiguousarray(array)
    return tree


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree


def _to_torch(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return tree


def save_checkpoint(trainer, path: Path) -> None:
    r"""Writes a :class:`~sda_tpu_torch.train.Trainer`'s full resumable
    state: parameters (flax layout), the optimizer's state (AdamW moments
    and step counts), the optimizer step, the epoch and the generator."""

    state = {
        'params': params_to_flax(trainer.module.state_dict()),
        'optimizer': _to_numpy(trainer.optimizer.state_dict()),
        'step': trainer.step,
        'epoch': trainer.epoch,
        'generator': trainer.generator.get_state().numpy().tobytes(),
    }
    _write(packb(state), path)


def restore_checkpoint(trainer, path: Path) -> None:
    r"""Restores a trainer in place from :func:`save_checkpoint`."""

    state = msgpack_restore(Path(path).read_bytes())

    trainer.module.load_state_dict(params_from_flax(state['params']))
    trainer.optimizer.load_state_dict(_to_torch(state['optimizer']))
    trainer.step = int(state['step'])
    trainer.epoch = int(state['epoch'])
    trainer.generator.set_state(torch.frombuffer(bytearray(state['generator']), dtype=torch.uint8))
