"""The subset of msgpack that ``flax.serialization`` writes, without the
``msgpack`` package (counterpart of ``flax.serialization.msgpack_serialize``
and ``msgpack_restore``).

- Types: nil, bool, int, float (float64), str, bin, array and map in every
  width msgpack defines, and two ext types, 1 (ndarray) and 3 (numpy
  scalar), whose payload is itself msgpack ``[shape, dtype_name, raw
  C-order bytes]``. Any other ext type raises.
- Arrays decode to numpy arrays that view the buffer they were read from
  (no copy per leaf; writable when that buffer is, e.g. a ``bytearray``),
  except ``'bfloat16'``, which numpy lacks: those decode to
  ``torch.bfloat16`` tensors. The encoder takes numpy arrays and scalars
  and CPU torch tensors of any dtype, bfloat16 included.
- A leaf over ``MAX_CHUNK_SIZE`` bytes inside a map travels as flax's
  chunked form, ``{'__msgpack_chunked_array__': True, 'shape': {...},
  'chunks': {...}}``, and is rebuilt on restore.

Widths follow msgpack's own packer (the smallest that holds the value), so
``msgpack_serialize`` gives flax's bytes for the same tree.
"""

from __future__ import annotations

import struct
import warnings
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

NDARRAY, NPSCALAR = 1, 3
CHUNKED = '__msgpack_chunked_array__'
# flax's limit: msgpack holds at most 2**31 - 1 bytes in one object
MAX_CHUNK_SIZE = 2 ** 30


# --------------------------------------------------------------- encoding

def _header(write: Callable, n: int, fix: int, fix_max: int,
            wide: Tuple[int, ...]) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    the 8/16/32-bit codes in ``wide`` (0 where the width does not exist)
    that holds ``n``."""
    if fix is not None and n < fix_max:
        write(bytes([fix | n]))
        return
    for code, fmt, limit in zip(wide, ('>B', '>H', '>I'),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code and n < limit:
            write(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f'msgpack object of length {n} is too long')


def _pack_int(write: Callable, v: int) -> None:
    if 0 <= v < 0x80:
        write(bytes([v]))
    elif v >= 0:
        for code, fmt, limit in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                                 (0xce, '>I', 1 << 32),
                                 (0xcf, '>Q', 1 << 64)):
            if v < limit:
                write(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f'{v} does not fit msgpack uint64')
    elif v >= -32:
        write(struct.pack('>b', v))
    else:
        for code, fmt, bits in ((0xd0, '>b', 7), (0xd1, '>h', 15),
                                (0xd2, '>i', 31), (0xd3, '>q', 63)):
            if v >= -(1 << bits):
                write(bytes([code]) + struct.pack(fmt, v))
                return
        raise OverflowError(f'{v} does not fit msgpack int64')


def _array_parts(x) -> Tuple[Tuple[int, ...], str, memoryview]:
    """(shape, flax dtype name, raw C-order bytes) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw = t.reshape(-1).view(torch.int16).numpy()
            return tuple(t.shape), 'bfloat16', memoryview(raw).cast('B')
        x = t.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError(f'dtype {x.dtype} cannot be serialized')
    flat = np.ascontiguousarray(x).reshape(-1)   # 0-d arrays come back 1-d
    return x.shape, x.dtype.name, memoryview(flat).cast('B')


def _pack_ext(write: Callable, code: int, x) -> None:
    shape, name, raw = _array_parts(x)
    inner = bytearray()
    _header(inner.extend, 3, 0x90, 16, (0, 0xdc, 0xdd))
    _pack(inner.extend, list(shape))
    _pack(inner.extend, name)
    _header(inner.extend, raw.nbytes, None, 0, (0xc4, 0xc5, 0xc6))
    n = len(inner) + raw.nbytes
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        write(bytes([fixext[n], code]))
    else:
        _header(write, n, None, 0, (0xc7, 0xc8, 0xc9))
        write(bytes([code]))
    write(bytes(inner))
    write(raw)


def _pack(write: Callable, obj: Any) -> None:
    if obj is None:
        write(b'\xc0')
    elif obj is True or obj is False:
        write(b'\xc3' if obj else b'\xc2')
    elif type(obj) is int:
        _pack_int(write, obj)
    elif type(obj) is float:
        write(b'\xcb' + struct.pack('>d', obj))
    elif isinstance(obj, str):
        data = obj.encode('utf-8')
        _header(write, len(data), 0xa0, 32, (0xd9, 0xda, 0xdb))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast('B')
        _header(write, data.nbytes, None, 0, (0xc4, 0xc5, 0xc6))
        write(data)
    elif isinstance(obj, (list, tuple)):
        _header(write, len(obj), 0x90, 16, (0, 0xdc, 0xdd))
        for v in obj:
            _pack(write, v)
    elif isinstance(obj, dict):
        _header(write, len(obj), 0x80, 16, (0, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(write, k)
            _pack(write, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(write, NDARRAY, obj)
    elif isinstance(obj, np.generic):
        _pack_ext(write, NPSCALAR, np.asarray(obj))
    else:
        raise TypeError(f'cannot serialize {type(obj).__name__}')


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> Dict[str, Any]:
    """flax's ``_chunk``: the flattened leaf in pieces of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    itemsize = (x.element_size() if isinstance(x, torch.Tensor)
                else x.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED: True,
            'shape': {str(i): d for i, d in enumerate(x.shape)},
            'chunks': {str(i): flat[s:s + size] for i, s in
                       enumerate(range(0, n, size))}}


def _chunk_leaves(tree, chunk: bool = True):
    """A copy of the tree with every map's keys sorted (flax copies the tree
    with ``jax.tree_util.tree_map``, which sorts them) and each map's leaf
    over ``MAX_CHUNK_SIZE`` bytes chunked, as flax's
    ``_chunk_array_leaves_in_place`` does (it does not look into lists)."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(tree[k], chunk) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_chunk_leaves(v, False) for v in tree]
    if chunk and isinstance(tree, (np.ndarray, torch.Tensor)) \
            and _nbytes(tree) > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def packb(obj: Any) -> bytes:
    """``obj`` as msgpack bytes."""
    out = bytearray()
    _pack(out.extend, obj)
    return bytes(out)


def msgpack_serialize(tree: Any) -> bytes:
    """flax's ``msgpack_serialize``: ``tree`` with its large leaves chunked,
    as msgpack bytes."""
    return packb(_chunk_leaves(tree))


def write_msgpack(f, tree: Any) -> None:
    """``msgpack_serialize(tree)`` written to the binary file ``f`` piece by
    piece, without the whole blob in memory."""
    _pack(f.write, _chunk_leaves(tree))


# --------------------------------------------------------------- decoding

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast('B')
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > self.buf.nbytes:
            raise ValueError('truncated msgpack data')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        c = self.num('>B')
        if c < 0x80:
            return c
        if c >= 0xe0:
            return c - 0x100
        if 0x80 <= c <= 0x8f:
            return self.map(c & 0x0f)
        if 0x90 <= c <= 0x9f:
            return [self.read() for _ in range(c & 0x0f)]
        if 0xa0 <= c <= 0xbf:
            return str(self.take(c & 0x1f), 'utf-8')
        if c == 0xc0:
            return None
        if c in (0xc2, 0xc3):
            return c == 0xc3
        if c in (0xc4, 0xc5, 0xc6):
            return self.take(self.num('>' + 'BHI'[c - 0xc4]))
        if c in (0xc7, 0xc8, 0xc9):
            n = self.num('>' + 'BHI'[c - 0xc7])
            return self.ext(self.num('>b'), self.take(n))
        if c == 0xca:
            return self.num('>f')
        if c == 0xcb:
            return self.num('>d')
        if 0xcc <= c <= 0xcf:
            return self.num('>' + 'BHIQ'[c - 0xcc])
        if 0xd0 <= c <= 0xd3:
            return self.num('>' + 'bhiq'[c - 0xd0])
        if 0xd4 <= c <= 0xd8:
            code = self.num('>b')
            return self.ext(code, self.take(1 << (c - 0xd4)))
        if c in (0xd9, 0xda, 0xdb):
            return str(self.take(self.num('>' + 'BHI'[c - 0xd9])), 'utf-8')
        if c in (0xdc, 0xdd):
            n = self.num('>' + 'HI'[c - 0xdc])
            return [self.read() for _ in range(n)]
        if c in (0xde, 0xdf):
            return self.map(self.num('>' + 'HI'[c - 0xde]))
        raise ValueError(f'msgpack byte 0x{c:02x} is not a type code')

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, payload: memoryview):
        if code not in (NDARRAY, NPSCALAR):
            raise ValueError(f'msgpack ext type {code} is not one flax '
                             'checkpoints use (1 ndarray, 3 numpy scalar)')
        inner = _Reader(payload)
        shape, name, raw = inner.read()
        if not isinstance(raw, memoryview) or inner.pos != payload.nbytes:
            raise ValueError('malformed ndarray ext payload')
        arr = _from_buffer(raw, name, tuple(shape))
        return arr[()] if code == NPSCALAR and isinstance(
            arr, np.ndarray) else arr


def _from_buffer(raw: memoryview, name: str, shape: Tuple[int, ...]):
    if name == 'bfloat16':
        if raw.nbytes == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        with warnings.catch_warnings():      # a read-only buffer is fine:
            warnings.simplefilter('ignore')  # the caller owns the bytes
            return torch.frombuffer(raw, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Chunked leaves of a map tree rebuilt, as flax's
    ``_unchunk_array_leaves_in_place`` does."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
        chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data) -> Any:
    """The object msgpack ``data`` (bytes, bytearray or memoryview) holds;
    bin values are memoryviews of ``data``."""
    reader = _Reader(data)
    obj = reader.read()
    if reader.pos != reader.buf.nbytes:
        raise ValueError(f'{reader.buf.nbytes - reader.pos} bytes of extra '
                         'data after the msgpack object')
    return obj


def msgpack_restore(data) -> Any:
    """flax's ``msgpack_restore``: the tree in ``data``, chunked leaves
    rebuilt."""
    return _unchunk(unpackb(data))
