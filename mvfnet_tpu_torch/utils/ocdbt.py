"""A reader of tensorstore's OCDBT key-value store, as orbax writes its
checkpoints with it (``"use_ocdbt": true``), in pure Python.

An OCDBT database is a directory with a ``manifest.ocdbt`` and data files
under ``d/`` (or a process's ``ocdbt.process_<i>/d/``, which the root
database's entries point into). The manifest holds the store's config and
its latest versions, each with the location of a B-tree's root node; the
nodes and the values too large to keep inline in a leaf lie in the data
files at (file, offset, length). Every manifest and node is a header
(magic ``0c db 3a 2a`` for a manifest, ``0c db 20 de`` for a node, the file
length as uint64 LE, varint format version 0 and compression 0 or 1 =
zstd), a body (zstd-compressed where the header says so) and a crc32c of
all that comes before it, uint32 LE, which is checked. Integers in bodies
are LEB128 varints; arrays are stored column by column; keys are
prefix-compressed against the previous key, and an interior node's entry
names how many bytes of its key every key of its subtree shares, which the
child's keys then leave out.

The port writes orbax's other layout, one file a key
(``orbax_io.save_pytree``), so this module only reads.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1


class OcdbtError(ValueError):
    """A store that is not OCDBT as tensorstore writes it, or is damaged."""


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore checks its manifests and
    nodes."""
    crc, table = 0xFFFFFFFF, _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise OcdbtError('varint runs past the end')
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            shift += 7
            if b < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.pos += 1
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise OcdbtError('field runs past the end')
        self.pos += n
        return self.data[self.pos - n:self.pos]


def decode_file(data: bytes, magic: int) -> bytes:
    """The body of one manifest or node, its header, length and crc32c
    checked, decompressed."""
    if len(data) < 16 or struct.unpack_from('>I', data)[0] != magic:
        kind = 'manifest' if magic == MANIFEST_MAGIC else 'node'
        raise OcdbtError(f'not an OCDBT {kind}')
    (length,) = struct.unpack_from('<Q', data, 4)
    if length != len(data):
        raise OcdbtError(f'length field {length}, {len(data)} bytes')
    (want,) = struct.unpack_from('<I', data, len(data) - 4)
    if crc32c(data[:-4]) != want:
        raise OcdbtError('crc32c mismatch')
    r = _Reader(data[:-4])
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f'format version {version}')
    body = data[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise OcdbtError(f'compression format {compression}')
    return body


def _data_files(r: _Reader) -> List[str]:
    """A data file table: paths relative to the database's directory, each
    prefix-compressed against the one before and split into a base path
    and a relative path."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                                      # base path lengths
    paths, prev = [], b''
    for i in range(n):
        full = prev[:prefix[i]] + r.raw(suffix[i])
        paths.append(full.decode())
        prev = full
    return paths


def _keys(r: _Reader, n: int, interior: bool
          ) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b''
    for i in range(n):
        key = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


class Store:
    """One OCDBT database directory, read at its latest version: ``keys()``
    and ``get(key)``."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, 'manifest.ocdbt'), 'rb') as f:
            r = _Reader(decode_file(f.read(), MANIFEST_MAGIC))
        r.raw(16)                                          # uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f'manifest kind {kind} (only "single" is read)')
        r.varint()                                         # max inline bytes
        r.varint()                                         # max node bytes
        r.byte()                                           # version tree arity
        compression = r.varint()
        if compression == 1:
            r.varints(4)          # zstd: the level, then three fields of 0
        elif compression != 0:
            raise OcdbtError(f'compression method {compression}')
        files = _data_files(r)
        n = r.varint()
        self.entries: Dict[bytes, Tuple] = {}
        if n == 0:
            return
        gens = r.varints(n)
        heights = [r.byte() for _ in range(n)]
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        latest = max(range(n), key=gens.__getitem__)
        if offsets[latest] != _NO_ROOT:
            self._walk(files[fids[latest]], offsets[latest], lengths[latest],
                       heights[latest], b'')

    def _read(self, rel: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.path, rel), 'rb') as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise OcdbtError(f'{rel}: {length} bytes at {offset} past its end')
        return data

    def _walk(self, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        r = _Reader(decode_file(self._read(rel, offset, length), NODE_MAGIC))
        if r.byte() != height:
            raise OcdbtError(f'{rel}@{offset}: node height is not {height}')
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)                               # statistics
            for i in range(n):
                self._walk(files[fids[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        sizes, kinds = r.varints(n), r.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise OcdbtError(f'value kinds {sorted(set(kinds))}')
        fids = r.varints(len(indirect))
        offs = r.varints(len(indirect))
        where = dict(zip(indirect, zip(fids, offs)))
        for i in range(n):
            if i in where:
                fid, off = where[i]
                self.entries[prefix + keys[i]] = (files[fid], off, sizes[i])
            else:
                self.entries[prefix + keys[i]] = r.raw(sizes[i])

    def keys(self) -> List[str]:
        return sorted(k.decode() for k in self.entries)

    def get(self, key: str) -> Optional[bytes]:
        """The value stored under ``key``, or None."""
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return self._read(*v)
