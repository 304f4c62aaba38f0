"""Zstandard frames in pure Python (RFC 8878), for the Orbax checkpoints
that tensorstore writes: a decoder of every frame zstd makes, and an
encoder of frames of raw (stored) blocks.

The port reads the JAX package's Orbax checkpoints on machines that have
neither ``zstandard`` nor libzstd, so it carries its own decoder, as it
carries its own msgpack codec. It covers raw, RLE and compressed blocks;
raw, RLE, Huffman-coded and treeless literals (one or four streams); FSE
sequences with predefined, RLE, compressed and repeated tables; repeat
offsets; skippable frames; and the optional XXH64 content checksum. It
takes no dictionary (tensorstore writes none). Compressed blocks decode
at a few MB/s of output, raw ones at memory speed; ``chip_smoke.py``
phase 13 measures the rate on tensorstore's chunks (``PERF.md``).
"""

from __future__ import annotations

import struct
from typing import List, Tuple

MAGIC = 0xFD2FB528
_MAX_BLOCK = 1 << 17

# ------------------------------------------------------------------ XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (the zstd content checksum keeps its
    low 32 bits)."""
    n, p = len(data), 0
    if n >= 32:
        v = [(_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64]
        lanes = struct.unpack_from(f'<{(n // 32) * 4}Q', data)
        for i in range(0, len(lanes), 4):
            v = [_round(v[j], lanes[i + j]) for j in range(4)]
        p = (n // 32) * 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from('<Q', data, p)
        h = (_rotl(h ^ _round(0, k), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from('<I', data, p)
        h = (_rotl(h ^ (k * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = (_rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


class ZstdError(ValueError):
    """A frame that is not valid zstd, or uses what this decoder lacks."""


# ------------------------------------------------------------- bit readers

class _Forward:
    """Little-endian bits read from the start (FSE table headers)."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.bit = data, pos * 8

    def read(self, n: int) -> int:
        byte, off = self.bit >> 3, self.bit & 7
        chunk = int.from_bytes(self.data[byte:byte + 4], 'little')
        self.bit += n
        return (chunk >> off) & ((1 << n) - 1)

    def byte_pos(self) -> int:
        return (self.bit + 7) >> 3


class _Backward:
    """A stream read from its end towards its start, as zstd writes Huffman
    and FSE bitstreams: the last byte's highest set bit marks the end.
    Bits before the start read as zeros; ``pos`` then goes negative."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError('bitstream without its end mark')
        self.value = int.from_bytes(data, 'little')
        self.pos = len(data) * 8 - 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        self.pos -= n
        if self.pos >= 0:
            return (self.value >> self.pos) & ((1 << n) - 1)
        return (self.value << -self.pos) & ((1 << n) - 1)


# -------------------------------------------------------------------- FSE

def _fse_header(data: bytes, pos: int, max_log: int, max_symbols: int
                ) -> Tuple[List[int], int, int]:
    """A table's normalized counts (RFC 8878 4.1.1); returns them, the
    accuracy log and the position after the header."""
    br = _Forward(data, pos)
    log = br.read(4) + 5
    if log > max_log:
        raise ZstdError(f'FSE accuracy log {log} > {max_log}')
    remaining, counts = (1 << log) + 1, []
    while remaining > 1 and len(counts) < max_symbols:
        bits = remaining.bit_length()
        low = br.read(bits - 1)
        threshold = (1 << bits) - 1 - remaining
        if low < threshold:
            val = low
        else:
            val = low | (br.read(1) << (bits - 1))
            if val >= (1 << (bits - 1)):
                val -= threshold
        prob = val - 1
        remaining -= abs(prob)
        counts.append(prob)
        if prob == 0:
            while True:
                rep = br.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 1 or len(counts) > max_symbols:
        raise ZstdError('corrupt FSE table header')
    return counts, log, br.byte_pos()


def _fse_table(counts: List[int], log: int):
    """Decoding table: per state (symbol, bits to read, baseline)."""
    size = 1 << log
    symbols = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbols[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError('corrupt FSE distribution')
    table = []
    for state in range(size):
        s = symbols[state]
        ns = nxt[s]
        nxt[s] += 1
        nb = log - (ns.bit_length() - 1)
        table.append((s, nb, (ns << nb) - size))
    return table, log


def _rle_table(symbol: int):
    return [(symbol, 0, 0)], 0


# predefined distributions (RFC 8878 3.1.1.3.2.2)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
                2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1] + [-1] * 4, 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]

# ---------------------------------------------------------------- Huffman


def _huffman_table(weights: List[int]):
    """Decoding table from the literal weights (the last weight implied):
    per ``max_bits``-bit state, (symbol, bits used)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError('empty Huffman weights')
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ZstdError('corrupt Huffman weights')
    weights = weights + [rest.bit_length()]
    if max_bits > 11:
        raise ZstdError(f'Huffman codes of {max_bits} bits')
    bits = [max_bits + 1 - w if w else 0 for w in weights]
    count = [0] * (max_bits + 1)
    for b in bits:
        if b:
            count[b] += 1
    start, idx = [0] * (max_bits + 2), 0
    for b in range(max_bits, 0, -1):
        start[b] = idx
        idx += count[b] << (max_bits - b)
    table = [None] * (1 << max_bits)
    for s, b in enumerate(bits):
        if b:
            span = 1 << (max_bits - b)
            table[start[b]:start[b] + span] = [(s, b)] * span
            start[b] += span
    return table, max_bits


def _huffman_weights(data: bytes, pos: int) -> Tuple[List[int], int]:
    head = data[pos]
    pos += 1
    if head >= 128:                                  # 4 bits a weight
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], pos + (n + 1) // 2
    # FSE-compressed weights: two interleaved states
    counts, log, hpos = _fse_header(data, pos, 6, 256)
    table, _ = _fse_table(counts, log)
    br = _Backward(data[hpos:pos + head])
    s1, s2 = br.read(log), br.read(log)
    weights = []
    while True:
        sym, nb, base = table[s1]
        weights.append(sym)
        s1 = base + br.read(nb)
        if br.pos < 0:
            weights.append(table[s2][0])
            break
        sym, nb, base = table[s2]
        weights.append(sym)
        s2 = base + br.read(nb)
        if br.pos < 0:
            weights.append(table[s1][0])
            break
    if len(weights) > 255:
        raise ZstdError('too many Huffman weights')
    return weights, pos + head


def _huffman_stream(data: bytes, table, max_bits: int, n: int) -> bytes:
    br = _Backward(data)
    value, pos = br.value, br.pos
    mask = (1 << max_bits) - 1
    out = bytearray(n)
    if pos < max_bits:
        state = (value << (max_bits - pos)) & mask
    else:
        state = (value >> (pos - max_bits)) & mask
    pos -= max_bits
    # the stream a window at a time: bits [lo, lo + 64 * 8) of value
    lo, win = None, 0
    for i in range(n):
        sym, nb = table[state]
        out[i] = sym
        pos -= nb
        if pos >= 0:
            if lo is None or pos < lo:
                lo = max(pos - 4000, 0)
                win = (value >> lo) & ((1 << 4096) - 1)
            bits = (win >> (pos - lo)) & ((1 << nb) - 1)
        else:
            bits = (value << -pos) & ((1 << nb) - 1)
        state = ((state << nb) & mask) | bits
    if pos != -max_bits:
        raise ZstdError('Huffman stream not consumed exactly')
    return bytes(out)


# ----------------------------------------------------------------- frames

class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {'ll': None, 'of': None, 'ml': None}
        self.rep = [1, 4, 8]


def _literals(data: bytes, pos: int, st: _FrameState) -> Tuple[bytes, int]:
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = b0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (b0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12)
            pos += 3
        if kind == 0:
            return data[pos:pos + size], pos + size
        return bytes([data[pos]]) * size, pos + 1
    hsize = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    head = int.from_bytes(data[pos:pos + hsize], 'little')
    bits = {3: 10, 4: 14, 5: 18}[hsize]
    regen = (head >> 4) & ((1 << bits) - 1)
    comp = (head >> (4 + bits)) & ((1 << bits) - 1)
    pos += hsize
    end = pos + comp
    if kind == 2:
        weights, pos = _huffman_weights(data, pos)
        st.huffman = _huffman_table(weights)
    elif st.huffman is None:
        raise ZstdError('treeless literals without a previous table')
    table, max_bits = st.huffman
    if fmt == 0:
        return _huffman_stream(data[pos:end], table, max_bits, regen), end
    sizes = struct.unpack_from('<3H', data, pos)
    pos += 6
    each = (regen + 3) // 4
    out = []
    for i in range(4):
        size = sizes[i] if i < 3 else end - pos
        out.append(_huffman_stream(data[pos:pos + size], table, max_bits,
                                   each if i < 3 else regen - 3 * each))
        pos += size
    return b''.join(out), end


def _table(mode: int, data: bytes, pos: int, kind: str, st: _FrameState):
    default, max_log, max_sym = {
        'll': (_LL_DEFAULT, 9, 36), 'of': (_OF_DEFAULT, 8, 32),
        'ml': (_ML_DEFAULT, 9, 53)}[kind]
    if mode == 0:
        st.tables[kind] = _fse_table(*default)
    elif mode == 1:
        st.tables[kind] = _rle_table(data[pos])
        pos += 1
    elif mode == 2:
        counts, log, pos = _fse_header(data, pos, max_log, max_sym)
        st.tables[kind] = _fse_table(counts, log)
    elif st.tables[kind] is None:
        raise ZstdError(f'repeated {kind} table without a previous one')
    return pos


def _block(data: bytes, pos: int, end: int, out: bytearray,
           st: _FrameState) -> None:
    lits, pos = _literals(data, pos, st)
    n = data[pos]
    if n == 0:
        out += lits
        return
    if n < 128:
        pos += 1
    elif n < 255:
        n, pos = ((n - 128) << 8) + data[pos + 1], pos + 2
    else:
        n, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    for kind, shift in (('ll', 6), ('of', 4), ('ml', 2)):
        pos = _table((modes >> shift) & 3, data, pos, kind, st)
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = (
        st.tables['ll'], st.tables['of'], st.tables['ml'])
    br = _Backward(data[pos:end])
    ll_s, of_s, ml_s = br.read(ll_log), br.read(of_log), br.read(ml_log)
    rep, lit_pos = st.rep, 0
    for i in range(n):
        of_code, of_nb, of_base = of_t[of_s]
        ml_code, ml_nb, ml_base = ml_t[ml_s]
        ll_code, ll_nb, ll_base = ll_t[ll_s]
        if of_code > 31:
            raise ZstdError(f'offset code {of_code}')
        ofv = (1 << of_code) + br.read(of_code)
        ml = _ML_BASE[ml_code] + br.read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + br.read(_LL_BITS[ll_code])
        if ofv > 3:
            off = ofv - 3
            rep[:] = [off, rep[0], rep[1]]
        else:
            idx = ofv - 1 + (ll == 0)
            if idx == 0:
                off = rep[0]
            else:
                off = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = off
        if i + 1 < n:
            ll_s = ll_base + br.read(ll_nb)
            ml_s = ml_base + br.read(ml_nb)
            of_s = of_base + br.read(of_nb)
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        if off == 0 or off > len(out):
            raise ZstdError(f'match offset {off} beyond the output')
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            chunk = bytes(out[start:])
            out += (chunk * (ml // off + 1))[:ml]
    if br.pos != 0:
        raise ZstdError('sequence bitstream not consumed exactly')
    out += lits[lit_pos:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = (fhd >> 6, (fhd >> 5) & 1,
                                             (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        raise ZstdError('reserved frame header bit set')
    if not single:
        pos += 1                                     # window descriptor
    dict_size = (0, 1, 2, 4)[dict_flag]
    if dict_size and int.from_bytes(data[pos:pos + dict_size], 'little'):
        raise ZstdError('frames with a dictionary are not read')
    pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    size = int.from_bytes(data[pos:pos + fcs_size], 'little') \
        + (256 if fcs_size == 2 else 0) if fcs_size else None
    pos += fcs_size
    start, st = len(out), _FrameState()
    while True:
        head = int.from_bytes(data[pos:pos + 3], 'little')
        pos += 3
        last, kind, bsize = head & 1, (head >> 1) & 3, head >> 3
        if kind == 0:
            if pos + bsize > len(data):
                raise ZstdError('truncated raw block')
            out += data[pos:pos + bsize]
            pos += bsize
        elif kind == 1:
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif kind == 2:
            if bsize > _MAX_BLOCK or pos + bsize > len(data):
                raise ZstdError('bad compressed block size')
            _block(data, pos, pos + bsize, out, st)
            pos += bsize
        else:
            raise ZstdError('reserved block type')
        if last:
            break
    if size is not None and len(out) - start != size:
        raise ZstdError(f'frame content {len(out) - start} bytes, header '
                        f'says {size}')
    if checksum:
        (want,) = struct.unpack_from('<I', data, pos)
        if xxh64(bytes(out[start:])) & 0xFFFFFFFF != want:
            raise ZstdError('content checksum mismatch')
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """The content of one or more zstd frames (skippable frames skipped)."""
    data = bytes(data)
    out, pos = bytearray(), 0
    while pos < len(data):
        if len(data) - pos < 4:
            raise ZstdError('trailing bytes after the last frame')
        (magic,) = struct.unpack_from('<I', data, pos)
        pos += 4
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            (size,) = struct.unpack_from('<I', data, pos)
            pos += 4 + size
        elif magic == MAGIC:
            pos = _frame(data, pos, out)
        else:
            raise ZstdError(f'not a zstd frame (magic {magic:#x})')
    return bytes(out)


def compress_raw(data: bytes) -> bytes:
    """One zstd frame holding ``data`` in raw blocks of at most 128 KiB,
    its size in the header, no checksum: what any zstd decoder reads, at
    no cost to compute."""
    data = memoryview(bytes(data))
    parts = [struct.pack('<IBQ', MAGIC, 0xE0, len(data))]  # single segment
    n = len(data)
    for pos in range(0, max(n, 1), _MAX_BLOCK):
        size = min(_MAX_BLOCK, n - pos)
        last = pos + _MAX_BLOCK >= n
        parts.append((size << 3 | int(last)).to_bytes(3, 'little'))
        parts.append(data[pos:pos + size])
    return b''.join(parts)




