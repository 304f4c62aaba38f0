"""The native batch JPEG decode worker on the GPU: nvJPEG through ctypes
(counterpart of ``mvfnet_tpu/data/native_io.py``).

The JAX package decodes a clip's JPEGs in one call to its C++ worker
(``native/jpeg_decoder.cpp``: libjpeg on a thread pool). Here one call to
``csrc/nvjpeg_decode.cu`` decodes them with nvJPEG's batched API on a CUDA
stream into their Y, Cb and Cr planes, turns them into BGR with one launch
of the ``ycc_to_bgr`` kernel (libjpeg's chroma upsampling and colour
conversion, so that frames agree with cv2's), then copies them to the
host once: HWC
uint8 BGR, full size, as cv2 and the JAX worker give them.
``FrameSelector`` uses it when its dataset is built for a CUDA device; on
the CPU frames decode with ``cv2.imdecode``, the plain version of the
whole worker. ``ycc_to_bgr_batch`` runs the kernel alone on planes on the
card, ``ycc_to_bgr_batch_plain`` and ``ycc_to_bgr_plain`` are its plain
versions.

The header probe parses the JPEG's SOF segment in Python, as libjpeg's
``jpeg_read_header`` reads it, so that every buffer is sized before the
batch. Video containers are not decoded here: the JAX worker's FFmpeg
decoder (``native/video_decoder.cpp``) has no counterpart, and the port's
video decoders stay on cv2 (``video_io.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import tracing

# what this worker is, in the pipeline's ``decoder`` names
DECODER = 'nvjpeg'

# nvjpegStatus_t values that say the image itself is at fault:
# NVJPEG_STATUS_BAD_JPEG, _JPEG_NOT_SUPPORTED (a kind nvJPEG or ycc_to_bgr
# does not decode) and _INCOMPLETE_BITSTREAM; such a frame goes to cv2.
# Any other status, and every CUDA error, raises.
BITSTREAM_STATUS = frozenset((3, 4, 10))

_P = ctypes.c_void_p
_INT_P = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    'mvf_nvjpeg_version': ([_INT_P, _INT_P, _INT_P], ctypes.c_int),
    'mvf_nvjpeg_backend_status': ([ctypes.c_int, ctypes.c_int],
                                  ctypes.c_int),
    'mvf_nvjpeg_create': ([ctypes.c_int, ctypes.POINTER(_P), ctypes.c_char_p,
                           ctypes.c_int], ctypes.c_int),
    'mvf_nvjpeg_destroy': ([_P], None),
    'mvf_nvjpeg_decode_batch': (
        [_P, ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_size_t),
         ctypes.c_int, ctypes.POINTER(_P), _INT_P, _INT_P, _INT_P, _INT_P,
         _INT_P, ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    'mvf_nvjpeg_decode': ([_P, _P, ctypes.c_size_t, _P, ctypes.c_int,
                           ctypes.c_int, _INT_P, _INT_P, ctypes.c_char_p,
                           ctypes.c_int], ctypes.c_int),
    'mvf_nvjpeg_last_planes': ([_P, ctypes.c_int, _P, _P, _P, _INT_P, _INT_P,
                                ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
    'mvf_ycc_frame_bytes': ([], ctypes.c_int),
    'mvf_ycc_table': ([ctypes.c_int] + [ctypes.POINTER(_P)] * 4
                      + [_INT_P] * 4 + [_P], ctypes.c_int),
    'mvf_ycc_launch': ([_P, ctypes.c_int, ctypes.c_int, _P], ctypes.c_int),
}

# SOF markers libjpeg decodes: baseline, extended, progressive, and the
# arithmetic-coded sequential and progressive ones
_SOF = {0xC0, 0xC1, 0xC2, 0xC9, 0xCA}
# markers without a length: TEM and RST0-7
_STANDALONE = {0x01} | set(range(0xD0, 0xD8))


def parse_header(data: bytes) -> Optional[Tuple[int, int, int]]:
    """``(height, width, components)`` from a JPEG's frame header, or None
    where libjpeg's ``jpeg_read_header`` fails: no SOI at the start, a
    segment that runs past the end, EOI or the end before the first SOS, an
    SOS before the SOF or a second SOF, an SOF libjpeg does not decode, or
    one with a bad length, an empty image, more than 10 components, a
    precision other than 8 bits or sampling factors outside 1-4, an SOS
    with a bad length or component count, or naming a component the SOF
    does not. Bytes between segments (and stuffed ``FF 00`` pairs) are
    skipped, as libjpeg skips them with a warning; like libjpeg, the SOS
    needs only its bytes up to the last component's id."""
    n = len(data)
    if n < 4 or data[0] != 0xFF or data[1] != 0xD8:
        return None
    pos, sof, ids = 2, None, b''
    while True:
        while pos < n and data[pos] != 0xFF:     # extraneous bytes
            pos += 1
        while pos < n and data[pos] == 0xFF:     # fill bytes
            pos += 1
        if pos >= n:
            return None
        marker = data[pos]
        pos += 1
        if marker == 0x00 or marker in _STANDALONE:
            continue
        if marker == 0xD9 or pos + 2 > n:        # EOI, or cut in a length
            return None
        length = (data[pos] << 8) | data[pos + 1]
        if marker == 0xDA:                       # SOS: the header is read
            if sof is None or pos + 3 > n:
                return None
            ns = data[pos + 2]
            if not 1 <= ns <= 4 or length != 6 + 2 * ns \
                    or pos + 2 + 2 * ns > n:
                return None
            if any(c not in ids for c in data[pos + 3:pos + 3 + 2 * ns:2]):
                return None
            return sof
        if length < 2 or pos + length > n:
            return None
        seg = data[pos + 2:pos + length]
        pos += length
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            if sof is not None or marker not in _SOF or len(seg) < 6:
                return None
            prec, h, w, nc = (seg[0], (seg[1] << 8) | seg[2],
                              (seg[3] << 8) | seg[4], seg[5])
            if prec != 8 or h == 0 or w == 0 or not 1 <= nc <= 10 \
                    or len(seg) != 6 + 3 * nc:
                return None
            if any(not (1 <= f >> 4 <= 4 and 1 <= f & 15 <= 4)
                   for f in seg[7:6 + 3 * nc:3]):
                return None
            sof, ids = (h, w, nc), seg[6:6 + 3 * nc:3]


def _read(path: str) -> Optional[bytes]:
    try:
        with open(path, 'rb') as f:
            return f.read()
    except OSError:
        return None


def probe(path: str) -> Optional[Tuple[int, int, int]]:
    """``(height, width, 3)`` of a JPEG file (decoded frames always have 3
    channels), or None for a missing file or one libjpeg's header reader
    refuses (the JAX worker's ``mvf_jpeg_probe``)."""
    data = _read(path)
    shape = parse_header(data) if data is not None else None
    return None if shape is None else (shape[0], shape[1], 3)


def library() -> ctypes.CDLL:
    """The worker's library, built from ``csrc/nvjpeg_decode.cu`` (linked
    with nvJPEG) on first use."""
    from ..ops import _cuda
    return _cuda.library('nvjpeg_decode', _SIGNATURES)


def nvjpeg_version() -> Tuple[int, int, int]:
    """nvJPEG's (major, minor, patch), from the library the worker links."""
    v = [ctypes.c_int() for _ in range(3)]
    if library().mvf_nvjpeg_version(*map(ctypes.byref, v)) != 0:
        raise RuntimeError('nvjpegGetProperty failed')
    return tuple(x.value for x in v)


def _fancy(hf: int, vf: int, cw: int) -> bool:
    """libjpeg-turbo's choice of upsampler (``jinit_upsampler``): fancy for
    2x1 and 2x2 chroma more than 2 samples wide, and for 1x2; box
    replication otherwise."""
    return (hf == 2 and vf <= 2 and cw > 2) or (hf == 1 and vf == 2)


def ycc_to_bgr_plain(y: torch.Tensor, cb: Optional[torch.Tensor] = None,
                     cr: Optional[torch.Tensor] = None, hf: int = 1,
                     vf: int = 1) -> torch.Tensor:
    """BGR uint8 (h, w, 3) from a decoded JPEG's planes as libjpeg makes it
    (the ``ycc_to_bgr`` kernel's plain version): ``y`` (h, w) uint8, and
    ``cb``, ``cr`` (ceil(h / vf), ceil(w / hf)) or None for grayscale.
    Chroma is upsampled by libjpeg-turbo's fancy (triangle) filter for 2x2,
    2x1 and 1x2 (3/4 of the nearer sample and 1/4 of the further, with its
    rounding biases, edge samples repeated), by box replication otherwise;
    then libjpeg's 16-bit fixed-point YCbCr to BGR, clamped."""
    h, w = y.shape
    if cb is None:
        return y[..., None].expand(h, w, 3).contiguous()
    ch, cw = cb.shape
    ys = torch.arange(h, device=y.device)
    xs = torch.arange(w, device=y.device)
    odd_x, odd_y = xs & 1, ys & 1
    c = xs >> 1
    c2 = torch.where(odd_x == 1, (c + 1).clamp(max=cw - 1),
                     (c - 1).clamp(min=0))

    def up(p):
        p = p.to(torch.int32)
        if not _fancy(hf, vf, cw):
            return p[(ys // vf)[:, None], (xs // hf)[None, :]]
        if vf == 2:
            k = ys >> 1
            nb = torch.where(odd_y == 1, (k + 1).clamp(max=ch - 1),
                             (k - 1).clamp(min=0))
            if hf == 1:
                return (3 * p[k] + p[nb] + 1 + odd_y[:, None]) >> 2
            cs = 3 * p[k] + p[nb]
            return (3 * cs[:, c] + cs[:, c2] + 8 - odd_x) >> 4
        return (3 * p[:, c] + p[:, c2] + 1 + odd_x) >> 2

    yy = y.to(torch.int32)
    u, v = up(cb) - 128, up(cr) - 128
    bgr = torch.stack([yy + ((116130 * u + 32768) >> 16),
                       yy + ((-22554 * u + 32768 - 46802 * v) >> 16),
                       yy + ((91881 * v + 32768) >> 16)], -1)
    return bgr.clamp(0, 255).to(torch.uint8)


def ycc_to_bgr_batch_plain(frames: Sequence[Tuple]) -> List[torch.Tensor]:
    """``ycc_to_bgr_batch``'s plain version: ``ycc_to_bgr_plain`` on each
    ``(y, cb, cr, hf, vf)`` of ``frames``."""
    return [ycc_to_bgr_plain(*f) for f in frames]


_count_lock = threading.Lock()


def _count(launches: int, frames: int) -> None:
    with _count_lock:
        ycc_to_bgr.launches += launches
        ycc_to_bgr.frames += frames


def frame_table(lib: ctypes.CDLL, frames: Sequence[Tuple],
                outs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, int]:
    """The kernel's table of ``frames`` (``(y, cb, cr, hf, vf)`` on the
    card, ``cb`` and ``cr`` None for grayscale) into ``outs``, as
    ``mvf_ycc_table`` lays it out, in a uint8 CPU tensor, and the launch's
    tiles."""
    n = len(frames)

    def ptrs(ts):
        return (_P * n)(*[None if t is None else t.data_ptr() for t in ts])

    def ints(xs):
        return (ctypes.c_int * n)(*xs)
    table = torch.empty(n * lib.mvf_ycc_frame_bytes(), dtype=torch.uint8)
    tiles = lib.mvf_ycc_table(
        n, ptrs([f[0] for f in frames]), ptrs([f[1] for f in frames]),
        ptrs([f[2] for f in frames]), ptrs(outs),
        ints([f[0].shape[0] for f in frames]),
        ints([f[0].shape[1] for f in frames]),
        ints([f[3] for f in frames]), ints([f[4] for f in frames]),
        table.data_ptr())
    if tiles < 0:
        raise ValueError('ycc_to_bgr: a subsampling the kernel does not take '
                         f'in {[f[3:] for f in frames]}')
    return table, tiles


def _check_planes(y, cb, cr, hf, vf) -> None:
    h, w = y.shape
    if cb is not None:
        if tuple(cb.shape) != (-(-h // vf), -(-w // hf)) \
                or cr is None or cr.shape != cb.shape:
            raise ValueError(f'chroma planes {tuple(cb.shape)} and '
                             f'{None if cr is None else tuple(cr.shape)} '
                             f'for ({h}, {w}) at {hf}x{vf}')
    for p in (y, cb, cr):
        if p is not None and (p.dtype != torch.uint8 or p.device != y.device
                              or not p.is_contiguous()):
            raise ValueError('ycc_to_bgr takes contiguous uint8 planes on '
                             'one device')


def ycc_to_bgr_batch(frames: Sequence[Tuple]) -> List[torch.Tensor]:
    """``ycc_to_bgr_batch_plain``'s function: BGR (h, w, 3) uint8 of each
    ``(y, cb, cr, hf, vf)`` of ``frames`` (any mix of sizes, subsamplings
    and grayscale, ``cb`` and ``cr`` None). On CUDA tensors one launch of
    the ``ycc_to_bgr`` kernel of ``csrc/nvjpeg_decode.cu`` over all of them
    (on the current stream), on CPU tensors the plain version.
    ``ycc_to_bgr.launches`` counts the kernel's launches and
    ``ycc_to_bgr.frames`` the frames they convert, here and inside the
    decoder's calls."""
    frames = [tuple(f) for f in frames]
    if not frames:
        return []
    device = frames[0][0].device
    if device.type == 'cpu':
        return ycc_to_bgr_batch_plain(frames)
    for f in frames:
        if f[0].device != device:
            raise ValueError('ycc_to_bgr_batch takes frames on one device')
        _check_planes(*f)
    outs = [torch.empty(f[0].shape + (3,), dtype=torch.uint8, device=device)
            for f in frames]
    from ..ops import _cuda
    lib = library()
    table, tiles = frame_table(lib, frames, outs)
    # pinned, so that the copy queues on the stream like the launch
    table = table.pin_memory().to(device, non_blocking=True)
    err = lib.mvf_ycc_launch(table.data_ptr(), len(frames), tiles,
                             torch.cuda.current_stream(device).cuda_stream)
    _cuda.check(err, 'ycc_to_bgr')
    _count(1, len(frames))
    return outs


def ycc_to_bgr(y: torch.Tensor, cb: Optional[torch.Tensor] = None,
               cr: Optional[torch.Tensor] = None, hf: int = 1,
               vf: int = 1) -> torch.Tensor:
    """``ycc_to_bgr_plain``'s function on one frame: ``ycc_to_bgr_batch``
    of it (on CUDA tensors one launch of the kernel, on CPU tensors the
    plain version)."""
    return ycc_to_bgr_batch([(y, cb, cr, hf, vf)])[0]


ycc_to_bgr.launches = 0
ycc_to_bgr.frames = 0


class NvjpegError(RuntimeError):
    """nvJPEG or the CUDA runtime failed for another reason than the
    image's own bitstream."""


class _Pool:
    """The decode contexts of one card, each serving one thread at a time
    (an nvJPEG handle, its JPEG states, a stream, and device and pinned
    buffers kept at their largest size): made when every one is busy, and
    kept for the process."""

    def __init__(self, lib: ctypes.CDLL, index: int):
        self.lib, self.index = lib, index
        self.free: List[ctypes.c_void_p] = []
        self.lock = threading.Lock()

    def _create(self) -> ctypes.c_void_p:
        ctx, msg = ctypes.c_void_p(), ctypes.create_string_buffer(256)
        rc = self.lib.mvf_nvjpeg_create(self.index, ctypes.byref(ctx), msg,
                                        len(msg))
        if rc != 0:
            self.lib.mvf_nvjpeg_destroy(ctx)
            raise NvjpegError(f'nvJPEG context on cuda:{self.index}: '
                              f'{msg.value.decode()}')
        return ctx

    @contextlib.contextmanager
    def context(self) -> Iterator[ctypes.c_void_p]:
        with self.lock:
            ctx = self.free.pop() if self.free else None
        if ctx is None:
            ctx = self._create()
        try:
            yield ctx
        finally:
            with self.lock:
                self.free.append(ctx)


_pools: Dict[int, _Pool] = {}
_pools_lock = threading.Lock()


def _pool(index: int) -> _Pool:
    with _pools_lock:
        if index not in _pools:
            _pools[index] = _Pool(library(), index)
        return _pools[index]


class NativeImageLoader:
    """Per-image and batch JPEG decoding with nvJPEG on a CUDA ``device``
    (the JAX package's ``NativeImageLoader``): ``load`` and ``load_batch``
    return HWC uint8 BGR arrays, or None where an image's bitstream is bad
    or of a kind nvJPEG refuses, or a file is missing or not a JPEG.
    Anything else that fails (the build, CUDA, nvJPEG) raises
    ``NvjpegError``. At most ``num_threads`` threads decode through one
    loader at once (by default the JAX worker's ``min(cores, 8)``), each
    with a context of its own. Each call that decodes launches the
    ``ycc_to_bgr`` kernel once (``ycc_to_bgr.launches``). With tracing on,
    ``decode.read`` spans the file reads and header parses and
    ``decode.nvjpeg`` the library call (``frames``, JPEG ``bytes``)."""

    def __init__(self, device, num_threads: Optional[int] = None):
        device = torch.device(device)
        if device.type != 'cuda':
            raise ValueError(f'nvJPEG decodes on a CUDA device, not '
                             f'{device}; the CPU decodes with cv2.imdecode')
        if not torch.cuda.is_available():
            raise NvjpegError(f'nvJPEG on {device}: no CUDA device '
                              f'(torch.cuda.is_available() is False)')
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        self.num_threads = num_threads or min(os.cpu_count() or 1, 8)
        self._slots = threading.BoundedSemaphore(self.num_threads)
        self._pool = _pool(self.index)     # builds the library, or raises

    def probe(self, path: str) -> Optional[Tuple[int, int, int]]:
        return probe(path)

    def _raise_unless_bitstream(self, rc: int, msg) -> None:
        if rc not in BITSTREAM_STATUS:
            kind = ('nvjpegStatus_t' if rc > 0 else '-cudaError_t')
            raise NvjpegError(f'nvJPEG decode on cuda:{self.index}: '
                              f'{msg.value.decode()} ({kind})')

    def load(self, path: str) -> Optional[np.ndarray]:
        """One JPEG through nvJPEG's single-image API."""
        with tracing.span('decode.read'):
            data = _read(path)
            shape = parse_header(data) if data is not None else None
        if shape is None:
            return None
        h, w, _ = shape
        out = np.empty((h, w, 3), np.uint8)
        buf = np.frombuffer(data, np.uint8)
        msg = ctypes.create_string_buffer(256)
        launches, frames = ctypes.c_int(), ctypes.c_int()
        with self._slots, self._pool.context() as ctx, \
                tracing.span('decode.nvjpeg', frames=1, bytes=len(data)):
            rc = self._pool.lib.mvf_nvjpeg_decode(
                ctx, buf.ctypes.data, len(data), out.ctypes.data, h, w,
                ctypes.byref(launches), ctypes.byref(frames), msg, len(msg))
        _count(launches.value, frames.value)
        if rc != 0:
            self._raise_unless_bitstream(rc, msg)
            return None
        return out

    def load_batch(self, paths: Sequence[str]) -> Optional[List[np.ndarray]]:
        """A clip's JPEGs in one batched nvJPEG call; None if any file does
        not probe or any image's bitstream fails (the caller then goes
        frame by frame)."""
        return self._load_batch(paths, planes=False)

    def load_batch_planes(self, paths: Sequence[str]):
        """``load_batch``'s frames, and each frame's decoded planes as the
        ``ycc_to_bgr`` kernel read them, ``(y, cb, cr, hf, vf)`` uint8
        arrays (``cb``, ``cr`` None for grayscale), for checks of the
        kernel against its plain version; None where ``load_batch`` gives
        None."""
        return self._load_batch(paths, planes=True)

    def _planes(self, ctx, i: int, h: int, w: int) -> Tuple:
        y, cb, cr = (np.empty(h * w, np.uint8) for _ in range(3))
        hf, vf = ctypes.c_int(), ctypes.c_int()
        msg = ctypes.create_string_buffer(256)
        rc = self._pool.lib.mvf_nvjpeg_last_planes(
            ctx, i, y.ctypes.data, cb.ctypes.data, cr.ctypes.data,
            ctypes.byref(hf), ctypes.byref(vf), msg, len(msg))
        if rc != 0:
            raise NvjpegError(f'nvJPEG planes on cuda:{self.index}: '
                              f'{msg.value.decode()}')
        if hf.value == 0:
            return y.reshape(h, w), None, None, 1, 1
        ch, cw = -(-h // vf.value), -(-w // hf.value)
        return (y.reshape(h, w), cb[:ch * cw].reshape(ch, cw),
                cr[:ch * cw].reshape(ch, cw), hf.value, vf.value)

    def _load_batch(self, paths: Sequence[str], planes: bool):
        with tracing.span('decode.read'):
            datas = [_read(p) for p in paths]
            shapes = [parse_header(d) if d is not None else None
                      for d in datas]
        if not paths or any(s is None for s in shapes):
            return None
        n = len(paths)
        outs = [np.empty((h, w, 3), np.uint8) for h, w, _ in shapes]
        bufs = [np.frombuffer(d, np.uint8) for d in datas]
        c_datas = (_P * n)(*[b.ctypes.data for b in bufs])
        lens = [len(d) for d in datas]
        c_lens = (ctypes.c_size_t * n)(*lens)
        c_outs = (_P * n)(*[o.ctypes.data for o in outs])
        c_hs = (ctypes.c_int * n)(*[s[0] for s in shapes])
        c_ws = (ctypes.c_int * n)(*[s[1] for s in shapes])
        status = (ctypes.c_int * n)()
        msg = ctypes.create_string_buffer(256)
        launches, frames = ctypes.c_int(), ctypes.c_int()
        with self._slots, self._pool.context() as ctx:
            with tracing.span('decode.nvjpeg', frames=n, bytes=sum(lens)):
                rc = self._pool.lib.mvf_nvjpeg_decode_batch(
                    ctx, c_datas, c_lens, n, c_outs, c_hs, c_ws, status,
                    ctypes.byref(launches), ctypes.byref(frames), msg,
                    len(msg))
            got = ([self._planes(ctx, i, h, w)
                    for i, (h, w, _) in enumerate(shapes)]
                   if planes and rc == 0 else None)
        _count(launches.value, frames.value)
        if rc != 0:
            self._raise_unless_bitstream(rc, msg)
            return None
        return (outs, got) if planes else outs
