"""Host-to-device upload (counterpart of ``mvfnet_tpu/engine/prefetch.py``
and the double buffer in ``mvfnet_tpu/engine/eval.py``).

Every host array the port sends to the card goes through one
``PinnedStager.stage``: a ring of ``SLOTS`` pinned chunk slots of
``CHUNK_BYTES`` each, and a copy stream. ``stage`` walks the array's bytes
a chunk at a time: it queues the chunk's copy from pageable memory into
the next free slot on a pool of host threads (``HostCopy``: ``np.copyto``
over parts, the GIL released; the caller copies the parts no thread has
taken by the time it needs them), and once a chunk's copy has ended, queues
the slot's copy to the card on the copy stream and records an event
after it. So the host copies of the next chunks overlap the DMA of the
one before, and the host waits on a slot's event only when it comes
round to a slot whose DMA is still in flight. Each call allocates its
own device tensor, so a staged array stays valid while later ones are
staged.

``prefetch_to_device`` stages the next batch while the current one
computes (the loaders' double buffer). ``StepUpload`` is how the train and
eval steps take their inputs: a host array is staged, a CUDA tensor
passes through, and a CPU ``device`` gets the arrays as tensors, with no
staging.
"""

from __future__ import annotations

import os
import warnings
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import tracing

# a dense I3D video (188.7 MB) stages fastest in 32 MiB chunks; the host
# copy sets the pace (no slot waits), so three slots are enough
# (tools/upload_bench.py; PERF.md)
CHUNK_BYTES = 32 << 20
SLOTS = 3
# the host copy's threads, at most; a part is at least MIN_PART_BYTES.
# Each part is a hand-over between threads, and on a shared host those
# slow down together: 4 threads copy a flagship video as fast as 8 with
# half the hand-overs (PERF.md)
MAX_COPY_THREADS = 4
MIN_PART_BYTES = 1 << 20


def chunk_plan(nbytes: int, chunk: int = CHUNK_BYTES
               ) -> List[Tuple[int, int]]:
    """The ``(start, end)`` byte ranges, in order, that cover ``nbytes``
    bytes once, each at most ``chunk`` long; none for 0 bytes."""
    return [(a, min(a + chunk, nbytes)) for a in range(0, nbytes, chunk)]


def host_threads() -> int:
    """The host copy's threads: the cores this process may run on, at
    most ``MAX_COPY_THREADS``."""
    cores = (len(os.sched_getaffinity(0)) if hasattr(os, 'sched_getaffinity')
             else os.cpu_count() or 1)
    return max(1, min(MAX_COPY_THREADS, cores))


class HostCopy:
    """Copies bytes between host arrays on a pool of ``threads`` threads,
    in parts of at least ``MIN_PART_BYTES``. ``np.copyto`` releases the
    GIL, so the parts copy at once; the threads sleep between parts
    (torch's OpenMP threads spin after each region, and starve a loader's
    threads beside them). ``start`` queues a copy and returns at once, so
    the caller can queue the next before this one ends."""

    def __init__(self, threads: int):
        self.threads = threads
        self._pool = ThreadPoolExecutor(threads,
                                        thread_name_prefix='host_copy')

    def start(self, dst: np.ndarray, src: np.ndarray) -> List[Future]:
        """Queue ``dst[...] = src`` for 1-D uint8 arrays of one length;
        the futures of its parts. Below two parts it copies at once and
        returns none."""
        n = len(src)
        parts = min(self.threads, n // MIN_PART_BYTES)
        if parts < 2:
            np.copyto(dst, src)
            return []
        edges = [n * i // parts for i in range(parts + 1)]
        futures = []
        for a, b in zip(edges[:-1], edges[1:]):
            f = self._pool.submit(np.copyto, dst[a:b], src[a:b])
            f.part = dst[a:b], src[a:b]       # for ``finish`` to take
            futures.append(f)
        return futures


def finish(parts: List[Future]) -> None:
    """Wait for a copy's parts, copying here each part no thread has taken
    yet, from the last (the threads take them from the first): on a shared
    host the pool's threads can be slow to wake, and the caller, which
    would only wait, copies instead. Then one sleep for the parts the
    threads took (each wait on a future not yet done gives up the GIL and
    takes it back, which costs up to a switch interval while a loader's
    threads hold it), and raise what failed."""
    try:
        for f in reversed(parts):
            if f.cancel():
                np.copyto(*f.part)
    finally:
        taken = [f for f in parts if not f.cancelled()]
        wait(taken)
    for f in taken:
        f.result()


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t``'s elements fill one block of memory: a contiguous
    layout with its dimensions in some order."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size != 1:
            if stride != expected:
                return False
            expected *= size
    return True


def _host_tensor(x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
    """``x`` as a CPU tensor whose elements fill one block of memory: its
    own memory where they do (a permuted layout keeps its strides, as
    ``Tensor.to`` keeps them), a contiguous copy where they do not."""
    if isinstance(x, np.ndarray):
        with warnings.catch_warnings():  # a read-only array: only read here
            warnings.simplefilter('ignore', UserWarning)
            try:
                x = torch.from_numpy(x)
            except ValueError:           # negative or odd strides
                x = torch.from_numpy(np.array(x, order='C'))
    return x if x.numel() and _dense(x) else x.contiguous()


def _memory_bytes(t: torch.Tensor) -> torch.Tensor:
    """The bytes of a tensor that fills one block, in memory order."""
    return t.as_strided((t.numel(),), (1,)).view(torch.uint8)


class PinnedStager:
    """A ring of ``SLOTS`` pinned slots of ``CHUNK_BYTES`` and a copy
    stream for one CUDA device. Each slot is pinned on its first use, so
    a stager that only ever sees small arrays pins one.

    Counters: ``uploads`` (arrays staged), ``bytes_uploaded`` (their
    bytes), ``chunks`` (chunks sent through the ring) and ``slot_waits``
    (chunks whose slot still had its DMA in flight when the host came to
    it: near 0 the host copy sets the pace, near ``chunks`` the DMA).
    With tracing on, ``upload.stage`` spans each ``stage`` (``bytes``,
    ``chunks``).
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.chunk = CHUNK_BYTES
        self.copy = HostCopy(host_threads())
        self._slots: List[torch.Tensor] = []
        self._events: List[Optional[torch.cuda.Event]] = [None] * SLOTS
        self._next = 0
        self.uploads = 0
        self.bytes_uploaded = 0
        self.chunks = 0
        self.slot_waits = 0

    def _slot(self, i: int) -> torch.Tensor:
        if i == len(self._slots):
            self._slots.append(torch.empty(self.chunk, dtype=torch.uint8,
                                           pin_memory=True))
        return self._slots[i]

    def stage(self, x: Union[np.ndarray, torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Queue the upload of host array ``x``; returns the device tensor
        and the event that ends its copy, in ``x``'s layout where its
        elements fill one block of memory (as ``Tensor.to`` keeps it),
        contiguous otherwise. A pinned tensor is copied directly; anything
        else goes through the ring."""
        if isinstance(x, torch.Tensor) and x.is_pinned():
            nbytes, plan = x.nbytes, []
            with tracing.span('upload.stage', bytes=nbytes, chunks=0), \
                    torch.cuda.stream(self.stream):
                dev = x.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        else:
            host = _host_tensor(x)
            nbytes = host.nbytes
            plan = chunk_plan(nbytes, self.chunk)
            with tracing.span('upload.stage', bytes=nbytes,
                              chunks=len(plan)), \
                    torch.cuda.stream(self.stream):
                dev = torch.empty_strided(host.shape, host.stride(),
                                          dtype=host.dtype,
                                          device=self.device)
                done = self._send(_memory_bytes(host).numpy(),
                                  _memory_bytes(dev), plan)
        self.uploads += 1
        self.bytes_uploaded += nbytes
        self.chunks += len(plan)
        return dev, done

    def _send(self, src: np.ndarray, dst: torch.Tensor,
              plan: List[Tuple[int, int]]) -> torch.cuda.Event:
        """Each chunk of ``plan`` through the ring onto the copy stream (the
        current one); the event recorded after the last. The host copies
        of up to ``SLOTS - 1`` chunks are queued at once, so the pool's
        threads move on to the next chunk while the last part of one
        ends; a chunk's DMA is queued once its parts have ended."""
        copying: deque = deque()
        done = torch.cuda.Event()
        try:
            for a, b in plan:
                i = self._next
                self._next = (i + 1) % len(self._events)
                pending = self._events[i]   # the DMA of the slot's last chunk
                if pending is not None and not pending.query():
                    self.slot_waits += 1
                    pending.synchronize()
                slot = self._slot(i)[:b - a]
                copying.append((a, b, i, slot,
                                self.copy.start(slot.numpy(), src[a:b])))
                if len(copying) == len(self._events) - 1:
                    done = self._upload(dst, *copying.popleft())
            while copying:
                done = self._upload(dst, *copying.popleft())
        finally:
            for *_, parts in copying:   # raised: no part outlives the call
                wait(parts)
        if not plan:
            done.record()
        return done

    def _upload(self, dst: torch.Tensor, a: int, b: int, i: int,
                slot: torch.Tensor, parts: List[Future]) -> torch.cuda.Event:
        """Once slot ``i``'s host copy has ended, queue its DMA to
        ``dst[a:b]`` and record the slot's event after it."""
        finish(parts)
        dst[a:b].copy_(slot, non_blocking=True)
        done = self._events[i] = torch.cuda.Event()
        done.record()
        return done


def _ready(staged: Tuple[torch.Tensor, torch.cuda.Event]) -> torch.Tensor:
    """The staged tensor, ready for work queued next on the current stream."""
    tensor, done = staged
    stream = torch.cuda.current_stream(tensor.device)
    stream.wait_event(done)
    # the copy stream allocated it: keep its memory until the current
    # stream's work on it has ended
    tensor.record_stream(stream)
    return tensor


class StepUpload:
    """A step's inputs on ``device``. On a CUDA device a host array (numpy
    or an unpinned CPU tensor) is staged and a pinned tensor copied
    directly, both through a ``PinnedStager`` made on the first host array;
    a CUDA tensor passes through. On another device nothing is staged.
    ``staged`` and ``passed`` count the inputs each way."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stager: Optional[PinnedStager] = None
        self.staged = 0
        self.passed = 0

    def __call__(self, x: Union[np.ndarray, torch.Tensor]) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            if self.device.type != 'cuda':
                self.passed += 1
                return torch.from_numpy(x)
        elif self.device.type != 'cuda' or x.device.type != 'cpu':
            self.passed += 1
            return x.to(self.device, non_blocking=True)
        if self.stager is None:
            self.stager = PinnedStager(self.device)
        self.staged += 1
        return _ready(self.stager.stage(x))


def prefetch_to_device(arrays: Iterable[np.ndarray], device: torch.device,
                       stager: Optional[PinnedStager] = None
                       ) -> Iterator[torch.Tensor]:
    """Yield each array as a tensor on ``device``, the next one's upload
    queued before the current one is yielded. ``stager`` defaults to a new
    ``PinnedStager`` on a CUDA device."""
    device = torch.device(device)
    if device.type != 'cuda':
        for arr in arrays:
            yield torch.from_numpy(np.ascontiguousarray(arr))
        return
    stager = stager or PinnedStager(device)
    pending = None
    for arr in arrays:
        nxt = stager.stage(arr)
        if pending is not None:
            yield _ready(pending)
        pending = nxt
    if pending is not None:
        yield _ready(pending)
