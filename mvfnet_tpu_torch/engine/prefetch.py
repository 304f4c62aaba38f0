"""Host-to-device prefetch (counterpart of ``mvfnet_tpu/engine/prefetch.py``
and the double buffer in ``mvfnet_tpu/engine/eval.py``).

``prefetch_to_device`` stages the next batch's frames in pinned host memory
and starts their non-blocking copy to the GPU on a copy stream while the
current batch computes. Two pinned buffers are allocated once and reused in
turn, each with an event recorded after its copy: the host waits on that
event before it writes the buffer again, so it never overwrites a buffer
whose copy is still in flight. The step's stream waits on the same event
before it reads the frames. A CPU ``device`` gets the arrays as tensors, with
no staging.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..utils import tracing


class PinnedStager:
    """Two pinned host buffers and a copy stream for one CUDA device.

    A batch smaller than the buffers (the last, partial batch) uses their
    leading rows; a batch of another frame shape or dtype reallocates both
    once their copies have ended. ``uploads`` counts the batches staged and
    ``bytes_uploaded`` their bytes; with tracing on, ``upload.stage`` spans
    each ``stage`` (``bytes``).
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._bufs: List[torch.Tensor] = []
        self._events: List[Optional[torch.cuda.Event]] = [None, None]
        self._next = 0
        self.uploads = 0
        self.bytes_uploaded = 0

    def _buffer(self, arr: np.ndarray) -> torch.Tensor:
        dtype = torch.from_numpy(arr[:0]).dtype
        if self._bufs:
            buf = self._bufs[self._next]
            if (buf.dtype == dtype and buf.shape[1:] == arr.shape[1:]
                    and buf.shape[0] >= arr.shape[0]):
                return buf[:arr.shape[0]]
            for ev in self._events:
                if ev is not None:
                    ev.synchronize()
        self._bufs = [torch.empty(arr.shape, dtype=dtype, pin_memory=True)
                      for _ in range(2)]
        self._events = [None, None]
        return self._bufs[self._next]

    def stage(self, arr: np.ndarray) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """Copy ``arr`` into the free pinned buffer and queue its upload;
        returns the device tensor and the event that ends its copy."""
        arr = np.ascontiguousarray(arr)
        with tracing.span('upload.stage', bytes=arr.nbytes):
            slot = self._next
            if self._events[slot] is not None:
                self._events[slot].synchronize()   # its last copy has ended
            host = self._buffer(arr)
            host.numpy()[...] = arr
            with torch.cuda.stream(self.stream):
                dev = host.to(self.device, non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
        self._events[slot] = done
        self._next = 1 - slot
        self.uploads += 1
        self.bytes_uploaded += arr.nbytes
        return dev, done


def _ready(staged: Tuple[torch.Tensor, torch.cuda.Event]) -> torch.Tensor:
    """The staged tensor, ready for work queued next on the current stream."""
    tensor, done = staged
    stream = torch.cuda.current_stream(tensor.device)
    stream.wait_event(done)
    # the copy stream allocated it: keep its memory until the current
    # stream's work on it has ended
    tensor.record_stream(stream)
    return tensor


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
