"""The port's upload path on the CPU (``engine/prefetch.py``).

The ring's chunk plan covers every byte of an array once, in order, at
each size around a chunk and in each dtype, and the ring's host half puts
each byte back in its place; ``HostCopy`` copies exactly on any number
of threads, the caller copying the parts no thread has taken; the ring
reuses a slot only after its chunk went up, and leaves no copy running
when it raises; an array is sent in its own memory and layout where its
elements fill one block, a read-only one too. On a CPU ``device`` the
train and eval steps stage nothing (no ``PinnedStager``: their inputs
pass through) and compute what the model computes on the same tensor.
The ring on the card is ``tests/test_torch_cuda_kernels.py``'s.
"""

import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import pytest
import torch

import torch_reference  # noqa: F401  (the worker's share of the cores)
from mvfnet_tpu_torch.engine import prefetch
from mvfnet_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from mvfnet_tpu_torch.engine.train_step import make_eval_step, make_train_step
from mvfnet_tpu_torch.models import build_recognizer

C = prefetch.CHUNK_BYTES
# bytes asked for, in chunks of ``chunk``; an array holds the fewest
# elements of its dtype that reach them
SIZES = {'0': lambda c: 0, '1': lambda c: 1, 'below_chunk': lambda c: c - 3,
         'chunk': lambda c: c, 'chunk_plus_1': lambda c: c + 1,
         'several_chunks': lambda c: 3 * c + 5}
DTYPES = ['uint8', 'float32', 'int64']


def _nbytes(size, dtype, chunk):
    item = np.dtype(dtype).itemsize
    return -(-SIZES[size](chunk) // item) * item


def _check_plan(plan, nbytes, chunk):
    assert len(plan) == -(-nbytes // chunk)
    ends = [0] + [b for _, b in plan]
    assert [a for a, _ in plan] == ends[:-1]   # each where the last ended
    assert ends[-1] == nbytes
    assert all(0 < b - a <= chunk for a, b in plan)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('size', list(SIZES))
def test_chunk_plan_covers_every_byte_once_in_order(size, dtype):
    nbytes = _nbytes(size, dtype, C)
    _check_plan(prefetch.chunk_plan(nbytes), nbytes, C)


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('size', list(SIZES))
def test_ring_host_half_puts_each_byte_in_place(size, dtype):
    """The host half of ``stage`` at a small chunk: each chunk through
    the next of ``SLOTS`` slots and back to its place."""
    chunk = 1024
    n = _nbytes(size, dtype, chunk) // np.dtype(dtype).itemsize
    src = (np.arange(n, dtype=np.int64) * 2654435761 % 251).astype(dtype)
    flat = prefetch._memory_bytes(prefetch._host_tensor(src))
    plan = prefetch.chunk_plan(flat.numel(), chunk)
    _check_plan(plan, src.nbytes, chunk)
    slots = [np.empty(chunk, np.uint8) for _ in range(prefetch.SLOTS)]
    out = torch.full((src.nbytes,), 0xAA, dtype=torch.uint8)
    copy = prefetch.HostCopy(3)
    for k, (a, b) in enumerate(plan):
        slot = slots[k % len(slots)][:b - a]
        prefetch.finish(copy.start(slot, flat.numpy()[a:b]))
        out[a:b] = torch.from_numpy(slot)
    np.testing.assert_array_equal(out.numpy().view(dtype), src)


@pytest.mark.parametrize('threads', [1, 2, 3, 8])
@pytest.mark.parametrize('nbytes', [0, 1, prefetch.MIN_PART_BYTES - 1,
                                    3 * prefetch.MIN_PART_BYTES + 7])
def test_host_copy_is_exact_on_any_threads(threads, nbytes):
    src = (np.arange(nbytes, dtype=np.int64) * 7 % 251).astype(np.uint8)
    dst = np.full(nbytes + 2, 0xAA, np.uint8)        # guard bytes either side
    prefetch.finish(prefetch.HostCopy(threads).start(dst[1:-1], src))
    np.testing.assert_array_equal(dst[1:-1], src)
    assert dst[0] == dst[-1] == 0xAA


class _Event:
    """A CUDA event's stand-in: its DMA is 'in flight' until queried once."""
    log = None

    def __init__(self):
        self.recorded = False
        self.queried = False

    def record(self):
        self.recorded = True

    def query(self):
        self.queried = not self.queried
        return not self.queried              # in flight at the first query

    def synchronize(self):
        _Event.log.append(('wait', self))


class _CpuRing(prefetch.PinnedStager):
    """The stager's ring walk on the CPU: plain slots, a CPU destination,
    and a log of each slot's host copies and uploads."""

    def __init__(self, chunk, slots):
        self.chunk, self.copy = chunk, prefetch.HostCopy(3)
        self._slots, self._events, self._next = [], [None] * slots, 0
        self.uploads = self.bytes_uploaded = self.chunks = 0
        self.slot_waits = 0
        self.log = []
        start = self.copy.start

        def logged_start(dst, src):
            self.log.append(('copy', [s.ctypes.data for s in self._slots]
                             .index(dst.ctypes.data)))
            return start(dst, src)
        self.copy.start = logged_start

    def _slot(self, i):
        if i == len(self._slots):
            self._slots.append(np.empty(self.chunk, np.uint8))
        return torch.from_numpy(self._slots[i])

    def _upload(self, dst, a, b, i, slot, parts):
        self.log.append(('upload', i))
        return super()._upload(dst, a, b, i, slot, parts)


@pytest.mark.parametrize('slots', [2, 3, 4])
@pytest.mark.parametrize('chunks', [0, 1, 2, 7])
def test_ring_reuses_a_slot_only_after_its_upload(monkeypatch, slots,
                                                  chunks):
    """``_send`` on the CPU, with events that report the DMA in flight at
    the first look: every byte lands in place; the chunks go up in order;
    no slot takes a host copy while its last chunk waits for its upload;
    a slot whose DMA is in flight is waited for and counted."""
    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    monkeypatch.setattr(prefetch, 'MIN_PART_BYTES', 256)   # pooled parts
    _Event.log = []
    chunk = 1024
    ring = _CpuRing(chunk, slots)
    src = (np.arange(chunks * chunk - (7 if chunks > 1 else 0),
                     dtype=np.int64) * 31 % 251).astype(np.uint8)
    dst = torch.full((src.nbytes,), 0xAA, dtype=torch.uint8)
    plan = prefetch.chunk_plan(src.nbytes, chunk)
    for _ in range(2):                       # the second call finds events
        done = ring._send(src, dst, plan)
        assert done.recorded
        np.testing.assert_array_equal(dst.numpy(), src)
    uploads = [i for what, i in ring.log if what == 'upload']
    assert uploads == [k % slots for k in range(2 * len(plan))]
    in_copy = set()
    for what, i in ring.log:
        if what == 'copy':
            assert i not in in_copy          # the slot's last chunk went up
            in_copy.add(i)
        else:
            in_copy.remove(i)
    assert ring.slot_waits == len(_Event.log) == max(0, 2 * len(plan) - slots)


def test_ring_leaves_no_copy_running_when_it_raises(monkeypatch):
    """A chunk's copy that fails to start ends the walk with the error,
    and the chunk queued before it has ended its copy by then (no part
    outlives the call to write a slot the next call reuses)."""
    monkeypatch.setattr(torch.cuda, 'Event', _Event)
    monkeypatch.setattr(prefetch, 'MIN_PART_BYTES', 256)
    _Event.log = []
    ring = _CpuRing(1024, 3)
    queued = []
    pool = ThreadPoolExecutor(1)

    def failing_start(dst, src):
        if queued:
            raise RuntimeError('no copy')
        queued.append(pool.submit(time.sleep, 0.3))   # a slow part
        return queued
    ring.copy.start = failing_start
    src = np.ones(3 * 1024, np.uint8)
    with pytest.raises(RuntimeError, match='no copy'):
        ring._send(src, torch.zeros(3 * 1024, dtype=torch.uint8),
                   prefetch.chunk_plan(src.nbytes, 1024))
    assert queued and all(f.done() for f in queued)


@pytest.mark.parametrize('held', [1, 2])
def test_finish_copies_the_parts_no_thread_has_taken(held):
    """With ``held`` of the pool's two threads busy elsewhere, ``finish``
    copies here the parts no thread has taken (every part when both are
    held) and returns without waiting for a held thread; no part writes
    after it returns."""
    copy = prefetch.HostCopy(2)
    gate = threading.Event()
    busy = [copy._pool.submit(gate.wait) for _ in range(held)]
    n = 2 * prefetch.MIN_PART_BYTES + 5
    src = (np.arange(n, dtype=np.int64) * 13 % 251).astype(np.uint8)
    dst = np.zeros(n, np.uint8)
    try:
        parts = copy.start(dst, src)
        assert len(parts) == 2
        prefetch.finish(parts)
        np.testing.assert_array_equal(dst, src)
        assert not gate.is_set()
        if held == 2:
            assert all(f.cancelled() for f in parts)
        dst[:] = 0
    finally:
        gate.set()
        wait(busy)
        copy._pool.shutdown(wait=True)
    assert not dst.any()


def test_host_threads_follow_the_cores():
    cores = len(os.sched_getaffinity(0))
    assert prefetch.host_threads() == min(cores, prefetch.MAX_COPY_THREADS)


def test_host_copy_stays_exact_with_more_threads_than_cores():
    """Twice as many copy threads as cores, the interpreter switching
    threads every 10 us: 16 copies of distinct arrays, each exact."""
    threads = 2 * len(os.sched_getaffinity(0))
    copy = prefetch.HostCopy(threads)
    n = threads * prefetch.MIN_PART_BYTES
    base = np.random.default_rng(3).integers(0, 256, n + 32, dtype=np.uint8)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for k in range(16):
            src = base[k:n + 2 * k]
            dst = np.zeros_like(src)
            prefetch.finish(copy.start(dst, src))
            np.testing.assert_array_equal(dst, src)
    finally:
        sys.setswitchinterval(interval)


def _case(case):
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (2, 3, 4, 5),
                                           dtype=np.uint8))
    return {
        'uint8': rng.integers(0, 256, (2, 3, 5), dtype=np.uint8),
        'int64': rng.integers(-9, 9, (7,), dtype=np.int64),
        'scalar': np.array(2.5, np.float32),
        'empty': np.zeros((0, 3), np.float32),
        # NCHW memory seen as NHWC, as the dense cells' pool holds it
        'permuted': frames.permute(0, 2, 3, 1).numpy(),
        'permuted_tensor': frames.permute(0, 2, 3, 1),
        'strided': rng.standard_normal((4, 6)).astype(np.float32)[:, ::2],
        'reversed': np.arange(6, dtype=np.int16)[::-1],
        'read_only': np.broadcast_to(np.arange(3, dtype=np.int32), (2, 3)),
        'bf16_tensor': torch.randn(3, 4).to(torch.bfloat16),
    }[case]


@pytest.mark.parametrize('case', ['uint8', 'int64', 'scalar', 'empty',
                                  'permuted', 'permuted_tensor', 'strided',
                                  'reversed', 'read_only', 'bf16_tensor'])
def test_host_tensor_keeps_a_dense_layout_and_its_bytes(case):
    """What the ring sends: the array's own memory, in its own layout,
    where its elements fill one block (a contiguous or a permuted one);
    a contiguous copy otherwise. Its bytes in memory order, put into an
    empty tensor of the same layout, give the array back."""
    x = _case(case)
    want = torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x
    host = prefetch._host_tensor(x)
    assert (host.shape, host.dtype) == (want.shape, want.dtype)
    fills_a_block = case in ('uint8', 'int64', 'scalar', 'permuted',
                             'permuted_tensor', 'bf16_tensor')
    if fills_a_block:                  # no copy, the strides kept
        ptr = x.data_ptr() if isinstance(x, torch.Tensor) else x.ctypes.data
        assert host.data_ptr() == ptr
        assert host.stride() == (x.stride() if isinstance(x, torch.Tensor)
                                 else tuple(s // x.itemsize
                                            for s in x.strides))
    else:
        assert host.is_contiguous()
    flat = prefetch._memory_bytes(host)
    assert flat.dtype == torch.uint8 and flat.numel() == host.nbytes
    back = torch.empty_strided(host.shape, host.stride(), dtype=host.dtype)
    prefetch._memory_bytes(back).copy_(flat)
    assert torch.equal(back, want)


def test_step_upload_on_the_cpu_passes_everything():
    upload = prefetch.StepUpload(torch.device('cpu'))
    arr = np.arange(6, dtype=np.uint8).reshape(2, 3)
    t = upload(arr)
    assert t.data_ptr() == arr.ctypes.data          # no copy, as before
    x = torch.ones(3)
    assert upload(x) is x
    assert (upload.passed, upload.staged, upload.stager) == (2, 0, None)


def _small_recognizer():
    """R18's first two stages with MVF in the second, float32, 4 classes."""
    torch.manual_seed(0)
    model = build_recognizer(dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=18, num_stages=2, out_indices=(1,),
                      norm_eval=False),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.0, in_channels=128, init_std=0.01,
                      num_classes=4),
        module_cfg=dict(type='MVF', n_segment=2, alpha=0.125,
                        mvf_freq=(0, 1), mode='THW')),
        test_cfg=dict(average_clips='prob'))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    return model


NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True, device=True)


def test_eval_step_on_the_cpu_stages_nothing_and_scores_as_the_model():
    from mvfnet_tpu_torch.ops.normalize import maybe_device_normalize
    model = _small_recognizer()
    video = np.random.default_rng(1).integers(0, 256, (1, 4, 32, 32, 3),
                                              dtype=np.uint8)
    step = make_eval_step(model, NORM, device='cpu')
    got = step(model, video)
    again = step(model, torch.from_numpy(video))
    assert step.upload.stager is None
    assert (step.upload.passed, step.upload.staged) == (2, 0)
    with torch.inference_mode():
        want = model(maybe_device_normalize(torch.from_numpy(video), NORM,
                                            model.compute_dtype),
                     None, return_loss=False)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_train_step_on_the_cpu_stages_nothing_and_trains_as_before():
    """Two steps from numpy arrays and two from the same tensors, from the
    same weights: the same metrics and weights, every input passed."""
    imgs = np.random.default_rng(2).integers(0, 256, (2, 2, 32, 32, 3),
                                             dtype=np.uint8)
    labels = np.array([1, 3])
    runs = []
    for as_tensor in (False, True):
        model = _small_recognizer()
        sched = build_lr_schedule(dict(policy='step', step=[5]), 0.01, 10, 1)
        opt = build_optimizer(model, dict(type='SGD', lr=0.01, momentum=0.9),
                              sched)
        step = make_train_step(model, opt, sched, norm_cfg=NORM,
                               device='cpu', seed=0)
        x, y = ((torch.from_numpy(imgs), torch.from_numpy(labels))
                if as_tensor else (imgs, labels))
        losses = [step(x, y)['loss'].item() for _ in range(2)]
        assert step.upload.stager is None
        assert (step.upload.passed, step.upload.staged) == (4, 0)
        runs.append((losses, [p.detach().clone()
                              for p in model.parameters()]))
    (la, pa), (lb, pb) = runs
    assert la == lb and all(np.isfinite(la))
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))
