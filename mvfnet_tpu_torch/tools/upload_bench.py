"""Host-to-card upload rates on the card: the readings behind
``engine/prefetch.py``'s chunk size, slot count and host threads.

    python -m mvfnet_tpu_torch.tools.upload_bench [--arrays i3d_video,...] \
        [--rounds 3] [--chunks-mb 2,4,8] [--slots 3,4] [--out OUT.json]

For each array of ``ARRAYS`` (the dense cells' uint8 videos and the train
cell's batch), a pool of ``POOL`` distinct host arrays in pageable memory,
as a loader hands them over, is read in turn, so every read comes from
DRAM. Each prints an ``upload bench:`` JSON line with GB/s (bytes over the
median seconds of one array):

- ``host``: pageable to pinned, chunk by chunk into a ring of pinned
  slots (``CHUNK_BYTES`` x ``SLOTS``) with no DMA, by ``prefetch.HostCopy``
  (``numpy_pool``, the stager's way) and by torch's CPU ``copy_`` on its
  OpenMP intra-op threads (``torch``), at 1, 2, 4, 8 and all threads,
  each with the process CPU ms burned in the 100 ms after a call
  (``*_cpu_after_ms``: threads that spin instead of sleeping); and into
  one whole pinned array by one ``np.copyto`` (``numpy_whole_1``, the
  fill of the stager before the ring);
- ``dma``: a pinned array to the card, whole and by chunks (CUDA events);
- ``pageable``: ``tensor.to('cuda')`` from pageable memory, the step's
  upload before the ring (host clock to a synchronize);
- ``stage``: ``PinnedStager.stage`` from its call to its event, for each
  chunk size of ``--chunks-mb`` and slot count of ``--slots`` at the
  shipped threads (``prefetch.host_threads``), and for each thread count
  and for torch's OpenMP copy (``TorchCopy``) at the shipped chunk and
  slots; with the stager's ``slot_waits`` over its ``chunks``. Each
  configuration's first array is held byte for byte against its source.

Then the card's name and power limit; ``--out`` gets the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

import numpy as np
import torch

from ..engine import prefetch

ARRAYS = {
    'i3d_video': (1, 30, 32, 256, 256, 3),
    'r50_video': (1, 240, 256, 256, 3),
    'r50_train_batch': (12, 8, 224, 224, 3),
}
POOL = 4
CHUNKS_MB = (2, 4, 8, 16, 32)
SLOT_COUNTS = (3, 4, 6)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def thread_counts() -> List[int]:
    cores = len(os.sched_getaffinity(0))
    return sorted({t for t in (1, 2, 4, 8) if t <= cores} | {cores})


def gbps(nbytes: int, seconds: List[float]) -> float:
    return nbytes / statistics.median(seconds) / 1e9


def timed(fn: Callable[[np.ndarray], None], pool: List[np.ndarray],
          rounds: int) -> List[float]:
    """Host seconds of ``fn`` on each pool array, ``rounds`` times over,
    after one warm-up call."""
    fn(pool[0])
    out = []
    for _ in range(rounds):
        for a in pool:
            t0 = time.perf_counter()
            fn(a)
            out.append(time.perf_counter() - t0)
    return out


def cpu_after_ms(fn, a) -> float:
    """Process CPU ms burned in the 100 ms of sleep after one call: the
    copy's threads spinning where they do not sleep."""
    fn(a)
    c0 = time.process_time()
    time.sleep(0.1)
    return (time.process_time() - c0) * 1e3


def host_rates(pool: List[np.ndarray], rounds: int) -> Dict[str, dict]:
    """Pageable-to-pinned GB/s into the ring by method and thread count,
    with the CPU burned after a call, and into one whole pinned array on
    one thread."""
    nbytes = pool[0].nbytes
    plan = prefetch.chunk_plan(nbytes, prefetch.CHUNK_BYTES)
    slots = [torch.empty(prefetch.CHUNK_BYTES, dtype=torch.uint8,
                         pin_memory=True) for _ in range(prefetch.SLOTS)]
    default_threads = torch.get_num_threads()
    out: Dict[str, dict] = {'torch': {}, 'numpy_pool': {},
                            'torch_cpu_after_ms': {},
                            'numpy_pool_cpu_after_ms': {}}
    for threads in thread_counts():
        copy = prefetch.HostCopy(threads)

        def ring_torch(a):
            src = torch.from_numpy(a.reshape(-1))
            for k, (s, e) in enumerate(plan):
                slots[k % len(slots)][:e - s].copy_(src[s:e])

        def ring_numpy(a):
            src = a.reshape(-1)
            for k, (s, e) in enumerate(plan):
                dst = slots[k % len(slots)].numpy()[:e - s]
                prefetch.finish(copy.start(dst, src[s:e]))

        torch.set_num_threads(threads)
        out['torch'][threads] = gbps(nbytes, timed(ring_torch, pool, rounds))
        out['torch_cpu_after_ms'][threads] = cpu_after_ms(ring_torch, pool[0])
        torch.set_num_threads(default_threads)
        out['numpy_pool'][threads] = gbps(nbytes,
                                          timed(ring_numpy, pool, rounds))
        out['numpy_pool_cpu_after_ms'][threads] = cpu_after_ms(ring_numpy,
                                                               pool[0])
    whole = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out['numpy_whole_1'] = gbps(nbytes, timed(
        lambda a: np.copyto(whole.numpy(), a.reshape(-1)), pool, rounds))
    return out


def dma_rates(nbytes: int, rounds: int) -> Dict[str, float]:
    """Pinned-to-card GB/s, one copy of the whole and by chunks."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device='cuda')
    plan = prefetch.chunk_plan(nbytes, prefetch.CHUNK_BYTES)

    def event_s(fn) -> float:
        fn()
        times = []
        for _ in range(rounds * POOL):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        return gbps(nbytes, times)

    def chunked():
        for a, b in plan:
            dev[a:b].copy_(host[a:b], non_blocking=True)

    return dict(whole=event_s(lambda: dev.copy_(host, non_blocking=True)),
                chunks=event_s(chunked))


def pageable_rate(pool: List[np.ndarray], rounds: int) -> float:
    def up(a):
        torch.from_numpy(a).to('cuda', non_blocking=True)
        torch.cuda.synchronize()
    return gbps(pool[0].nbytes, timed(up, pool, rounds))


class TorchCopy:
    """``HostCopy``'s interface over torch's CPU ``copy_`` on its OpenMP
    intra-op threads, done before ``start`` returns: the other way the
    ring's host copy could go, timed beside the shipped one."""

    def start(self, dst: np.ndarray, src: np.ndarray) -> list:
        torch.from_numpy(dst).copy_(torch.from_numpy(src))
        return []


def stage_rate(pool: List[np.ndarray], rounds: int, chunk: int, slots: int,
               threads) -> dict:
    """``stage`` GB/s at ``chunk`` bytes, ``slots`` slots and ``threads``
    host copy threads (``'torch'``: ``TorchCopy`` on torch's threads),
    with its slot waits a chunk; the first array checked."""
    shipped = prefetch.CHUNK_BYTES, prefetch.SLOTS
    prefetch.CHUNK_BYTES, prefetch.SLOTS = chunk, slots
    try:
        stager = prefetch.PinnedStager(torch.device('cuda'))
    finally:
        prefetch.CHUNK_BYTES, prefetch.SLOTS = shipped
    stager.copy = (TorchCopy() if threads == 'torch'
                   else prefetch.HostCopy(threads))
    dev, done = stager.stage(pool[0])
    done.synchronize()
    exact = bool(torch.equal(dev.cpu(), torch.from_numpy(pool[0])))
    del dev
    chunks, waits = stager.chunks, stager.slot_waits
    seconds = timed(lambda a: stager.stage(a)[1].synchronize(), pool, rounds)
    return dict(chunk_mb=chunk >> 20, slots=slots, threads=threads,
                gbps=gbps(pool[0].nbytes, seconds),
                ms=statistics.median(seconds) * 1e3,
                slot_waits_per_chunk=(stager.slot_waits - waits)
                / max(stager.chunks - chunks, 1), exact=exact)


def bench(name: str, rounds: int, chunks_mb=CHUNKS_MB,
          slot_counts=SLOT_COUNTS) -> dict:
    shape = ARRAYS[name]
    pool = []
    for i in range(POOL):
        a = np.empty(shape, np.uint8)
        a.fill(i + 1)                      # touch every page
        pool.append(a)
    nbytes = pool[0].nbytes
    shipped = prefetch.host_threads()
    stage = [stage_rate(pool, rounds, mb << 20, s, shipped)
             for mb in chunks_mb for s in slot_counts]
    stage += [stage_rate(pool, rounds, prefetch.CHUNK_BYTES, prefetch.SLOTS,
                         t) for t in thread_counts() + ['torch']
              if t != shipped]
    return dict(array=name, shape=list(shape), mb=nbytes / 1e6,
                shipped=dict(chunk_mb=prefetch.CHUNK_BYTES >> 20,
                             slots=prefetch.SLOTS, threads=shipped),
                host=host_rates(pool, rounds),
                dma=dma_rates(nbytes, rounds),
                pageable=pageable_rate(pool, rounds), stage=stage)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--arrays', default=','.join(ARRAYS))
    parser.add_argument('--rounds', type=int, default=3)
    parser.add_argument('--chunks-mb', default=','.join(map(str, CHUNKS_MB)))
    parser.add_argument('--slots', default=','.join(map(str, SLOT_COUNTS)))
    parser.add_argument('--out', default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('upload_bench needs an NVIDIA GPU')
        return 2
    records = []
    for name in args.arrays.split(','):
        rec = bench(name, args.rounds,
                    [int(v) for v in args.chunks_mb.split(',')],
                    [int(v) for v in args.slots.split(',')])
        records.append(rec)
        print('upload bench: ' + json.dumps(rec), flush=True)
    card = card_line()
    print('card: ' + card)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(dict(card=card, cores=len(os.sched_getaffinity(0)),
                           records=records), f, indent=1)
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
