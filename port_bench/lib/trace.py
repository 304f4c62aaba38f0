"""Device time from torch.profiler: busy time, kernels by name, idle gaps.

``profile(fn)`` runs ``fn`` under the profiler (CPU and CUDA activities)
and returns its device events (kernels and copies, not the device-side
ranges of annotations) and the benchmark's own host spans, the
``record_function`` ranges named ``bench.*`` that the drivers put around
each call into a layer. Busy time is the union of the device intervals;
an idle gap is a stretch of the window in which no device event ran,
named by the innermost ``bench.*`` span open on the host when it began.
The profiler slows the host, so wall time per request or step comes from
an unprofiled stretch of the same run, never from this window.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

Span = Tuple[float, float, str]        # start, end (microseconds), name


def profile(fn: Callable[[], None]) -> Dict:
    """``fn`` profiled; ``fn`` must end with the device synchronized."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall_s = time.perf_counter() - t0
    device: List[Span] = []
    host: List[Span] = []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, 'is_user_annotation', False):
                device.append(span)
        elif e.name.startswith('bench.'):
            host.append(span)
    device.sort()
    host.sort()
    return dict(device=device, host=host, wall_s=wall_s)


def busy_us(spans: List[Span]) -> float:
    """Length of the union of ``spans`` (sorted by start)."""
    busy, end = 0.0, float('-inf')
    for s, e, _ in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def top_ops(spans: List[Span], n: int = 10) -> List[list]:
    """The ``n`` device operations that took most time, summed by name,
    in seconds."""
    by_name: Dict[str, float] = {}
    for s, e, name in spans:
        by_name[name[:120]] = by_name.get(name[:120], 0.0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in top]


def idle_gaps(device: List[Span], host: List[Span], n: int = 10
              ) -> List[list]:
    """Idle stretches between the first and last device event, summed by
    the innermost ``bench.*`` span open on the host at each gap's start
    ('host: outside bench spans' where none is), in seconds."""
    by_what: Dict[str, float] = {}
    end = None
    for s, e, _ in device:
        if end is not None and s > end:
            open_spans = [h for h in host if h[0] <= end < h[1]]
            what = (max(open_spans)[2] if open_spans
                    else 'host: outside bench spans')
            by_what[what] = by_what.get(what, 0.0) + (s - end)
        end = e if end is None else max(end, e)
    top = sorted(by_what.items(), key=lambda kv: -kv[1])[:n]
    return [[what, us / 1e6] for what, us in top]


def kernel_us(spans: List[Span], match: str) -> Tuple[int, float]:
    """How many device events have ``match`` in their name, and their
    summed time."""
    hits = [e - s for s, e, name in spans if match in name]
    return len(hits), sum(hits)


def kernel_kind(name: str) -> str:
    """A device event's kind, by its name."""
    low = name.lower()
    for kind, keys in (('fused_bottleneck', ('fused_bottleneck',)),
                       ('int8_conv', ('int8_conv',)),
                       ('ycc_to_bgr', ('ycc',)),
                       ('memcpy', ('memcpy',)),
                       ('conv', ('conv', 'xmma', 'gemm', 'cutlass', 'sm90_',
                                 'implicit', 'dgrad', 'wgrad')),
                       ('batch_norm', ('batch_norm', 'bn_fw', 'bn_bw',
                                       'batchnorm')),
                       ('optimizer', ('multi_tensor_apply',)),
                       ('pool', ('pool',)),
                       ('reduce', ('reduce', 'softmax'))):
        if any(k in low for k in keys):
            return kind
    return 'elementwise'


def by_kind_s(spans: List[Span]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s, e, name in spans:
        k = kernel_kind(name)
        out[k] = out.get(k, 0.0) + (e - s) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
