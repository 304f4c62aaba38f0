"""The program's own spans, on the host clock and on the device trace's.

``mvfnet_tpu_torch.utils.tracing`` stamps each span with
``time.perf_counter_ns()``; torch.profiler stamps its events on the
system clock and gives them in microseconds from the trace's start
(``trace_start_ns``). A ``ClockMap`` reads both clocks in pairs at the
start and at the end of a profiled stretch and maps a span's stamps onto
the profiler's microseconds by the line through the two pairs.
``profile(fn)`` runs ``fn`` with spans on under the profiler: every span
the main thread opens there also enters a ``record_function`` range of
its name, and ``clock_offset_us`` holds the mapped spans against those
ranges. The device-trace readers here read None where the two disagree by
more than ``MAX_OFFSET_US``, and every reader reads None where the program
recorded no such span (a program without spans records none).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

MAX_OFFSET_US = 50.0

# the cudaLaunch* and cuLaunch* calls that launch a kernel
LAUNCH_CALLS = ('cudaLaunchKernel', 'cuLaunchKernel',
                'cudaLaunchCooperativeKernel')


def tracing():
    """The program's span module, or None where the program has none."""
    try:
        from mvfnet_tpu_torch.utils import tracing as module
    except ImportError:
        return None
    return module


def clock_pair(tries: int = 5) -> Tuple[int, int]:
    """(perf_counter ns, system clock ns) read together: of ``tries``
    brackets of ``time.time_ns()`` by two ``perf_counter_ns()``, the
    tightest, its midpoint."""
    best = None
    for _ in range(tries):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, unix)
    return best[1], best[2]


class ClockMap:
    """``perf_counter_ns`` stamps onto the system clock, by the line
    through two pairs of readings (``clock_pair``)."""

    def __init__(self, first: Tuple[int, int], last: Tuple[int, int]):
        self.p0, self.u0 = first
        p1, u1 = last
        self.slope = ((u1 - self.u0) / (p1 - self.p0) if p1 != self.p0
                      else 1.0)

    def unix_ns(self, perf_ns: int) -> float:
        return self.u0 + (perf_ns - self.p0) * self.slope

    def trace_us(self, perf_ns: int, trace_start_ns: int) -> float:
        """Microseconds from the trace's start, as the profiler's events
        give them."""
        return (self.unix_ns(perf_ns) - trace_start_ns) / 1e3


def map_spans(spans: List[dict], clock: ClockMap,
              trace_start_ns: int) -> List[dict]:
    """``spans`` (``tracing.collect()``) with ``s`` and ``e`` in the
    profiler's microseconds."""
    return [dict(sp, s=clock.trace_us(sp['start_ns'], trace_start_ns),
                 e=clock.trace_us(sp['end_ns'], trace_start_ns))
            for sp in spans]


def host_spans(spans: List[dict]) -> List[dict]:
    """``spans`` with ``s`` and ``e`` in microseconds of perf_counter."""
    return [dict(sp, s=sp['start_ns'] / 1e3, e=sp['end_ns'] / 1e3)
            for sp in spans]


def record(fn: Callable[[], None]) -> Optional[List[dict]]:
    """``fn`` run with the program's spans on; its spans on the host clock
    (``s``, ``e`` in µs), or None without a span module."""
    module = tracing()
    if module is None:
        fn()
        return None
    module.clear()
    module.enable()
    try:
        fn()
    finally:
        module.disable()
    return host_spans(_take(module))


def _take(module) -> List[dict]:
    """The module's spans, cleared; raises where its store dropped any (a
    reading over part of the spans would be wrong)."""
    if module.dropped():
        raise RuntimeError(f'the span store dropped {module.dropped()} '
                           'spans')
    spans = module.collect()
    module.clear()
    return spans


def profile(fn: Callable[[], None]) -> Optional[Dict]:
    """``fn`` run with spans on under torch.profiler (CPU and CUDA
    activities); ``fn`` must end with the device synchronized. Returns the
    mapped spans, the device events (kernels and copies, with their
    correlation ids), the launch calls, the ``record_function`` ranges on
    the host, the main thread's id and the wall seconds; None without a
    span module."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    module = tracing()
    if module is None:
        return None
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    module.clear()
    with torch_profile(activities=activities) as prof:
        first = clock_pair()
        module.enable()
        t0 = time.perf_counter()
        try:
            fn()
        finally:
            module.disable()
        wall_s = time.perf_counter() - t0
        last = clock_pair()
    spans = _take(module)
    events = prof.events()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    device, ranges, launches = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, 'is_user_annotation', False):
                device.append((s, t, e.name, e.id))
        elif getattr(e, 'is_user_annotation', False):
            ranges.append((s, t, e.name))
        elif e.name.startswith(LAUNCH_CALLS) or e.name.startswith(
                ('cudaMemcpy', 'cudaMemset')):
            launches.append((s, t, e.name, e.id))
    device.sort()
    ranges.sort()
    launches.sort()
    return dict(spans=map_spans(spans, ClockMap(first, last), start_ns),
                device=device, ranges=ranges, launches=launches,
                main_thread=threading.main_thread().native_id,
                wall_s=wall_s)


# ------------------------------------------------------------ the clock
def clock_offset_us(spans: List[dict], ranges: Sequence[tuple],
                    main_thread: int) -> Optional[float]:
    """The worst disagreement, in µs, between the main thread's mapped
    spans and the ``record_function`` ranges of their names, paired in
    order name by name (names whose counts differ are left out); None
    where nothing pairs. A span stamps its start before it enters its
    range and its end after it leaves it, so on a true clock each range
    lies inside its mapped span, whatever the host's delays between the
    stamps; a span disagrees by how far its range reaches outside it."""
    mine: Dict[str, List[dict]] = {}
    for sp in spans:
        if sp['thread'] == main_thread:
            mine.setdefault(sp['name'], []).append(sp)
    theirs: Dict[str, List[tuple]] = {}
    for r in ranges:
        if r[2] in mine:
            theirs.setdefault(r[2], []).append(r)
    worst = None
    for name, ours in mine.items():
        rs = theirs.get(name, [])
        if len(rs) != len(ours):
            continue
        for sp, (s, e, _) in zip(sorted(ours, key=lambda d: d['s']), rs):
            off = max(0.0, sp['s'] - s, e - sp['e'])
            worst = off if worst is None else max(worst, off)
    return worst


def clock_ok(prof: Optional[dict]) -> bool:
    if not prof:
        return False
    off = clock_offset_us(prof['spans'], prof['ranges'], prof['main_thread'])
    return off is not None and off <= MAX_OFFSET_US


# ------------------------------------------------ innermost span segments
def segments(spans: List[dict]) -> List[Tuple[float, float, str]]:
    """One thread's spans as the stretches in which each is the innermost
    open span: its interval less its children's, sorted."""
    ids = {sp['id'] for sp in spans}
    kids: Dict[Optional[int], List[dict]] = {}
    for sp in spans:
        parent = sp['parent'] if sp['parent'] in ids else None
        kids.setdefault(parent, []).append(sp)
    out = []
    for sp in spans:
        t = sp['s']
        for c in sorted(kids.get(sp['id'], []), key=lambda d: d['s']):
            if c['s'] > t:
                out.append((t, c['s'], sp['name']))
            t = max(t, c['e'])
        if sp['e'] > t:
            out.append((t, sp['e'], sp['name']))
    out.sort()
    return out


def overlap_by_name(intervals: Sequence[Tuple[float, float]],
                    segs: List[Tuple[float, float, str]],
                    outside: str) -> Dict[str, float]:
    """How long each segment's name overlaps ``intervals`` (sorted), µs;
    time no segment covers goes to ``outside``."""
    starts = [s for s, _, _ in segs]
    out: Dict[str, float] = {}
    for a, b in intervals:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, name = segs[i]
            d = min(b, e) - max(a, s)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
                covered += d
            i += 1
        if b - a > covered:
            out[outside] = out.get(outside, 0.0) + (b - a - covered)
    return out


def idle_gaps(device: Sequence[tuple]) -> List[Tuple[float, float]]:
    """The stretches between the first and the last device event in which
    none ran."""
    gaps, end = [], None
    for s, e, *_ in device:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_by_span(prof: Optional[dict]) -> Optional[dict]:
    """The device's idle time of a profiled stretch, in ms, split over the
    innermost program span open on the main thread, which issues the
    work; and the part under ``loader.wait`` split over what each loader
    thread was in (thread-ms). None where the clock check fails."""
    if not clock_ok(prof) or not prof['device']:
        return None
    gaps = idle_gaps(prof['device'])
    by_thread: Dict[int, List[dict]] = {}
    for sp in prof['spans']:
        by_thread.setdefault(sp['thread'], []).append(sp)
    main = segments(by_thread.pop(prof['main_thread'], []))
    main_ms = {k: v / 1e3 for k, v in overlap_by_name(
        gaps, main, 'outside program spans').items()}
    waits = [(max(a, s), min(b, e)) for a, b in gaps
             for s, e, name in main if name == 'loader.wait'
             and min(b, e) > max(a, s)]
    waits.sort()
    loader: Dict[str, float] = {}
    for spans in by_thread.values():
        for name, us in overlap_by_name(waits, segments(spans),
                                        'loader: no span').items():
            loader[name] = loader.get(name, 0.0) + us / 1e3
    return dict(main_ms=_sorted(main_ms), under_loader_wait_thread_ms=(
        _sorted(loader) if loader else None))


def _sorted(d: Dict[str, float]) -> Dict[str, float]:
    return dict(sorted(d.items(), key=lambda kv: -kv[1]))


# -------------------------------------------------------- host readings
def named(spans: Optional[List[dict]], name: str) -> List[dict]:
    return [sp for sp in spans or () if sp['name'] == name]


def total_ms(spans: Optional[List[dict]], name: str) -> Optional[float]:
    hits = named(spans, name)
    if not hits:
        return None
    return sum(sp['e'] - sp['s'] for sp in hits) / 1e3


def per_item_ms(spans: Optional[List[dict]], name: str,
                items: int) -> Optional[float]:
    """Summed ms of the spans named ``name`` over ``items``."""
    total = total_ms(spans, name)
    return None if total is None or not items else total / items


def mean_ms(spans: Optional[List[dict]], name: str) -> Optional[float]:
    hits = named(spans, name)
    return total_ms(spans, name) / len(hits) if hits else None


def per_attr_ms(spans: Optional[List[dict]], name: str,
                attr: str) -> Optional[float]:
    """Summed ms of the spans named ``name`` over the sum of their
    ``attr``."""
    hits = named(spans, name)
    count = sum(sp['attrs'].get(attr, 0) for sp in hits)
    return total_ms(spans, name) / count if hits and count else None


def children_ms(spans: Optional[List[dict]], parent: str
                ) -> Optional[Dict[str, float]]:
    """Mean ms per ``parent`` span of each child's name, and of
    ``self``: what no child covers."""
    parents = {sp['id']: sp for sp in named(spans, parent)}
    if not parents:
        return None
    out: Dict[str, float] = {}
    covered = 0.0
    for sp in spans:
        if sp['parent'] in parents:
            d = (sp['e'] - sp['s']) / 1e3
            out[sp['name']] = out.get(sp['name'], 0.0) + d
            covered += d
    whole = sum(p['e'] - p['s'] for p in parents.values()) / 1e3
    out['self'] = whole - covered
    return {k: v / len(parents) for k, v in _sorted(out).items()}


# ------------------------------------------------------ device readings
def launches_within(prof: Optional[dict], name: str
                    ) -> Optional[Tuple[int, int]]:
    """(launch calls whose start lies inside a span named ``name``, the
    number of such spans); None where the clock check fails or no such
    span was recorded."""
    if not clock_ok(prof):
        return None
    spans = sorted((sp['s'], sp['e']) for sp in named(prof['spans'], name))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    n = 0
    for s, _, call, _ in prof['launches']:
        if not call.startswith(LAUNCH_CALLS):
            continue
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            n += 1
    return n, len(spans)


def device_ms_within(prof: Optional[dict], name: str) -> Optional[float]:
    """Summed device ms of the kernels and copies whose launch or copy
    call lies inside a span named ``name`` (tied by the profiler's
    correlation ids); None where the clock check fails or no such span
    was recorded."""
    if not clock_ok(prof):
        return None
    spans = sorted((sp['s'], sp['e']) for sp in named(prof['spans'], name))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    inside = set()
    for s, _, _, corr in prof['launches']:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s <= spans[i][1]:
            inside.add(corr)
    return sum(e - s for s, e, _, corr in prof['device']
               if corr in inside) / 1e3


# ------------------------------------------- the six per-layer readings
def loader_wait_ms(host: Optional[List[dict]], videos: int):
    """Mean ms the eval loop waits on the loader, a video."""
    return per_item_ms(host, 'loader.wait', videos)


def decode_ms_per_frame(host: Optional[List[dict]]):
    """nvJPEG decode calls' ms over the frames they decoded."""
    return per_attr_ms(host, 'decode.nvjpeg', 'frames')


def upload_ms(host: Optional[List[dict]], videos: int):
    """Pageable upload ms, a video."""
    return per_item_ms(host, 'upload.pageable', videos)


def host_step_ms(host: Optional[List[dict]]):
    """Mean host ms of a train step's call."""
    return mean_ms(host, 'train.step')


def mvf_device_ms(prof: Optional[dict], videos: int):
    """Device ms, a video, of the work launched inside ``model.mvf``."""
    ms = device_ms_within(prof, 'model.mvf')
    return None if ms is None or not videos else ms / videos


def launches_per_step(prof: Optional[dict]):
    """Kernel launch calls inside ``train.step``, a step."""
    got = launches_within(prof, 'train.step')
    return None if got is None else got[0] / got[1]
