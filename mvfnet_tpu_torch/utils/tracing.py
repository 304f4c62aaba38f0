"""Spans: named, timed stretches of the port's host work, off unless asked.

    from mvfnet_tpu_torch.utils import tracing
    tracing.enable()
    with tracing.span('decode.nvjpeg', frames=80, bytes=n):
        ...
    spans = tracing.collect()

Off, the default, ``span`` checks one module flag and returns a shared
no-op context manager: it records nothing, reads no clock and enters no
``record_function`` (the call's own arguments, its attrs, are still
evaluated). On (``enable()``), each span records its name, its
start and end on ``time.perf_counter_ns()``, its thread, the id of the span
open around it on the same thread (its parent) and its attrs, in a list of
its own thread; ``collect()`` merges the lists. While a ``torch.profiler``
records, an enabled span also enters ``record_function(name)``, which puts
it on the profiler's timeline and ties the kernels launched inside it to
it. At most ``MAX_SPANS`` spans are kept between two ``clear()`` calls;
the rest are counted by ``dropped()``.

Names are ``<layer>.<what>``, after PERF.md's layers. Counts ride on spans
as attrs (``frames``, ``bytes``), and ``req`` names the request a span
serves (a dataset index, a step's number); ``collect`` gives a span
without ``req`` its nearest ancestor's. ``write_chrome(path)`` writes the
spans as Chrome trace-event JSON, which Perfetto and ``chrome://tracing``
load.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch.autograd.profiler as _profiler

MAX_SPANS = 1 << 20

_on = False
_ids = itertools.count()
_base = 0                      # the first id since the last clear()
_lock = threading.Lock()
_stores: List['_Store'] = []
_local = threading.local()


class _NoSpan:
    """The shared span of ``span()`` while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Store:
    """One thread's records and its stack of open span ids."""

    __slots__ = ('thread', 'thread_name', 'alive', 'records', 'stack',
                 'dropped')

    def __init__(self):
        current = threading.current_thread()
        self.thread = threading.get_native_id()
        self.thread_name = current.name
        self.alive = current.is_alive
        self.records: List[tuple] = []
        self.stack: List[int] = []
        self.dropped = 0


def _store() -> _Store:
    try:
        return _local.store
    except AttributeError:
        store = _local.store = _Store()
        with _lock:
            _stores.append(store)
        return store


class _Span:
    __slots__ = ('name', 'attrs', 'id', 'parent', 'store', 'rf', 'start')

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        store = self.store = _store()
        self.id = next(_ids)
        self.parent = store.stack[-1] if store.stack else None
        store.stack.append(self.id)
        # the stamps enclose the profiler's range of the span
        self.start = time.perf_counter_ns()
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.perf_counter_ns()
        store = self.store
        store.stack.pop()
        if self.id - _base < MAX_SPANS:
            store.records.append((self.id, self.parent, self.name,
                                  self.start, end, self.attrs))
        else:
            store.dropped += 1
        return False


def span(name: str, **attrs):
    """A context manager over one stretch of work named ``name``; the
    shared ``NO_SPAN`` while tracing is off."""
    if not _on:
        return NO_SPAN
    return _Span(name, attrs)


def span_backward(name: str, output, last=None) -> None:
    """While tracing is on, span ``name`` over the backward of the work
    that made ``output``: the span opens when ``output``'s gradient node
    is about to run and closes when ``last``'s (``output``'s own when
    None) has run, on the thread that runs the backward. It hooks the
    autograd graph and adds no node to it, so gradients are unchanged;
    off, or with no graph, it does nothing. ``last`` is the earliest
    result of the spanned work in the forward, whose node runs last."""
    end = output if last is None else last
    if not _on or output.grad_fn is None or end.grad_fn is None:
        return
    opened = []

    def enter(grad_outputs):
        s = span(name)
        s.__enter__()
        opened.append(s)

    def leave(grad_inputs, grad_outputs):
        if opened:
            opened.pop().__exit__(None, None, None)

    output.grad_fn.register_prehook(enter)
    end.grad_fn.register_hook(leave)


def enable() -> None:
    """Turn spans on."""
    global _on
    _on = True


def disable() -> None:
    """Turn spans off; what was recorded stays until ``clear()``."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Forget every recorded span and the drop count."""
    global _base
    with _lock:
        _base = next(_ids) + 1
        _stores[:] = [s for s in _stores if s.alive()]
        for s in _stores:
            s.records = []
            s.dropped = 0


def dropped() -> int:
    """Spans not kept since the last ``clear()``: past ``MAX_SPANS``."""
    with _lock:
        return sum(s.dropped for s in _stores)


def collect() -> List[Dict[str, Any]]:
    """Every span recorded since the last ``clear()``, by start: ``id``,
    ``parent`` (None at a thread's top), ``name``, ``start_ns`` and
    ``end_ns`` (``time.perf_counter_ns``), ``thread`` (native id),
    ``thread_name`` and ``attrs``, where a span without ``req`` carries its
    nearest ancestor's."""
    with _lock:
        stores = list(_stores)
    out = [dict(id=i, parent=parent, name=name, start_ns=start, end_ns=end,
                thread=s.thread, thread_name=s.thread_name, attrs=attrs)
           for s in stores for i, parent, name, start, end, attrs
           in list(s.records)]
    out.sort(key=lambda d: (d['start_ns'], d['id']))
    by_id = {d['id']: d for d in out}
    for d in out:               # a parent starts before its children
        parent = by_id.get(d['parent'])
        if 'req' not in d['attrs'] and parent is not None \
                and 'req' in parent['attrs']:
            d['attrs'] = dict(d['attrs'], req=parent['attrs']['req'])
    return out


def write_chrome(path: str) -> None:
    """Write the spans (``collect()``) as Chrome trace-event JSON: one
    complete event a span (µs on ``perf_counter``'s clock, attrs as args)
    and the threads' names."""
    spans = collect()
    pid = os.getpid()
    events = [dict(name='thread_name', ph='M', pid=pid, tid=tid,
                   args=dict(name=name))
              for tid, name in sorted({(s['thread'], s['thread_name'])
                                       for s in spans})]
    events += [dict(name=s['name'], cat=s['name'].split('.')[0], ph='X',
                    ts=s['start_ns'] / 1e3,
                    dur=(s['end_ns'] - s['start_ns']) / 1e3, pid=pid,
                    tid=s['thread'], args=s['attrs']) for s in spans]
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(dict(traceEvents=events, displayTimeUnit='ms'), f,
                  default=_plain)


def _plain(value):
    """An attr JSON cannot write: a numpy scalar's number, else its
    text."""
    return value.item() if hasattr(value, 'item') else str(value)


@contextlib.contextmanager
def recording(path: Optional[str], rank: int = 0):
    """Spans on for the block and written to ``path`` at its end, even when
    it raises (``write_chrome``; rank r > 0 of a process group writes
    ``<stem>.rank<r><ext>``); nothing at all where ``path`` is None."""
    if path is None:
        yield
        return
    if rank:
        stem, ext = os.path.splitext(path)
        path = f'{stem}.rank{rank}{ext}'
    was_on = _on
    clear()
    enable()
    try:
        yield
    finally:
        if not was_on:
            disable()
        write_chrome(path)
        clear()
