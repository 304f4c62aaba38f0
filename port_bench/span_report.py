"""The program's spans in one cell: a spans-off window, then two
stretches with the spans on.

    python3 port_bench/span_report.py --workload NAME --seed N --seconds S

From the root of a checkout, on the card. Runs the cell's set-up and its
spans-off window (the driver's ``window``) for ``--seconds``, as
``run.py`` does, then:

(a) spans on, unprofiled: whole requests, steps or passes for at least
    ``SPANS_SECONDS`` in ``BLOCKS`` blocks, each followed by a spans-off
    block of the same length. It gives the host-clock span readings and
    the on-cost of tracing: wall per item with spans on over wall per item
    of the window, and over that of the spans-off blocks beside it. It
    runs before any profiler in the process: the first seconds after a
    ``torch.profiler`` session run slower on the card.
(b) spans on, profiled: the cell's profiled count of requests, steps or
    passes (one pass in the test CLI), which gives the device-trace span
    readings and the idle gaps split over the program's spans
    (``lib/spans.py``).

The stretches call the drivers' public ``request``, ``train`` and
``evaluate``. Prints ``trace: span clock offset_us``, ``trace: spans
on-cost`` and ``trace: idle by span`` on standard error and, last on
standard output, one JSON object: the six span readings, the host splits
of the spans, the rates of the spans that carry bytes and the stretches'
sizes. The run's answers are not checked: ``run.py`` checks them. Where
the program records no spans, each reading is None.

Exits non-zero, printing no reading, without CUDA and when a module of JAX
or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Tuple

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench.lib import harness, spans  # noqa: E402


SPANS_SECONDS = 5.0
BLOCKS = 2


def one(run, i: int) -> None:
    """Request, step or pass ``i`` of a stretch through the driver's
    public call; a train step reads its metrics every ``log_interval``
    steps, as the driver's window does."""
    if run.kind == 'dense':
        run.request(i)
    elif run.kind == 'train':
        m = run.train(run.workload['check_steps'] + i)
        if (i + 1) % run.workload['log_interval'] == 0:
            float(m['loss'])
            float(m['grad_norm'])
    else:
        run.evaluate()


def stretch(run, count=None, seconds=None) -> Tuple[int, float]:
    """Whole requests (dense), steps (train) or passes (cli) back to back,
    ``count`` of them or until ``seconds`` have passed, ending with the
    device synchronized; (requests, steps or videos; seconds)."""
    n = 0
    t0 = time.perf_counter()
    while not ((count is not None and n >= count) or
               (seconds is not None and time.perf_counter() - t0 >= seconds)):
        one(run, n)
        n += 1
    sync(run)
    return (n * (len(run.dataset) if run.kind == 'cli' else 1),
            time.perf_counter() - t0)


def profiled_count(run) -> int:
    w = run.workload
    return w.get('profiled_requests', w.get('profiled_steps', 1))


def sync(run) -> None:
    import torch
    if run.device.type == 'cuda':
        torch.cuda.synchronize(run.device)


def readings(run, host, host_items, prof, prof_items) -> dict:
    """The six per-layer span readings of the cell's kind (None where the
    program recorded nothing to read)."""
    if run.kind == 'cli':
        return {'loader_wait_ms.cli': spans.loader_wait_ms(host, host_items),
                'decode_ms_per_frame.cli': spans.decode_ms_per_frame(host)}
    if run.kind == 'dense':
        return {'upload_ms.dense': spans.upload_ms(host, host_items),
                'mvf_device_ms.dense': spans.mvf_device_ms(prof, prof_items)}
    return {'host_step_ms.train': spans.host_step_ms(host),
            'launches_per_step.train': spans.launches_per_step(prof)}


def host_splits(run, host) -> dict:
    """Mean ms of each child span inside the cell's top spans."""
    parents = {'dense': ('step.eval',),
               'train': ('train.step',),
               'cli': ('eval.pass', 'data.getitem', 'data.op.FrameSelector',
                       'step.eval')}[run.kind]
    return {p: spans.children_ms(host, p) for p in parents}


def rates(host) -> dict:
    """GB/s of the spans that carry ``bytes``: the JPEGs nvJPEG decoded,
    the pinned and the pageable uploads (None where none ran)."""
    out = {}
    for name in ('decode.nvjpeg', 'upload.stage', 'upload.pageable'):
        ms = spans.per_attr_ms(host, name, 'bytes')
        out[name] = None if ms is None else 1e-6 / ms
    return out


def span_stretches(run, window_item_s: float,
                   seconds: float = SPANS_SECONDS) -> dict:
    """Stretches (a) and (b) on a set-up run whose spans-off window gave
    ``window_item_s`` seconds an item. (a) alternates ``BLOCKS`` times a
    spans-on and a spans-off block of ``seconds / BLOCKS`` each, so that
    the on-cost is also read against spans-off work in the same
    conditions; it runs before any profiler session of the process (the
    seconds after one run slower)."""
    host, on, off = [], [0, 0.0], [0, 0.0]
    for _ in range(BLOCKS):
        box = {}

        def a():
            box['served'] = stretch(run, seconds=seconds / BLOCKS)
        host += spans.record(a) or []
        on[0] += box['served'][0]
        on[1] += box['served'][1]
        served = stretch(run, seconds=seconds / BLOCKS)
        off[0] += served[0]
        off[1] += served[1]

    box = {}

    def b():
        box['profiled'] = stretch(run, count=profiled_count(run))
    prof = spans.profile(b)
    prof_items = box['profiled'][0]
    offset = (spans.clock_offset_us(prof['spans'], prof['ranges'],
                                    prof['main_thread']) if prof else None)
    on_item_s = on[1] / on[0]
    return dict(
        readings=readings(run, host, on[0], prof, prof_items),
        spans_on_cost=on_item_s / window_item_s,
        spans_on_cost_adjacent=on_item_s / (off[1] / off[0]),
        span_clock_offset_us=offset,
        idle_by_span=spans.idle_by_span(prof),
        host_splits_ms=host_splits(run, host),
        gb_per_s=rates(host),
        window_item_s=window_item_s,
        stretch_a=dict(items=on[0], seconds=on[1], spans=len(host or ()),
                       off_items=off[0], off_seconds=off[1]),
        stretch_b=dict(items=prof_items, wall_s=prof and prof['wall_s'],
                       spans=len(prof['spans']) if prof else 0,
                       device_events=len(prof['device']) if prof else 0,
                       launch_calls=len(prof['launches']) if prof else 0))


def fail(msg: str, code: int = 2):
    print(f'port_bench: {msg}', file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.load_json(os.path.join(
        harness.ROOT, harness.config_entry(bench, cell['config'])['file']))
    workload = harness.workload_file(cell['name'])
    import torch
    if not torch.cuda.is_available():
        fail('CUDA is not available: the span report runs only on the card')
    device = torch.device('cuda', 0)
    run = harness.load_module('drivers', workload['driver']).Bench(
        config, workload, args.seed, device)
    run.setup()
    sync(run)
    setup_s = time.perf_counter() - T_START

    run.window(args.seconds)
    out = span_stretches(run, run.served[1] / run.served[0])
    run.release()
    if getattr(run, 'root', None):
        import shutil
        shutil.rmtree(run.root, ignore_errors=True)

    out.update(workload=cell['name'], seed=args.seed, setup_s=setup_s,
               device=torch.cuda.get_device_name(device))
    report(out)


def report(out: dict) -> None:
    """The three ``trace:`` lines and the JSON object, after the check
    that no module of JAX or of the JAX package was loaded (exit 3, and
    nothing printed, where one was)."""
    bad = harness.forbidden_modules()
    print(f'check forbidden_modules: {bad} (top-level '
          f'{", ".join(harness.FORBIDDEN)})', file=sys.stderr)
    if bad:
        fail(f'modules of JAX or of the JAX package were loaded: {bad}', 3)
    print(f'trace: span clock offset_us {out["span_clock_offset_us"]}',
          file=sys.stderr)
    print(f'trace: spans on-cost {out["spans_on_cost"]} (against the '
          f'adjacent spans-off blocks: {out["spans_on_cost_adjacent"]})',
          file=sys.stderr)
    print(f'trace: idle by span {json.dumps(out["idle_by_span"])}',
          file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
