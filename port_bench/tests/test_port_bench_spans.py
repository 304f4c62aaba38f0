"""The span readers of ``lib/spans.py`` on synthetic traced data: the six
readings, the host splits, the idle split over the program's spans, the
clock check that silences the device-trace readings, and None wherever the
program recorded no span (a program without spans)."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench import span_report  # noqa: E402
from port_bench.lib import spans  # noqa: E402

MAIN, LOADER = 1, 2


def sp(i, name, s, e, parent=None, thread=MAIN, **attrs):
    return dict(id=i, parent=parent, name=name, s=float(s), e=float(e),
                thread=thread, attrs=attrs)


def test_host_readings():
    host = [sp(0, 'loader.wait', 0, 3000), sp(1, 'loader.wait', 5000, 6000),
            sp(2, 'decode.nvjpeg', 0, 800, thread=LOADER, frames=8),
            sp(3, 'decode.nvjpeg', 1000, 1400, thread=LOADER, frames=2),
            sp(4, 'upload.pageable', 0, 9000, bytes=10),
            sp(5, 'train.step', 0, 60000), sp(6, 'train.step', 60000, 130000)]
    assert spans.loader_wait_ms(host, 2) == pytest.approx(2.0)
    assert spans.decode_ms_per_frame(host) == pytest.approx(0.12)
    assert spans.upload_ms(host, 3) == pytest.approx(3.0)
    assert spans.host_step_ms(host) == pytest.approx(65.0)
    for empty in (None, []):
        assert spans.loader_wait_ms(empty, 2) is None
        assert spans.decode_ms_per_frame(empty) is None
        assert spans.upload_ms(empty, 3) is None
        assert spans.host_step_ms(empty) is None


def test_children_split():
    host = [sp(0, 'train.step', 0, 10000), sp(1, 'train.forward', 0, 3000, 0),
            sp(2, 'train.backward', 3000, 9000, 0),
            sp(3, 'train.step', 10000, 20000),
            sp(4, 'train.forward', 10000, 14000, 3),
            sp(5, 'train.backward', 14000, 19000, 3)]
    assert spans.children_ms(host, 'train.step') == {
        'train.backward': 5.5, 'train.forward': 3.5, 'self': 1.0}
    assert spans.children_ms(host, 'step.eval') is None


def prof(device, launches, spans_, ranges):
    return dict(device=device, launches=launches, spans=spans_,
                ranges=ranges, main_thread=MAIN, wall_s=1.0)


def step_prof(shift=0.0):
    steps = [sp(0, 'train.step', 100 + shift, 200 + shift),
             sp(1, 'train.step', 300 + shift, 400 + shift)]
    ranges = [(102, 198, 'train.step'), (301, 399, 'train.step'),
              (0, 1000, 'bench.train_step')]
    launches = [(150, 151, 'cudaLaunchKernel', 1),
                (160, 161, 'cuLaunchKernelEx', 2),
                (170, 171, 'cudaMemcpyAsync', 3),
                (350, 351, 'cudaLaunchKernel', 4),
                (450, 451, 'cudaLaunchKernel', 5)]
    device = [(152, 170, 'k1', 1), (171, 175, 'k2', 2),
              (176, 180, 'Memcpy HtoD', 3), (352, 360, 'k4', 4),
              (452, 460, 'k5', 5)]
    return prof(device, launches, steps, ranges)


def test_device_readings_and_the_clock_check():
    p = step_prof()
    assert spans.clock_offset_us(p['spans'], p['ranges'], MAIN) == 0.0
    assert spans.launches_per_step(p) == 1.5
    # the kernels and the copy launched inside the spans
    assert spans.device_ms_within(p, 'train.step') == pytest.approx(0.034)
    p['spans'] = [dict(s, name='model.mvf') for s in p['spans']]
    p['ranges'] = [(s, e, 'model.mvf') for s, e, _ in p['ranges'][:2]]
    assert spans.mvf_device_ms(p, 2) == pytest.approx(0.017)
    # a map 60 us off: the ranges reach outside their spans, nothing reads
    bad = step_prof(shift=60.0)
    assert spans.clock_offset_us(bad['spans'], bad['ranges'],
                                 MAIN) == pytest.approx(59.0)
    assert spans.launches_per_step(bad) is None
    assert spans.mvf_device_ms(bad, 2) is None
    # no span recorded, or no profile: nothing to read
    empty = prof(p['device'], p['launches'], [], [])
    assert spans.launches_per_step(empty) is None
    assert spans.mvf_device_ms(None, 2) is None
    assert spans.idle_by_span(None) is None


def test_idle_split_over_the_main_threads_innermost_spans():
    main = [sp(0, 'eval.pass', 0, 1000), sp(1, 'loader.wait', 100, 400, 0),
            sp(2, 'step.eval', 400, 900, 0)]
    loader = [sp(3, 'data.getitem', 0, 600, thread=LOADER),
              sp(4, 'data.op.FrameSelector', 50, 300, 3, thread=LOADER)]
    device = [(0, 50, 'k', 1), (350, 500, 'k', 2), (600, 700, 'k', 3),
              (950, 1100, 'k', 4)]
    ranges = [(0, 1000, 'eval.pass'), (100, 400, 'loader.wait'),
              (400, 900, 'step.eval')]
    got = spans.idle_by_span(prof(device, [], main + loader, ranges))
    # gaps 50-350, 500-600, 700-950
    assert got['main_ms'] == pytest.approx({
        'loader.wait': 0.25, 'step.eval': 0.3, 'eval.pass': 0.1})
    assert got['under_loader_wait_thread_ms'] == pytest.approx({
        'data.op.FrameSelector': 0.2, 'data.getitem': 0.05})


def test_segments_are_the_innermost_stretches():
    s = [sp(0, 'a', 0, 10), sp(1, 'b', 2, 4, 0), sp(2, 'c', 6, 8, 0)]
    assert spans.segments(s) == [(0, 2, 'a'), (2, 4, 'b'), (4, 6, 'a'),
                                 (6, 8, 'c'), (8, 10, 'a')]
    assert spans.overlap_by_name([(1, 3), (9, 12)], spans.segments(s),
                                 'out') == {'a': 2.0, 'b': 1.0, 'out': 2.0}


def test_clock_map_is_the_line_through_its_pairs():
    m = spans.ClockMap((1000, 5000), (3000, 7002))
    assert m.unix_ns(2000) == pytest.approx(6001)
    assert m.trace_us(2000, 1) == pytest.approx(6.0)
    a, b = spans.clock_pair(), spans.clock_pair()
    assert b[0] >= a[0]


def test_span_report_refuses_without_cuda(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(span_report.harness, 'set_cache_dirs', lambda: None)
    with pytest.raises(SystemExit) as e:
        span_report.main(['--workload', 'r50_dense', '--seed', '1',
                          '--seconds', '1'])
    assert e.value.code == 2
    assert capsys.readouterr().out == ''


def test_span_report_prints_nothing_with_jax_loaded(monkeypatch, capsys):
    out = dict(span_clock_offset_us=0.0, spans_on_cost=1.0,
               spans_on_cost_adjacent=1.0, idle_by_span=None)
    monkeypatch.setattr(span_report.harness, 'forbidden_modules',
                        lambda: ['jax'])
    with pytest.raises(SystemExit) as e:
        span_report.report(out)
    assert e.value.code == 3
    got = capsys.readouterr()
    assert got.out == '' and 'trace:' not in got.err
    monkeypatch.setattr(span_report.harness, 'forbidden_modules', lambda: [])
    span_report.report(out)
    got = capsys.readouterr()
    assert json.loads(got.out.splitlines()[-1]) == out
    assert [line.split(' ')[1] for line in got.err.splitlines()
            if line.startswith('trace:')] == ['span', 'spans', 'idle']
