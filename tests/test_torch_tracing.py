"""The port's spans (``mvfnet_tpu_torch.utils.tracing``) on the CPU.

Off, ``span`` hands back one shared no-op and reads no clock; on, spans
nest per thread, carry their request, stay within their bound and, under
a CPU-only torch.profiler, map onto the profiler's ranges of the same
names with the benchmark's clock map (``port_bench/lib/spans.py``). The
eval loop, the pipeline, the train step, MVF and the int8 ranges record
the spans PERF.md names, and ``write_chrome`` writes them for Perfetto.
"""

import concurrent.futures as cf
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch
import torch.nn as nn

from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.engine.eval import evaluate_dataset
from mvfnet_tpu_torch.engine.optim import build_optimizer
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import common
from mvfnet_tpu_torch.models.modules.mvf import MVF
from mvfnet_tpu_torch.utils import tracing

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
sys.path.insert(0, REPO)

from port_bench.lib import spans as bench_spans  # noqa: E402


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def names(spans):
    return [s['name'] for s in spans]


def test_off_returns_the_shared_no_op_and_reads_no_clock(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('a clock or a profiler range was used')
    monkeypatch.setattr(tracing.time, 'perf_counter_ns', refuse)
    monkeypatch.setattr(tracing._profiler, 'record_function', refuse)
    assert not tracing.enabled()
    a = tracing.span('loader.wait', req=3)
    b = tracing.span('model.mvf')
    assert a is b is tracing.NO_SPAN
    with a, b:
        pass
    assert tracing.collect() == [] and tracing.dropped() == 0


def test_on_nests_per_thread_and_carries_the_request():
    tracing.enable()
    with tracing.span('eval.pass'):
        with tracing.span('step.eval', req=7):
            with tracing.span('step.forward'):
                pass
        with tracing.span('eval.scores'):
            pass

    def item(i):
        with tracing.span('data.getitem', req=i):
            with tracing.span('data.op.Resize'):
                pass
        return tracing._store().thread
    with cf.ThreadPoolExecutor(2) as pool:
        threads = set(pool.map(item, range(6)))
    got = tracing.collect()
    by = {s['id']: s for s in got}
    main = [s for s in got if s['thread_name'] == 'MainThread']
    assert names(main) == ['eval.pass', 'step.eval', 'step.forward',
                           'eval.scores']
    top, step, fwd, scores = main
    assert top['parent'] is None and step['parent'] == top['id']
    assert fwd['parent'] == step['id'] and scores['parent'] == top['id']
    assert fwd['attrs'] == {'req': 7} and scores['attrs'] == {}
    assert all(s['start_ns'] <= s['end_ns'] for s in got)
    loader = [s for s in got if s['thread'] in threads]
    assert len(loader) == 12 and {s['thread'] for s in loader} == threads
    for s in loader:
        if s['name'] == 'data.op.Resize':
            parent = by[s['parent']]
            assert parent['name'] == 'data.getitem'
            assert parent['thread'] == s['thread']
            assert s['attrs']['req'] == parent['attrs']['req']
    assert sorted(s['attrs']['req'] for s in loader
                  if s['name'] == 'data.getitem') == list(range(6))


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, 'MAX_SPANS', 5)
    tracing.enable()
    tracing.clear()
    for i in range(8):
        with tracing.span('loader.wait', req=i):
            pass
    assert [s['attrs']['req'] for s in tracing.collect()] == list(range(5))
    assert tracing.dropped() == 3
    tracing.clear()
    assert tracing.collect() == [] and tracing.dropped() == 0


def test_many_threads_lose_no_span():
    tracing.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(t):
            for i in range(300):
                with tracing.span('data.getitem', req=(t, i)):
                    with tracing.span('data.op.Resize'):
                        pass
        with cf.ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            list(pool.map(worker, range(24), timeout=60))
    finally:
        sys.setswitchinterval(old)
    got = tracing.collect()
    assert len(got) == 24 * 300 * 2 and tracing.dropped() == 0
    assert len({s['id'] for s in got}) == len(got)
    by = {s['id']: s for s in got}
    assert all(by[s['parent']]['attrs']['req'] == s['attrs']['req']
               for s in got if s['name'] == 'data.op.Resize')


def _work():
    x = torch.randn(64, 64)
    for _ in range(3):
        with tracing.span('step.eval'):
            with tracing.span('step.forward'):
                x = torch.tanh(x @ x) / 8


def test_spans_map_onto_the_profilers_ranges():
    prof = bench_spans.profile(_work)
    assert prof['launches'] == [] and prof['device'] == []
    main = [s for s in prof['spans'] if s['thread'] == prof['main_thread']]
    assert names(main) == ['step.eval', 'step.forward'] * 3
    ranges = [r for r in prof['ranges'] if r[2].startswith('step.')]
    assert len(ranges) == 6
    off = bench_spans.clock_offset_us(prof['spans'], prof['ranges'],
                                      prof['main_thread'])
    assert off is not None and off <= bench_spans.MAX_OFFSET_US
    for name in ('step.eval', 'step.forward'):
        mine = [s for s in main if s['name'] == name]
        theirs = [r for r in ranges if r[2] == name]
        for s, (a, b, _) in zip(mine, theirs):
            assert s['s'] - 50 <= a <= b <= s['e'] + 50
    # a map 500 us off is caught
    shifted = [dict(s, s=s['s'] + 500, e=s['e'] + 500)
               for s in prof['spans']]
    assert bench_spans.clock_offset_us(shifted, prof['ranges'],
                                       prof['main_thread']) > 400


def test_spans_enter_no_profiler_range_while_off():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _work()
    assert not [e for e in prof.events() if e.name.startswith('step.')]


class TinyRecognizer(nn.Module):
    """Enough of a recognizer for the eval and train steps: a linear head
    over the frames' mean colour."""

    compute_dtype = torch.float32

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        self.cls_head = nn.Module()
        self.fc = nn.Linear(3, 4)

    def forward(self, imgs, labels=None, return_loss=False,
                generator=None):
        scores = self.fc(imgs.float().flatten(1, -2).mean(1))
        if not return_loss:
            return scores.softmax(-1)
        return dict(loss_cls=nn.functional.cross_entropy(scores, labels))


OPS = ['SampleFrames', 'FrameSelector', 'Resize', 'CenterCrop',
       'FormatShape', 'Collect']


def tiny_dataset(root):
    rng = np.random.default_rng(0)
    lines = []
    for v in range(3):
        os.makedirs(os.path.join(root, f'v{v}'))
        for t in range(6):
            img = rng.integers(0, 255, (18, 24, 3), dtype=np.uint8)
            cv2.imwrite(os.path.join(root, f'v{v}', f'img_{t + 1:05}.jpg'),
                        img)
        lines.append(f'v{v} 6 {v}\n')
    ann = os.path.join(root, 'ann.txt')
    with open(ann, 'w') as f:
        f.writelines(lines)
    pipeline = [dict(type='SampleFrames', clip_len=2, frame_interval=1,
                     num_clips=1),
                dict(type='FrameSelector', use_native=False),
                dict(type='Resize', scale=(float('inf'), 16),
                     keep_ratio=True),
                dict(type='CenterCrop', crop_size=16),
                dict(type='FormatShape', input_format='NHWC'),
                dict(type='Collect', keys=['img_group', 'label'],
                     meta_keys=[])]
    return build_dataset(dict(type='RawFramesDataset', ann_file=ann,
                              data_root=root, pipeline=pipeline,
                              test_mode=True))


def test_evaluate_dataset_spans_each_wait_item_and_op(tmp_path):
    dataset = tiny_dataset(str(tmp_path))
    model = TinyRecognizer()
    tracing.enable()
    scores = evaluate_dataset(model, dataset, videos_per_gpu=1,
                              workers_per_gpu=2, device='cpu')
    got = tracing.collect()
    assert scores.shape == (3, 4)
    count = {n: names(got).count(n) for n in set(names(got))}
    assert count.pop('eval.pass') == count.pop('eval.setup') == 1
    assert count.pop('eval.scores') == 1
    assert count.pop('loader.wait') == count.pop('loader.collate') == 3
    assert count.pop('data.getitem') == 3
    assert count.pop('step.eval') == count.pop('step.normalize') == 3
    assert count.pop('step.forward') == 3
    assert count == {f'data.op.{op}': 3 for op in OPS}
    waits = sorted(s['attrs']['req'] for s in got
                   if s['name'] == 'loader.wait')
    assert waits == [0, 1, 2]
    for s in got:
        if s['name'].startswith('data.op.'):
            assert s['thread_name'] != 'MainThread' and 'req' in s['attrs']
    # the loader threads' getitems pair with the main thread's waits
    items = {s['attrs']['req']: s for s in got if s['name'] == 'data.getitem'}
    assert sorted(items) == waits
    for s in got:
        if s['name'] == 'loader.wait':
            assert items[s['attrs']['req']]['start_ns'] <= s['end_ns']


def test_train_step_phases_nest_in_order():
    model = TinyRecognizer()
    schedule = lambda t: 0.1  # noqa: E731
    optimizer = build_optimizer(
        model, dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-4),
        schedule, grad_clip=dict(max_norm=40))
    step = make_train_step(model, optimizer, schedule, device='cpu')
    imgs = np.random.default_rng(1).integers(0, 255, (2, 4, 8, 8, 3),
                                             dtype=np.uint8)
    tracing.enable()
    for _ in range(2):
        step(imgs, np.array([1, 3]))
    got = tracing.collect()
    steps = [s for s in got if s['name'] == 'train.step']
    assert [s['attrs']['req'] for s in steps] == [0, 1]
    for top in steps:
        kids = [s for s in got if s['parent'] == top['id']]
        assert names(kids) == ['train.forward', 'train.backward',
                               'train.clip', 'train.optimizer']
        assert all(k['attrs']['req'] == top['attrs']['req'] for k in kids)
        assert all(a['end_ns'] <= b['start_ns']
                   for a, b in zip(kids, kids[1:]))


def test_mvf_spans_its_fusion():
    mvf = MVF(nn.Conv2d(16, 8, 1), n_segment=4, in_channels=16, alpha=0.25)
    x = torch.randn(8, 16, 6, 6).contiguous(memory_format=torch.channels_last)
    want = mvf(x)
    tracing.enable()
    got = mvf(x)
    assert torch.equal(got, want)
    assert names(tracing.collect()) == ['model.mvf']


def test_int8_ranges_show_under_the_profiler_when_on():
    from torch.profiler import ProfilerActivity, profile
    conv = common.conv2d(8, 8, 3, padding=1, quant='int8').eval()
    x = torch.randn(1, 8, 6, 6, dtype=torch.float64)
    conv = conv.double()

    def ranges():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            conv(x)
        return {e.name for e in prof.events() if e.name.startswith('int8_')}
    assert ranges() == set()
    tracing.enable()
    assert ranges() == {'int8_quantize', 'int8_weights'}
    assert {'int8_quantize', 'int8_weights'} <= set(names(
        tracing.collect()))


def test_write_chrome_and_recording(tmp_path):
    path = str(tmp_path / 'trace' / 'spans.json')
    with tracing.recording(path):
        assert tracing.enabled()
        with tracing.span('train.step', req=np.int64(0)):
            with tracing.span('train.forward'):
                pass
    assert not tracing.enabled() and tracing.collect() == []
    events = json.load(open(path))['traceEvents']
    spans = [e for e in events if e['ph'] == 'X']
    assert [e['name'] for e in spans] == ['train.step', 'train.forward']
    assert spans[1]['args'] == {'req': 0} and spans[0]['cat'] == 'train'
    assert spans[0]['ts'] <= spans[1]['ts'] and spans[0]['dur'] >= 0
    assert [e['args']['name'] for e in events if e['ph'] == 'M'] == [
        'MainThread']
    with tracing.recording(path, rank=2):
        pass
    assert os.path.exists(str(tmp_path / 'trace' / 'spans.rank2.json'))
