"""The benchmark's files, names and yardstick on the CPU: every entry of
``BENCHMARK.json`` resolves to its file by name, the result line has its
keys, the seeded traffic repeats by seed, the kernel bounds reproduce the
recorded rows, no run loads JAX or the JAX package, and the reference
imports nothing of the program."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench.lib import harness, peaks, readings, trace, weights  # noqa
from port_bench.reference import models as ref  # noqa: E402

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'][:2] == ['python3', 'port_bench/run.py']
    assert BENCH['paths'] == ['port_bench']
    assert 1 <= BENCH['run_seconds'] <= 51
    # a full check of 24 cells fits its 43200 s
    cells = 24
    total = ((2 + 14 * cells) * (BENCH['run_seconds'] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
    names = ([c['name'] for c in BENCH['configs']]
             + [w['name'] for w in BENCH['workloads']]
             + [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']])
    assert all(NAME.match(n) for n in names)
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    assert len(set(names)) == len(names)
    assert os.path.getsize(os.path.join(ROOT, 'BENCHMARK.json')) < 64 * 1024


def test_every_entry_resolves_to_its_file():
    for c in BENCH['configs']:
        assert c['file'].startswith('port_bench/configs/')
        cfg = harness.load_json(os.path.join(ROOT, c['file']))
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert c['reduced'] == []
    for w in BENCH['workloads']:
        wl = harness.workload_file(w['name'])
        assert w['config'] in {c['name'] for c in BENCH['configs']}
        driver = harness.load_module('drivers', wl['driver'])
        assert hasattr(driver.Bench, 'check')
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in BENCH['per_layer']:
        assert callable(harness.load_module('metrics', m['name']).read)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for w in BENCH['workloads']:
        mine = {m['name'] for m in harness.metrics_for(BENCH['end_to_end'],
                                                       w['name'])}
        assert 'setup_s' in mine and len(mine) >= 2
        layers = harness.metrics_for(BENCH['per_layer'], w['name'])
        assert layers
        for m in layers:
            # the metric it moves is one this cell reports
            assert m['moves'] in mine and m['moves'] in e2e
    assert e2e['setup_s']['bound'] <= 0.25


def test_result_line_keys_and_check_lines():
    checks = {'logp_err': dict(value=0.01, limit=0.05, ok=True)}
    line = harness.result_line(True, 3, 0, {'setup_s': dict(value=1.0,
                                                             unit='s')},
                               dict(platform='gpu', kind='x', count=1,
                                    memory_peak_bytes=1), checks,
                               dict(device_ops=[], idle_gaps=[]))
    out = json.loads(line)
    assert list(out) == ['correct', 'attempted', 'failed', 'metrics',
                         'device', 'breakdown', 'checks']
    assert harness.check_lines(checks) == [
        'check logp_err: 0.01 limit 0.05 ok']


def test_seeded_traffic_repeats_by_seed():
    seed = 2 ** 33 + 7
    a = weights.uint8_frames((2, 8, 16, 3), 2, seed, 2, 'cpu')
    b = weights.uint8_frames((2, 8, 16, 3), 2, seed, 2, 'cpu')
    c = weights.uint8_frames((2, 8, 16, 3), 2, seed + 1, 2, 'cpu')
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], a[1])
    cfg = harness.load_json(os.path.join(harness.HERE, 'configs',
                                         'mvf_r50_8x8.json'))
    s1 = weights.make_state(ref.spec(cfg['model']), seed, 'cpu')
    s2 = weights.make_state(ref.spec(cfg['model']), seed, 'cpu')
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert weights.labels(2, 4, 400, seed, 3)[1].tolist() == \
        weights.labels(2, 4, 400, seed, 3)[1].tolist()


def test_kernel_bounds_reproduce_the_recorded_rows():
    f, b = peaks.fused_bottleneck_work('bfloat16', 240, 64, 64, 256, 64)
    assert round(f / 1e9, 1) == 136.9 and round(b / 1e6, 1) == 1006.8
    f, b = peaks.fused_bottleneck_work('bfloat16', 240, 32, 32, 512, 128)
    assert round(f / 1e9, 1) == 136.9 and round(b / 1e6, 1) == 503.9
    bound = peaks.bound_s(0, peaks.ycc_to_bgr_bytes(80, 256, 455))
    assert round(bound * 1e3, 5) == 0.01252
    launches = {('bfloat16', 240, 64, 64, 256, 64): 2}
    assert peaks.fused_bottleneck_bound_s(launches) == pytest.approx(
        2 * 1006773760 / 3.35e12)


def test_flops_of_the_flagship_match_its_published_count():
    cfg = harness.load_json(os.path.join(harness.HERE, 'configs',
                                         'mvf_r50_8x8.json'))
    # 32.70 GMACs for 8 frames at 224^2 (count_flops, the reference
    # recipe's 32.909 GFLOPs counts MACs and a few more ops)
    macs = ref.count_flops(cfg['model'], (8, 224, 224, 3)) / 2
    assert 32.6e9 < macs < 32.8e9
    train = ref.count_flops(cfg['model'], (96, 224, 224, 3), train=True)
    assert 3 * 12 * macs * 2 > train > 2.9 * 12 * macs * 2


def test_trace_reduction():
    device = [(0.0, 10.0, 'a'), (5.0, 20.0, 'b'), (30.0, 40.0, 'a')]
    host = [(0.0, 100.0, 'bench.eval_step'), (15.0, 35.0,
                                              'bench.scores_to_host')]
    assert trace.busy_us(device) == 30.0
    assert trace.top_ops(device) == [['a', 20e-6], ['b', 15e-6]]
    assert trace.idle_gaps(device, host) == [['bench.scores_to_host',
                                              10e-6]]
    t = dict(kind='dense', items_unprofiled=10, wall_unprofiled_s=1.0,
             items_profiled=2, busy_s=0.15, flops_per_item=1e12)
    assert readings.idle_share_pct(t, 'dense') == pytest.approx(25.0)
    assert readings.idle_share_pct(t, 'train') is None
    assert readings.mfu_pct(t, 'dense') == pytest.approx(
        100 * 1e12 * 10 / 989e12)
    assert readings.busy_ms(t, 'dense') == pytest.approx(75.0)
    roofline = harness.load_module('metrics', 'fused_bottleneck_roofline')
    assert roofline.read(dict(t, fused_bottleneck=None)) is None
    assert roofline.read(dict(t, fused_bottleneck=dict(
        launches=5, bound_s=1.0, device_s=4.0))) == pytest.approx(25.0)


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ['jax.numpy', 'mvfnet_tpu_torch.ops', 'mvfnet_tpu.models', 'jaxx',
         'orbax.checkpoint', 'torch']) == ['jax.numpy', 'mvfnet_tpu.models',
                                           'orbax.checkpoint']


DRY_RUN = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], 'port_bench', 'tests'))
import torch
torch.set_num_threads(2)
from bench_small import small_cell
from port_bench.lib import harness
bench = harness.benchmark()
for w in bench['workloads']:
    cell, cfg, wl = small_cell(bench, w['name'])
    run = harness.load_module('drivers', wl['driver']).Bench(cfg, wl, 5, 'cpu')
    run.setup()
    run.window(0.1)
    run.release()
    run.check()
print(json.dumps(harness.forbidden_modules()))
'''


def test_a_dry_run_of_each_driver_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', DRY_RUN, ROOT],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'import port_bench.reference.models, port_bench.reference.train; '
            'print(sorted(m for m in sys.modules '
            "if m.split('.')[0] in ('mvfnet_tpu_torch', 'mvfnet_tpu', "
            "'jax')))")
    out = subprocess.run([sys.executable, '-c', code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
    for name in ('models.py', 'train.py', '__init__.py'):
        tree = ast.parse(open(os.path.join(harness.HERE, 'reference',
                                           name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            else:
                continue
            assert all(m.split('.')[0] not in ('mvfnet_tpu_torch',
                                               'mvfnet_tpu', 'jax')
                       for m in mods)
