"""The ``x3d_train`` cell: its readers, its driver and its check.

On the CPU, at a small cell of its own (2 clips of 4 frames at 32^2, the
program in float32, so that an unbroken run is clean): the two readers of
the driver's keys read None from a trace without them and the value from
one with them; the reference's state dict loads strictly into the port's
model; a run of the cell (``run.run_cell`` with the look for a chip
skipped) comes out correct, and each of ``calibrate.py``'s train faults
fails a limit; the spans stretch reads the two spans and None where the
program has none; a dry run of the driver loads no module of JAX or of
the JAX package.

On the card (``cuda`` marker), at the cell's own size: the readings that
the limits of ``workloads/x3d_train.json`` are set from, one JSON line
each (``-s`` shows them), from ``calibrate.train_numbers`` (the program
over 12 seeds, the float32 reference rounded to float8 e4m3 in its place,
and the faults ``half``, ``unchanged`` and ``altered``); each limit sits
at least 1.5 times above the program's worst reading and 1.5 times below
float8's least (``FLOAT8_HELD``) or, for the worst leaf's gaps, which
float8 moves less than 2.25 times past the program, below the unchanged
state's 1.0; float8 and every fault fail at least one limit."""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench import calibrate, run  # noqa: E402
from port_bench.lib import harness, spans  # noqa: E402

BENCH = harness.benchmark()
CELL = 'x3d_train'
READERS = {'dwconv_device_ms.x3d': 'dwconv_device_ms',
           'se_device_ms.x3d': 'se_device_ms'}
SMALL = dict(batch_shape=[2, 1, 4, 32, 32, 3], pool=3, log_interval=1,
             profiled_steps=1)
SEED = 2 ** 32 + 29
FAULTS = ('half', 'unchanged', 'altered')
# the card's readings: the program over 12 seeds, float8 and each fault
# over 2
PROGRAM_SEEDS = [2 ** 33 + 101 * i for i in range(12)]
OTHER_SEEDS = PROGRAM_SEEDS[:2]
# the numbers whose limits lie between the program and float8
FLOAT8_HELD = ('loss_gap', 'grad_norm_gap', 'grad_diff', 'change_diff')


def cell_files(small: bool):
    cell = harness.cell(BENCH, CELL)
    config = harness.load_json(os.path.join(
        harness.ROOT, harness.config_entry(BENCH, cell['config'])['file']))
    workload = harness.workload_file(CELL)
    if small:
        config = dict(config, compute_dtype='float32')
        workload = dict(workload, **SMALL)
    return cell, config, workload


def small_bench():
    _, config, workload = cell_files(True)
    driver = harness.load_module('drivers', workload['driver'])
    return driver.Bench(config, workload, SEED, 'cpu')


@pytest.mark.parametrize('metric', sorted(READERS))
def test_readers_read_their_key_or_nothing(metric):
    read = harness.load_module('metrics', metric).read
    trace = dict(kind='train', items_unprofiled=4, wall_unprofiled_s=0.5,
                 items_profiled=3, busy_s=0.3, flops_per_item=1e12)
    assert read(trace) is None
    assert read(dict(trace, **{READERS[metric]: None})) is None
    assert read(dict(trace, **{READERS[metric]: 41.5})) == 41.5


def test_the_reference_state_loads_strictly_into_the_port():
    from port_bench.lib import port, weights
    from port_bench.reference import x3d
    _, config, _ = cell_files(True)
    state = weights.make_state(x3d.spec(config['model']), SEED, 'cpu')
    model = port.build_model(config, state, 'cpu')
    assert set(model.state_dict()) == set(state)
    assert sum(p.numel() for p in model.parameters()) == 3794322


def run_small(plant=None):
    torch.set_num_threads(4)
    cell, config, workload = cell_files(True)
    args = SimpleNamespace(seed=SEED, seconds=0.5, trace=0)
    return json.loads(run.run_cell(BENCH, cell, config, workload, args,
                                   torch.device('cpu'), plant))


def test_an_unbroken_run_is_correct():
    out = run_small()
    assert out['correct'], out['checks']
    assert out['attempted'] > 3 and out['failed'] == 0
    assert set(out['metrics']) == {'train_clips_per_s', 'setup_s'}


def beyond(numbers: dict, limits: dict) -> list:
    return [k for k, limit in limits.items() if not numbers[k] <= limit]


@pytest.mark.parametrize('fault', FAULTS)
def test_each_fault_fails_a_limit(fault):
    _, _, workload = cell_files(True)
    numbers = calibrate.train_numbers(small_bench(), fault)
    assert beyond(numbers, workload['checks']), numbers


def test_the_spans_stretch_reads_both_spans():
    bench = small_bench()
    bench.setup()
    steps = bench.steps
    got = bench.span_readings()
    # the CPU launches nothing on a device, and the clock check holds
    assert got == dict(dwconv_device_ms=0.0, se_device_ms=0.0)
    assert bench.steps == steps + SMALL['profiled_steps']


def test_a_program_without_spans_reads_none(monkeypatch):
    bench = small_bench()
    bench.setup()
    # the parent commit's program: no span module
    monkeypatch.setattr(spans, 'tracing', lambda: None)
    assert bench.span_readings() == dict(dwconv_device_ms=None,
                                         se_device_ms=None)


DRY_RUN = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], 'port_bench', 'tests'))
import torch
torch.set_num_threads(2)
import test_port_bench_x3d as t
from port_bench.lib import harness
run = t.small_bench()
run.setup()
run.window(0.1)
run.span_readings()
run.release()
run.check()
print(json.dumps(harness.forbidden_modules()))
'''


def test_a_dry_run_of_the_driver_loads_no_jax():
    out = subprocess.run([sys.executable, '-c', DRY_RUN, harness.ROOT],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the check runs at the cell size')


def readings(mode: str, seeds) -> list:
    """``calibrate.train_numbers`` of ``mode`` at the cell's size, one
    seed at a time, each printed as a JSON line."""
    _, config, workload = cell_files(False)
    driver = harness.load_module('drivers', workload['driver'])
    out = []
    for seed in seeds:
        numbers = calibrate.train_numbers(
            driver.Bench(config, dict(workload), seed, 'cuda'), mode)
        print(json.dumps(dict(workload=CELL, mode=mode, seed=seed,
                              numbers=numbers)), flush=True)
        out.append(numbers)
        torch.cuda.empty_cache()
    return out


@pytest.mark.cuda
def test_the_limits_sit_between_the_program_and_float8(card):
    harness.set_cache_dirs()
    limits = cell_files(False)[2]['checks']
    program = readings('program', PROGRAM_SEEDS)
    control = readings('control', OTHER_SEEDS)
    faults = {f: readings(f, OTHER_SEEDS) for f in FAULTS}
    for k, limit in limits.items():
        worst = max(n[k] for n in program)
        above = control if k in FLOAT8_HELD else faults['unchanged']
        least = min(n[k] for n in above)
        assert 1.5 * worst <= limit <= least / 1.5, (k, worst, least, limit)
    assert all(beyond(n, limits) for n in control)
    for fault, numbers in faults.items():
        assert all(beyond(n, limits) for n in numbers), fault


def test_busy_ms_within_counts_each_interval_once():
    driver = harness.load_module('drivers', 'x3d_train')
    # one span on the main thread around the launches of kernels 2 and 4
    span = dict(id=0, parent=None, name='model.dwconv', s=10.0, e=30.0,
                thread=1, attrs={})
    prof = dict(spans=[span], ranges=[(11.0, 29.0, 'model.dwconv')],
                main_thread=1,
                launches=[(5.0, 6.0, 'cudaLaunchKernel', 1),
                          (12.0, 13.0, 'cudaLaunchKernel', 2),
                          (35.0, 36.0, 'cudaLaunchKernel', 3),
                          (20.0, 21.0, 'cudaLaunchKernel', 4),
                          (40.0, 41.0, 'cudaLaunchKernel', 5)],
                # kernel 2 runs on another stream beside kernel 1
                device=[(100.0, 110.0, 'a', 1), (102.0, 115.0, 'b', 2),
                        (115.0, 118.0, 'c', 3), (120.0, 124.0, 'd', 4),
                        (130.0, 131.0, 'e', 5)])
    assert driver.busy_ms_within(prof, 'model.dwconv') == \
        pytest.approx((5.0 + 4.0) / 1e3)
    assert spans.device_ms_within(prof, 'model.dwconv') == \
        pytest.approx((13.0 + 4.0) / 1e3)
    assert driver.busy_ms_within(prof, 'model.se') is None
    assert driver.busy_ms_within(dict(prof, ranges=[]), 'model.dwconv') \
        is None
