"""The ``i3d_dense`` cell: its readers, its driver and its check.

On the CPU: the three readers of the ``dense_spans`` driver's keys read
None from a trace without them and the value from one with them; a run of
the cell at a small size (the program in float32, ``run.run_cell`` with
the look for a chip skipped) comes out correct, and not correct with its
timed path broken by each of ``calibrate.py``'s dense faults; the spans
stretch counts 53 BatchNorm forwards a video and reads None where the
program has neither spans nor the counter; a dry run of the driver loads
no module of JAX or of the JAX package. On the card (``cuda`` marker),
at the cell's own video shape and one seed: the float32 reference rounded
to float8 e4m3 in the program's place fails the ``logp_err`` limit, and
the program passes it."""

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
CELL = 'i3d_dense'
READERS = {'stem_device_ms.i3d': 'stem_device_ms',
           'norm_device_ms.i3d': 'norm_device_ms',
           'unfolded_norms.i3d': 'unfolded_norms'}
# 2 clips of 8 frames at 32^2 a video
SMALL = dict(video_shape=[1, 2, 8, 32, 32, 3], pool=2, warmup=1,
             profiled_requests=1)
I3D_NORMS = 53
SEED = 2 ** 32 + 23


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
    trace = dict(kind='dense', items_unprofiled=4, wall_unprofiled_s=0.5,
                 items_profiled=3, busy_s=0.3, flops_per_item=1e12)
    assert read(trace) is None
    assert read(dict(trace, **{READERS[metric]: None})) is None
    assert read(dict(trace, **{READERS[metric]: 41.5})) == 41.5


def run_small(plant=None):
    torch.set_num_threads(4)
    cell, config, workload = cell_files(True)
    args = SimpleNamespace(seed=SEED, seconds=0.5, trace=0)
    return json.loads(run.run_cell(BENCH, cell, config, workload, args,
                                   torch.device('cpu'), plant))


def test_an_unbroken_run_is_correct():
    out = run_small()
    assert out['correct'], out['checks']
    assert out['attempted'] > 1 and out['failed'] == 0
    assert set(out['metrics']) == {'dense_videos_per_s',
                                   'dense_video_p95_ms', 'setup_s'}


@pytest.mark.parametrize('fault', ['half', 'altered', 'stale'])
def test_a_broken_path_is_not_correct(fault):
    out = run_small(lambda b: calibrate.plant_dense(b, fault))
    assert not out['correct'], out['checks']


def test_the_spans_stretch_counts_every_norm_of_a_video():
    bench = small_bench()
    bench.setup()
    got = bench.span_readings()
    assert got['unfolded_norms'] == I3D_NORMS
    # the CPU launches nothing on a device, and the clock check holds
    assert got['stem_device_ms'] == 0.0 and got['norm_device_ms'] == 0.0
    assert len(bench.answers) == SMALL['profiled_requests']


def test_a_program_without_spans_or_counter_reads_none(monkeypatch):
    from mvfnet_tpu_torch.models import common
    bench = small_bench()
    bench.setup()
    # the parent commit's program: no span module, a BatchNorm class
    # without the counter
    monkeypatch.setattr(spans, 'tracing', lambda: None)
    monkeypatch.setattr(common, 'BatchNorm', type('BatchNorm', (), {}))
    assert bench.span_readings() == dict(stem_device_ms=None,
                                         norm_device_ms=None,
                                         unfolded_norms=None)


DRY_RUN = r'''
import json, os, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, os.path.join(sys.argv[1], 'port_bench', 'tests'))
import torch
torch.set_num_threads(2)
import test_port_bench_i3d as t
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


def float8_numbers(bench) -> dict:
    """The compared numbers of the float32 reference rounded to float8
    e4m3 (``reference.models.Precision``) put in the program's place, for
    every pool video."""
    from port_bench.reference.models import Precision
    bench.setup()
    bench.release()
    precision = Precision(torch.float8_e4m3fn)
    bench.answers = [(i, bench.reference_probs(i, precision).numpy())
                     for i in range(len(bench.pool))]
    return bench.numbers()[2]


@pytest.mark.cuda
def test_float8_fails_and_the_program_passes_at_the_cell_size(card):
    harness.set_cache_dirs()
    _, config, workload = cell_files(False)
    driver = harness.load_module('drivers', workload['driver'])
    limit = workload['checks']['logp_err']
    seed = 2 ** 33 + 41
    program = calibrate.dense_numbers(
        driver.Bench(config, dict(workload), seed, 'cuda'), 'program')
    torch.cuda.empty_cache()
    control = float8_numbers(driver.Bench(config, dict(workload), seed,
                                          'cuda'))
    assert program['logp_err'] <= limit < control['logp_err'], (program,
                                                               control)
