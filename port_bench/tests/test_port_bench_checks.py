"""The check that decides ``correct`` fails what it must.

On the CPU, a run of each cell with the harness's look for a chip
skipped (``run.run_cell`` on the CPU at a small size, the program in
float32 so that the unbroken run is clean) comes out correct, and comes
out not correct with its timed path broken underneath: for the dense
cells and the test CLI the 'prob' average over half the clips, each answer's
probabilities shifted by one class, each request answered with the
previous one's scores; for the train cell a step that leaves its state
unchanged, the loss over half the batch, and the step's loss altered
where it is produced. On the card (``cuda`` marker), each cell's control
at the cell's own size fails its check."""

import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench import calibrate, run  # noqa: E402
from port_bench.lib import harness  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from bench_small import SMALL, small_cell  # noqa: E402

BENCH = harness.benchmark()


def run_small(name, plant=None, seconds=0.2):
    torch.set_num_threads(4)
    cell, config, workload = small_cell(BENCH, name)
    args = SimpleNamespace(seed=2 ** 32 + 11, seconds=seconds, trace=0)
    return json.loads(run.run_cell(BENCH, cell, config, workload, args,
                                   torch.device('cpu'), plant))


@pytest.mark.parametrize('name', sorted(SMALL))
def test_an_unbroken_run_is_correct(name):
    out = run_small(name)
    assert out['correct'], out['checks']
    assert out['attempted'] > 0 and out['failed'] == 0


@pytest.mark.parametrize('name,fault', [
    (n, f) for n in ('r50_dense', 'r50_test_cli')
    for f in ('half', 'altered', 'stale')])
def test_a_broken_dense_path_is_not_correct(name, fault):
    out = run_small(name, lambda b: calibrate.plant_dense(b, fault))
    assert not out['correct'], out['checks']


def _unchanged(bench):
    bench.optimizer.step = lambda *a, **k: None


def _half_batch(bench):
    step = bench.step

    def half(imgs, labels, generator=None):
        b = imgs.shape[0] // 2
        return step(imgs[:b], labels[:b], generator)
    bench.step = half


def _altered_loss(bench):
    step = bench.step

    def altered(*args):
        m = step(*args)
        m['loss'] = m['loss'] * 1.5
        return m
    bench.step = altered


@pytest.mark.parametrize('fault', [_unchanged, _half_batch, _altered_loss])
def test_a_broken_train_step_is_not_correct(fault):
    def plant(bench):
        # back to the seeded weights and step 0, break the step, then run
        # the checked steps again through it
        bench.model.load_state_dict(bench.state)
        bench.optimizer.state.clear()
        bench.step.state.step = 0
        fault(bench)
        bench.losses.clear()
        for t in range(bench.workload['check_steps']):
            m = bench.train(t)
            if t == 0:
                bench.first_buffers = {
                    bench.param_names[p]: s['momentum_buffer'].clone()
                    for p, s in bench.optimizer.state.items()}
            bench.losses.append(float(m['loss']))
        bench.after_checked = {n: p.detach().clone()
                               for n, p in bench.model.named_parameters()}
    out = run_small('r50_train', plant)
    assert not out['correct'], out['checks']


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the control runs at the cell size')


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['r50_dense', 'r50_train', 'r50_test_cli'])
def test_the_control_fails_at_the_cell_size(card, name):
    """The control in the program's place, one seed, at the cell's own
    size: some compared number exceeds its limit."""
    cell = harness.cell(BENCH, name)
    config = harness.load_json(os.path.join(
        harness.ROOT, harness.config_entry(BENCH, cell['config'])['file']))
    workload = harness.workload_file(name)
    driver = harness.load_module('drivers', workload['driver'])
    bench = driver.Bench(config, dict(workload), 2 ** 33 + 29, 'cuda')
    numbers = (calibrate.train_numbers if workload['driver'] == 'train'
               else calibrate.dense_numbers)(bench, 'control')
    limits = workload['checks']
    assert any(numbers[k] > limits[k] for k in limits), numbers
