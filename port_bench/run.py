"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. The cell, its configuration and its metrics
come from ``BENCHMARK.json``; the cell's traffic from
``port_bench/workloads/NAME.json``, its driver from
``port_bench/drivers/<driver>.py``, each per-layer metric's reader from
``port_bench/metrics/<metric>.py``. With ``--trace 0`` the run reports
the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones and
a breakdown of device time. Every run checks what its timed path produced
against the plain reference and prints each compared number beside its
limit, last on standard error and last in the result line, which is the
last line of standard output.

Exits non-zero, printing no result, without as many CUDA devices as the
cell asks for, and when a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench.lib import harness  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f'port_bench: {msg}', file=sys.stderr)
    sys.exit(code)


def run_cell(bench: dict, cell: dict, config: dict, workload: dict,
             args, device, plant=None) -> str:
    """Set up, measure and check one run of ``cell`` on ``device``; the
    result line. ``plant(run)``, if given, is called after set-up (a test
    breaks the timed path with it)."""
    import torch
    on_card = device.type == 'cuda'

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    driver = harness.load_module('drivers', workload['driver'])
    run = driver.Bench(config, workload, args.seed, device)
    run.setup()
    if plant is not None:
        plant(run)
    sync()
    setup_s = time.perf_counter() - T_START

    device_info = dict(platform='gpu' if on_card else device.type,
                       kind=(torch.cuda.get_device_name(device) if on_card
                             else device.type),
                       count=cell['chips'])
    breakdown = None
    if args.trace:
        data = run.traced(args.seconds)
        data['setup_s'] = setup_s
        metrics = {}
        for m in harness.metrics_for(bench['per_layer'], cell['name']):
            value = harness.load_module('metrics', m['name']).read(data)
            if value is not None:
                metrics[m['name']] = dict(value=value, unit=m['unit'])
        device_info.update(busy_s=data['busy_s'], window_s=data['window_s'])
        breakdown = data['breakdown']
        print('trace: by kind ' + str(data['by_kind_s']), file=sys.stderr)
    else:
        values = run.window(args.seconds)
        values['setup_s'] = setup_s
        metrics = {m['name']: dict(value=values[m['name']], unit=m['unit'])
                   for m in harness.metrics_for(bench['end_to_end'],
                                                cell['name'])}
    device_info['memory_peak_bytes'] = (
        torch.cuda.max_memory_allocated(device) if on_card else 0)

    run.release()
    attempted, failed, checks = run.check()
    sync()
    correct = (attempted > 0 and failed == 0
               and all(c['ok'] for c in checks.values()))
    return harness.result_line(correct, attempted, failed, metrics,
                               device_info, checks, breakdown)


def main(argv=None) -> None:
    args = parse_args(argv)
    harness.set_cache_dirs()
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.load_json(os.path.join(
        harness.ROOT, harness.config_entry(bench, cell['config'])['file']))
    workload = harness.workload_file(cell['name'])

    import torch
    if not torch.cuda.is_available():
        fail('CUDA is not available: the benchmark runs only on the card')
    if torch.cuda.device_count() < cell['chips']:
        fail(f'the cell needs {cell["chips"]} CUDA devices, '
             f'{torch.cuda.device_count()} are visible')
    line = run_cell(bench, cell, config, workload, args,
                    torch.device('cuda', 0))

    bad = harness.forbidden_modules()
    print(f'check forbidden_modules: {bad} (top-level '
          f'{", ".join(harness.FORBIDDEN)})', file=sys.stderr)
    if bad:
        fail(f'modules of JAX or of the JAX package were loaded: {bad}', 3)
    for text in harness.check_lines(json.loads(line)['checks']):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)


if __name__ == '__main__':
    main()
