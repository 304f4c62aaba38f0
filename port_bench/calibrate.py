"""Readings that a cell's limits are set from, many seeds in one process.

    python3 port_bench/calibrate.py --workload NAME --seeds 1,2,3 \\
        --mode program|control|FAULT [--out FILE.jsonl]

For each seed: the cell's set-up, a short stretch of its traffic (each
pool video twice, one pass of the test CLI, or the checked train steps),
and its check, printing the compared numbers as one JSON line.
``program`` reads the program as the benchmark runs it (the lower
readings); ``control`` the nearest lower precision (the dense cells: the
program's own int8 path, every conv it can quantize; the train cell: the
float32 reference rounded to float8 e4m3 in the program's place,
``reference.models.Precision``); a FAULT one planted fault: ``half`` (the
dense cells: the 'prob' average over half the clips; train: the loss over
half the batch, in the reference put in the program's place),
``altered`` (dense: each answer's probabilities shifted by one class;
train: each step's reported loss times 1.5), ``stale`` (dense: each
request answered with the previous one's scores), ``unchanged`` (train:
the state as set-up made it); ``bf16`` the float32 reference rounded to
bf16 in the program's place (a witness of what rounding alone reads).
Not run by the benchmark itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench.lib import harness  # noqa: E402

# the int8 path of each dense configuration's backbone, every conv it
# can quantize
INT8 = {'Recognizer2D': dict(quant='int8', quant_stem=True),
        'Recognizer3D': dict(quant='int8',
                             quant_ops=['spatial', 'temporal', 'pointwise'])}


def plant_dense(bench, mode: str) -> None:
    """Break a dense cell's timed path as ``mode`` says, where each
    video's clip scores are averaged (``average_clip``, which every eval
    step of the model calls)."""
    import torch
    average = bench.model.average_clip
    if mode == 'half':
        def broken(cls_score, num_batch=1):
            return average(cls_score[:cls_score.shape[0] // 2], num_batch)
    elif mode == 'altered':
        def broken(cls_score, num_batch=1):
            return torch.roll(average(cls_score, num_batch), 1, -1)
    elif mode == 'stale':
        last = []

        def broken(cls_score, num_batch=1):
            out = average(cls_score, num_batch)
            prev = last[0] if last else out
            last[:] = [out]
            return prev
    elif mode == 'program':
        return
    else:
        raise ValueError(f'no dense fault {mode!r}')
    bench.model.average_clip = broken


def serve_some(bench) -> None:
    """A short stretch of a dense cell's traffic: one pass of the test CLI,
    or each pool video twice."""
    if hasattr(bench, '_passes'):
        bench._passes(count=1)
    else:
        bench._serve(count=2 * len(bench.pool))


# the reference in the program's place, rounded to the configuration's
# precision: what rounding alone reads
ROUNDED = {'bf16': 'bfloat16'}


def dense_numbers(bench, mode: str) -> dict:
    import torch
    from port_bench.reference.models import Precision
    if mode == 'control':
        bench.workload = dict(bench.workload,
                              quant=INT8[bench.model_cfg['type']])
    bench.setup()
    if mode in ROUNDED:
        bench.release()
        precision = Precision(getattr(torch, ROUNDED[mode]))
        bench.answers = [(i, bench.reference_probs(i, precision).numpy())
                         for i in range(len(bench.pool))]
        return bench.numbers()[2]
    if mode != 'control':
        plant_dense(bench, mode)
    serve_some(bench)
    bench.release()
    return bench.numbers()[2]


def train_numbers(bench, mode: str) -> dict:
    import torch
    from port_bench.lib import compare
    from port_bench.reference.models import Precision
    bench.setup()
    bench.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want = bench.reference()
    if mode == 'program':
        got = bench.program_steps()
    elif mode == 'control':
        got = bench.reference(precision=Precision(torch.float8_e4m3fn))
    elif mode in ROUNDED:
        got = bench.reference(
            precision=Precision(getattr(torch, ROUNDED[mode])))
    elif mode == 'half':
        def half(imgs, labels, keep):
            b = imgs.shape[0] // 2
            return imgs[:b], labels[:b], keep[:keep.shape[0] // 2]
        got = bench.reference(batch_filter=half)
    elif mode == 'unchanged':
        # the state as set-up made it: no buffer, no change
        losses, _, _, norms = bench.program_steps()
        got = (losses, {k: torch.zeros_like(v) for k, v in want[1].items()},
               {k: bench.state[k] for k in want[2]}, norms)
    elif mode == 'altered':
        # the loss each step reports, altered where it is produced
        losses, grads, final, norms = bench.program_steps()
        got = ([x * 1.5 for x in losses], grads, final, norms)
    else:
        raise ValueError(f'no train fault {mode!r}')
    out = bench.numbers(got, want)
    # where the worst gradient gaps are, for the look at their cause
    gaps = compare.leaf_gaps(compare.leaf_norms(got[1]),
                             compare.leaf_norms(want[1]))
    out['worst_grad_leaves'] = sorted(
        ((round(v, 4), k) for k, v in gaps.items()), reverse=True)[:4]
    out['losses'] = [got[0], want[0]]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--mode', default='program')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    import torch
    if not torch.cuda.is_available():
        sys.exit('calibrate: CUDA is not available')
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.load_json(os.path.join(
        harness.ROOT, harness.config_entry(bench, cell['config'])['file']))
    workload = harness.workload_file(cell['name'])
    driver = harness.load_module('drivers', workload['driver'])
    numbers = train_numbers if workload['driver'] == 'train' \
        else dense_numbers
    for seed in (int(s) for s in args.seeds.split(',')):
        t0 = time.perf_counter()
        run = driver.Bench(config, dict(workload), seed, 'cuda')
        line = json.dumps(dict(workload=args.workload, mode=args.mode,
                               seed=seed, numbers=numbers(run, args.mode),
                               seconds=time.perf_counter() - t0))
        print(line, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(line + '\n')
        del run
        torch.cuda.empty_cache()


if __name__ == '__main__':
    main()
