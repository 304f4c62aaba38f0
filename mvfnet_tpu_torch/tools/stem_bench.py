"""The 3-D stems' conv on the card, plain against its space-to-depth form.

    python -m mvfnet_tpu_torch.tools.stem_bench [--views 1,2,4,8,30] \
        [--runs 10] [--out OUT.json]

For each stem geometry of the port's 3-D backbones at its config's test
shape, with the views (clips x crops, the batch) set to each of
``--views`` (the smaller batches place the size floor), a bf16
``channels_last_3d`` input on the card is convolved by ``common.Conv3d``'s
cast weight both ways: ``F.conv3d`` as cuDNN's heuristics take it
(``plain``) and ``common.conv3d_space_to_depth`` (``s2d``). Each prints a
``stem bench:`` JSON line: the median CUDA-event ms of the forward
(``fwd_ms``, under ``no_grad``) and of the forward with the weight
gradient (``train_ms``), each way; the largest conv kernel of each,
by name, from torch.profiler; the largest difference of the two outputs
over the largest plain output; K (Cin * kt * kh * kw), the output count,
and whether ``common.takes_space_to_depth`` takes the form. Then the
card's name and power limit; ``--out`` gets the records as JSON.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch
import torch.nn.functional as F

from ..models import common

# name: (input (N, C, T, H, W), Cout, kernel, stride, padding); test shapes
# are 30 views (10 clips x 3 crops) at the config's frames and crop;
# Inception's input is its forward's (2, 4)-padded one
GEOMETRIES = {
    'i3d': ((30, 3, 32, 256, 256), 64, (5, 7, 7), (2, 2, 2), (2, 3, 3)),
    'slowfast_slow': ((30, 3, 4, 256, 256), 64, (1, 7, 7), (1, 2, 2),
                      (0, 3, 3)),
    'slowfast_fast': ((30, 3, 32, 256, 256), 8, (5, 7, 7), (1, 2, 2),
                      (2, 3, 3)),
    'x3d': ((30, 3, 16, 256, 256), 24, (5, 7, 7), (2, 2, 2), (2, 3, 3)),
    'r3d': ((30, 3, 8, 112, 112), 64, (3, 7, 7), (1, 2, 2), (1, 3, 3)),
    'r2plus1d': ((30, 3, 8, 112, 112), 45, (1, 7, 7), (1, 2, 2), (0, 3, 3)),
    'inception_i3d': ((30, 3, 70, 230, 230), 64, (7, 7, 7), (2, 2, 2),
                      (0, 0, 0)),
}


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, runs: int, warmup: int = 3) -> float:
    """Median CUDA-event ms of ``fn``, each call timed on its own."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def conv_kernel(fn) -> str:
    """The name of the longest device kernel of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    times = {e.key: getattr(e, 'device_time_total', 0)
             for e in prof.key_averages()}
    return max(times, key=times.get)


def record(name, shape, cout, kernel, stride, padding, runs) -> dict:
    gen = torch.Generator(device='cuda').manual_seed(0)
    conv = common.conv3d(shape[1], cout, kernel, stride=stride,
                         padding=padding).cuda()
    with torch.no_grad():
        conv.weight.normal_(0, math.prod(conv.weight.shape[1:]) ** -0.5,
                            generator=gen)
    x = torch.randn(shape, generator=gen, device='cuda').to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    geometry = (conv.stride, conv.padding, conv.dilation)
    forms = {
        'plain': lambda w: F.conv3d(x, w, None, *geometry),
        's2d': lambda w: common.conv3d_space_to_depth(x, w, None,
                                                      *geometry),
    }
    rec = dict(geometry=name, shape=list(shape), cout=cout,
               kernel=list(kernel), stride=list(stride),
               padding=list(padding), K=shape[1] * math.prod(kernel),
               takes_s2d=common.takes_space_to_depth(
                   conv, shape, torch.bfloat16, x.device))
    outs = {}
    for form, run in forms.items():
        def fwd():
            with torch.no_grad():
                return run(conv.weight.to(torch.bfloat16))
        outs[form] = fwd().float()
        grad = torch.randn(outs[form].shape, generator=gen,
                           device='cuda').to(torch.bfloat16)

        def train():
            return torch.autograd.grad(run(conv.weight.to(torch.bfloat16)),
                                       conv.weight, grad)
        rec[f'{form}_fwd_ms'] = round(median_ms(fwd, runs), 4)
        rec[f'{form}_train_ms'] = round(median_ms(train, runs), 4)
        rec[f'{form}_kernel'] = conv_kernel(fwd)
        del grad
    rec['outputs'] = outs['plain'].numel()
    rec['max_diff'] = ((outs['s2d'] - outs['plain']).abs().max()
                       / outs['plain'].abs().max()).item()
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--views', default='30',
                        help='comma-separated batch sizes')
    parser.add_argument('--runs', type=int, default=10)
    parser.add_argument('--out')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('stem_bench needs an NVIDIA GPU')
    records = []
    for views in map(int, args.views.split(',')):
        for name, (shape, *geometry) in GEOMETRIES.items():
            records.append(record(name, (views,) + shape[1:], *geometry,
                                  args.runs))
            print('stem bench:', json.dumps(records[-1]), flush=True)
            torch.cuda.empty_cache()
    print('card:', card_line(), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(records, f, indent=1)


if __name__ == '__main__':
    main()
