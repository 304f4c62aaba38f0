#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compiles the port's CUDA kernel from ``mvfnet_tpu_torch/csrc``
   with nvcc and prints ptxas's register report.
2. kernel: holds each kernel against its plain PyTorch version on the card,
   in float32 (TF32 off) and bfloat16, at the unit-test shapes and at the
   shapes the dense-test path gives it, and times kernel, plain version and
   the bound with CUDA events.
3. slice: builds MVFNet-R50 8x8 from its config file through the port's
   entry points (seeded random weights, bf16 compute), answers three
   dense-test requests of (1, 240, 256, 256, 3) uint8 frames, checks the
   scores, counts the fused kernel's launches by shape and dtype (2 at
   layer1 and 3 at layer2 per video, bf16, nothing else), and compares one
   video against the same model with the kernels' plain versions on the
   card.

Prints the ``{"kernels": [...]}`` line, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, 'configs', 'mvf', 'k400',
                      'mvf_kinetics400_r50_8x8_dense.py')

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 without tensor
# cores (the float32 kernel path runs FMAs), HBM3 bandwidth
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12

# (name, (N, H, W, Cin), Cm, bf16 launches expected per dense-test video):
# the unit-test shapes, a ragged shape that takes the tiled bf16 path (H and
# W not multiples of its tile), and the two shapes of the dense-test path
FUSED_SHAPES = [
    ('test_a', (2, 8, 8, 32), 16, 0),
    ('test_b', (1, 6, 10, 24), 8, 0),
    ('ragged_tiled', (3, 13, 11, 128), 64, 0),
    ('layer1', (240, 64, 64, 256), 64, 2),
    ('layer2', (240, 32, 32, 512), 128, 3),
]
TIMED_RUNS = 25
VIDEOS = 3
KERNEL = dict(name='fused_bottleneck', route='cuda',
              source='mvfnet_tpu_torch/csrc/fused_bottleneck.cu',
              replaces='mvfnet_tpu/ops/fused_block.py:144')


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, runs=TIMED_RUNS, warmup=3):
    """Median of per-call CUDA-event times, after warm-up. The calls are
    queued back to back with no sync between them, so the host's work in
    each call hides behind the device's work of the one before."""
    import torch
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def phase_build():
    from mvfnet_tpu_torch.ops import _cuda
    from mvfnet_tpu_torch.ops import fused_block as fb
    t0 = time.perf_counter()
    lib = fb.library()
    secs = time.perf_counter() - t0
    for line in _cuda.build_logs.get('fused_bottleneck', '').splitlines():
        if 'registers' in line or 'Compiling' in line or 'spill' in line:
            print(f'nvcc: {line.strip()}')
    print(f'build: {os.path.basename(lib._name)} in {secs:.3f} s')


def _fused_inputs(shape, cm, dtype, seed):
    """Random operands; the weights stored output-channel-major, as the
    model's blocks cache them, so that a call is the launch alone."""
    import torch
    from mvfnet_tpu_torch.ops.fused_block import out_major
    g = torch.Generator(device='cuda').manual_seed(seed)
    n, h, w, cin = shape

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device='cuda') * scale

    x = rnd(n, h, w, cin).to(dtype)
    w1 = out_major(rnd(cin, cm, scale=cin ** -0.5).to(dtype))
    w2 = out_major(rnd(3, 3, cm, cm, scale=(9 * cm) ** -0.5).to(dtype))
    w3 = out_major(rnd(cm, cin, scale=cm ** -0.5).to(dtype))
    b1, b2 = rnd(1, cm, scale=0.1), rnd(1, cm, scale=0.1)
    b3 = rnd(1, cin, scale=0.1)
    return x, w1, b1, w2, b2, w3, b3


def phase_kernel():
    """Fused bottleneck vs its plain version; returns the timing records."""
    import torch
    from mvfnet_tpu_torch.ops import fused_block as fb
    records = []
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for dtype_name in ('float32', 'bfloat16'):
            dtype = getattr(torch, dtype_name)
            for i, (name, shape, cm, _) in enumerate(FUSED_SHAPES):
                args = _fused_inputs(shape, cm, dtype, seed=100 + i)
                with torch.inference_mode():
                    got = fb.bottleneck_eval_cuda(*args)
                    torch.cuda.synchronize()
                    want = fb.bottleneck_eval_plain(*args)
                    torch.cuda.synchronize()
                ref_max = want.float().abs().max().item()
                err = (got.float() - want.float()).abs().max().item()
                # f32: both sides sum in fp32, in different orders;
                # bf16: the plain version rounds each conv output to bf16
                # before adding its bias, the kernel after, so the two
                # differ by about one bf16 ulp (2^-8 relative) of the
                # largest value: 1e-2 allows two and a half
                tol = (1e-5 * (1 + ref_max) if dtype_name == 'float32'
                       else 1e-2 * ref_max)
                ok = err <= tol and bool(torch.isfinite(got).all())
                n, h, w, cin = shape
                flops = 2 * n * h * w * (cin * cm + 9 * cm * cm + cm * cin)
                item = torch.finfo(dtype).bits // 8
                nbytes = (2 * n * h * w * cin * item
                          + (2 * cin * cm + 9 * cm * cm) * item
                          + (2 * cm + cin) * 4)
                t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
                t_bytes = nbytes / PEAK_BYTES * 1e3
                with torch.inference_mode():
                    kernel_ms = median_ms(
                        lambda: fb.bottleneck_eval_cuda(*args))
                    plain_ms = median_ms(
                        lambda: fb.bottleneck_eval_plain(*args))
                rec = dict(
                    KERNEL, case=name, shape=list(shape) + [cm],
                    dtype=dtype_name,
                    path=fb.kernel_path(dtype, h, w, cin, cm),
                    max_abs_err=err, tol=tol, ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=max(t_ops, t_bytes),
                    bound_by='bytes' if t_bytes >= t_ops else 'operations',
                    flops=flops, bytes=nbytes, library_ms=None)
                print('kernel check: ' + json.dumps(rec))
                require(ok, f'fused_bottleneck {name} {dtype_name}: max abs '
                            f'err {err} > tol {tol}')
                records.append(rec)
                del args, got, want
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return records


def _kernel_kind(name):
    low = name.lower()
    for kind, keys in (('fused_bottleneck', ('fused_bottleneck',)),
                       ('conv', ('conv', 'xmma', 'gemm', 'cutlass', 'sm90_',
                                 'implicit')),
                       ('batch_norm', ('batch_norm', 'bn_fw', 'batchnorm')),
                       ('pool', ('pool',)),
                       ('reduce', ('reduce', 'softmax'))):
        if any(k in low for k in keys):
            return kind
    return 'elementwise/copy'


def device_profile(fn):
    """Device time of one call by kernel kind, from torch.profiler: kernel
    time summed, the union of kernel intervals, and the call's host-clock
    wall time (its complement is the device's idle share)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return dict(wall_ms=wall_ms, note='the profiler saw no device events')
    by_kind, by_name, busy, end = {}, {}, 0.0, float('-inf')
    for s, e, name in spans:
        us = e - s
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0) + us
        by_name[name[:80]] = by_name.get(name[:80], 0) + us
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        wall_ms=wall_ms, kernels=len(spans),
        kernel_ms=sum(by_kind.values()) / 1e3, busy_ms=busy / 1e3,
        idle_share=max(0.0, 1 - busy / 1e3 / wall_ms),
        by_kind_ms={k: v / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        top_kernels_ms=[[n, v / 1e3] for n, v in top])


def phase_slice():
    """The dense-test path on the card; returns the fused kernel's launches
    in the three timed requests, by (dtype, N, H, W, Cin, Cm)."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.ops import fused_block as fb

    device = torch.device('cuda')
    cfg = Config.fromfile(CONFIG)
    model = build_recognizer(
        {**cfg.model, 'fcn_testing': True, 'dtype': cfg.compute_dtype},
        test_cfg=cfg.test_cfg)
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    model.to(device)
    step = make_eval_step(model, norm_cfg=dict(cfg.img_norm_cfg, device=True))
    clip_len = cfg.model['module_cfg']['n_segment']
    views = 30                                  # 3 crops x 10 clips
    frames = views * clip_len
    videos = [np.random.RandomState(seed).randint(
        0, 256, (1, frames, 256, 256, 3), dtype=np.uint8)
        for seed in range(VIDEOS)]

    warm = step(model, videos[0])                # cuDNN set-up, allocator
    torch.cuda.synchronize()
    require(tuple(warm.shape) == (1, 400), f'scores shape {warm.shape}')

    fb.bottleneck_eval_cuda.launches = 0
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    secs, scores = [], []
    for v in videos:
        t0 = time.perf_counter()
        s = step(model, v)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        scores.append(s.float().cpu())
    launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)

    for s in scores:
        require(bool(torch.isfinite(s).all()), 'non-finite scores')
        require(abs(s.sum().item() - 1.0) <= 1e-3,
                f'class probabilities sum to {s.sum().item()}')
    expected = {('bfloat16',) + shape + (cm,): per_video * VIDEOS
                for _, shape, cm, per_video in FUSED_SHAPES if per_video}
    require(launches == expected,
            f'fused kernel launches for {VIDEOS} videos by (dtype, N, H, W, '
            f'Cin, Cm): {launches}, expected {expected}')
    require(fb.bottleneck_eval_cuda.launches == sum(expected.values()),
            f'fused kernel launched {fb.bottleneck_eval_cuda.launches} '
            f'times in all')

    # one video against the kernels' plain versions, per-clip logits
    model.test_cfg = dict(average_clips=None)
    logits = step(model, videos[0]).float().cpu()
    fb.FORCE = 'plain'
    try:
        plain = step(model, videos[0]).float().cpu()
    finally:
        fb.FORCE = None
        model.test_cfg = cfg.test_cfg
    ref_max = plain.abs().max().item()
    err = (logits - plain).abs().max().item()
    tol = 3e-2 * ref_max
    am_k, am_p = logits.argmax(-1), plain.argmax(-1)
    # a differing argmax is accepted only where the plain path's top two
    # classes lie within the tolerance of each other (a near tie)
    rows = torch.arange(plain.shape[0])
    margin = plain[rows, am_p] - plain[rows, am_k]
    agree = int((am_k == am_p).sum())
    print('slice compare: ' + json.dumps(dict(
        clips=plain.shape[0], max_abs_err=err, tol=tol, ref_max=ref_max,
        argmax_agree=agree, max_margin_where_differs=float(margin.max()))))
    require(err <= tol, f'kernel path vs plain path logits: {err} > {tol}')
    require(bool((margin <= tol).all()), 'argmax differs beyond a near tie')

    print('profile: ' + json.dumps(device_profile(
        lambda: step(model, videos[1]))))
    clips_per_s = [views / t for t in secs]
    print('slice: ' + json.dumps(dict(
        videos=VIDEOS, frames_per_video=frames, clips_per_video=views,
        request_s=secs, clips_per_s=clips_per_s,
        median_clips_per_s=statistics.median(clips_per_s),
        fused_launches=sum(launches.values()), card=card_line())))
    return launches


def main():
    try:
        import torch
    except ImportError:
        print('chip_smoke: PyTorch is not installed', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; the port runs only on the GPU',
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import mvfnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the mvfnet_tpu_torch package is not beside this '
              f'script ({e})', file=sys.stderr)
        return 2
    card = card_line()
    print(f'card: {card}')
    print(f'torch {torch.__version__} cuda {torch.version.cuda} '
          f'python {sys.version.split()[0]}')
    try:
        phase_build()
        records = phase_kernel()
        launches = phase_slice()
        for r in records:
            r['launches'] = launches.get(
                (r['dtype'],) + tuple(r['shape']), 0)
    except SmokeFailure as e:
        print(f'chip_smoke: FAILED: {e}', file=sys.stderr)
        return 1
    print(json.dumps({'kernels': records}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
