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
4. train: builds the same model anew with the recipe's LR schedule and
   optimizer (SGD nesterov, clip at 40) through the port's entry points,
   takes 2 warm-up and 5 timed train steps on (12, 8, 224, 224, 3) uint8
   batches (bf16 compute, fp32 params), counts one step's FLOPs and
   profiles another; checks finite metrics, a first loss near ln 400, that
   parameters and BN statistics moved, no fused-kernel launch while
   training, one step from a copied state in bf16 against fp32 (TF32 off),
   and then one dense-test video of the trained model against its plain
   path (the fold cache must see the trained weights).

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
# the unit-test shapes, shapes that take the tiled bf16 path at the edges of
# its strip walk (H and W not multiples of its tile; a ragged last step;
# H = 1; H below the step with W ragged), and the two shapes of the
# dense-test path
FUSED_SHAPES = [
    ('test_a', (2, 8, 8, 32), 16, 0),
    ('test_b', (1, 6, 10, 24), 8, 0),
    ('ragged_tiled', (3, 13, 11, 128), 64, 0),
    ('ragged_step', (160, 37, 20, 128), 64, 0),
    ('one_row', (1, 1, 64, 256), 64, 0),
    ('short_ragged', (2, 3, 9, 192), 128, 0),
    ('layer1', (240, 64, 64, 256), 64, 2),
    ('layer2', (240, 32, 32, 512), 128, 3),
]
TIMED_RUNS = 25
VIDEOS = 3
VIEWS, CROP = 30, 256       # a dense-test video: 3 crops x 10 clips of 256^2
# the train phase: (videos, frames, H, W, C) per step, warm-up and timed
# steps; the loader is not ported, so a fixed iteration count per epoch
# stands in for Kinetics-400's (about 240k clips in batches of 12 on 8
# cards: 2,500) in the recipe's LR schedule
TRAIN_BATCH = (12, 8, 224, 224, 3)
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
ITERS_PER_EPOCH = 2500
# ln 400 = 5.991: the first loss may lie 0.2 below it or 1.5 above it
FIRST_LOSS = (5.79, 7.49)
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
                require(rec['path'] == 'tiled' or dtype_name != 'bfloat16'
                        or cin % 64 or cm % 64,
                        f'fused_bottleneck {name}: bf16 took the '
                        f'{rec["path"]} kernel, not the tiled one')
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
                                 'implicit', 'dgrad', 'wgrad')),
                       ('batch_norm', ('batch_norm', 'bn_fw', 'bn_bw',
                                       'batchnorm')),
                       ('optimizer', ('multi_tensor_apply',)),
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
    # device kernels and copies, not the device-side ranges of annotations
    # such as the optimizer's record_function
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False))
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
        idle_share=1 - busy / 1e3 / wall_ms,
        by_kind_ms={k: v / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        top_kernels_ms=[[n, v / 1e3] for n, v in top])


def compare_with_plain(phase, step, model, video):
    """One video's per-clip logits through the kernels against the same
    model with the kernels' plain versions; returns the fused kernel's
    launches in the kernel path's call, by (dtype, N, H, W, Cin, Cm)."""
    import torch
    from mvfnet_tpu_torch.ops import fused_block as fb
    test_cfg = model.test_cfg
    model.test_cfg = dict(average_clips=None)
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    try:
        logits = step(model, video).float().cpu()
        launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)
        fb.FORCE = 'plain'
        plain = step(model, video).float().cpu()
    finally:
        fb.FORCE = None
        model.test_cfg = test_cfg
    ref_max = plain.abs().max().item()
    err = (logits - plain).abs().max().item()
    tol = 3e-2 * ref_max
    am_k, am_p = logits.argmax(-1), plain.argmax(-1)
    # a differing argmax is accepted only where the plain path's top two
    # classes lie within the tolerance of each other (a near tie)
    rows = torch.arange(plain.shape[0])
    margin = plain[rows, am_p] - plain[rows, am_k]
    agree = int((am_k == am_p).sum())
    print(f'{phase} compare: ' + json.dumps(dict(
        clips=plain.shape[0], max_abs_err=err, tol=tol, ref_max=ref_max,
        argmax_agree=agree, max_margin_where_differs=float(margin.max()))))
    require(bool(torch.isfinite(logits).all()), f'{phase}: non-finite logits')
    require(err <= tol, f'{phase}: kernel path vs plain path logits: {err} '
                        f'> {tol}')
    require(bool((margin <= tol).all()),
            f'{phase}: argmax differs beyond a near tie')
    return launches


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
    views = VIEWS
    frames = views * clip_len
    videos = [np.random.RandomState(seed).randint(
        0, 256, (1, frames, CROP, CROP, 3), dtype=np.uint8)
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

    compare_with_plain('slice', step, model, videos[0])

    print('profile: ' + json.dumps(device_profile(
        lambda: step(model, videos[1]))))
    clips_per_s = [views / t for t in secs]
    print('slice: ' + json.dumps(dict(
        videos=VIDEOS, frames_per_video=frames, clips_per_video=views,
        request_s=secs, clips_per_s=clips_per_s,
        median_clips_per_s=statistics.median(clips_per_s),
        fused_launches=sum(launches.values()), card=card_line())))
    return launches


def phase_train():
    """The train step on the card: returns nothing, prints the train,
    train compare, train profile and train eval lines."""
    import copy

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer,
                                               frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import (make_eval_step,
                                                    make_train_step)
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.ops import fused_block as fb

    cfg = Config.fromfile(CONFIG)
    model = build_recognizer(
        {**cfg.model, 'fcn_testing': True, 'dtype': cfg.compute_dtype},
        train_cfg=cfg.train_cfg, test_cfg=cfg.test_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to('cuda')
    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH, cfg.total_epochs)
    frozen = frozen_prefixes_from_backbone(cfg.model['backbone'])

    def train_step_for(m):
        opt = build_optimizer(m, cfg.optimizer, schedule,
                              grad_clip=cfg.optimizer_config['grad_clip'],
                              frozen_prefixes=frozen)
        return make_train_step(m, opt, schedule,
                               norm_cfg=dict(cfg.img_norm_cfg, device=True))

    step = train_step_for(model)
    videos, classes = TRAIN_BATCH[0], cfg.model['cls_head']['num_classes']
    batches = [(np.random.RandomState(seed).randint(
                    0, 256, TRAIN_BATCH, dtype=np.uint8),
                np.random.RandomState(1000 + seed).randint(0, classes, videos))
               for seed in range(TRAIN_WARMUP + TRAIN_STEPS + 1)]
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}

    fb.bottleneck_eval_cuda.launches = 0
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    metrics = [step(*batches[0], gen)]               # cuDNN set-up
    with FlopCounterMode(display=False) as counter:  # warm-up 2, counted
        metrics.append(step(*batches[1], gen))
    flops = counter.get_total_flops()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for b in batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]:
        t0 = time.perf_counter()
        metrics.append(step(*b, gen))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(secs)
    prof = device_profile(lambda: step(*batches[-1], gen))
    # the profiler slows the host; the device's busy time against the
    # median unprofiled step gives the idle share of a step as timed. It is
    # printed raw: busy time beyond the slowest unprofiled step means the
    # profile over-counts, and fails below
    require('busy_ms' in prof, f'train profile: {prof}')
    prof['idle_share_of_median_step'] = 1 - prof['busy_ms'] / (med * 1e3)
    fused = fb.bottleneck_eval_cuda.launches

    losses = [m['loss'].item() for m in metrics]
    norms = [m['grad_norm'].item() for m in metrics]
    print('train: ' + json.dumps(dict(
        steps=TRAIN_STEPS, warmup=TRAIN_WARMUP, batch=list(TRAIN_BATCH),
        dtype=cfg.compute_dtype, step_s=secs, median_step_s=med,
        median_clips_per_s=videos / med,
        median_frames_per_s=videos * TRAIN_BATCH[1] / med,
        max_memory_allocated_gib=peak / 2 ** 30,
        flops_per_step=flops, train_mfu=flops / med / PEAK_FLOPS['bfloat16'],
        loss=losses, grad_norm=norms, lr=[m['lr'] for m in metrics],
        fused_launches=fused, card=card_line())))
    print('train profile: ' + json.dumps(prof))
    require(all(np.isfinite(losses + norms)),
            f'non-finite train metrics: {losses} {norms}')
    require(FIRST_LOSS[0] <= losses[0] <= FIRST_LOSS[1],
            f'first loss {losses[0]} outside {FIRST_LOSS}')
    after = model.state_dict()
    still = [k for k, v in before.items() if 'num_batches' not in k
             and torch.equal(v, after[k])]
    require(not still, f'train steps left {still[:5]} unchanged')
    require(fused == 0, f'the fused eval kernel launched {fused} times '
                        f'while training')
    require(prof['busy_ms'] <= max(secs) * 1e3,
            f"device busy {prof['busy_ms']} ms in the profiled step exceeds "
            f'the slowest unprofiled step, {max(secs) * 1e3} ms')

    # one step from a copy of the trained state, in bf16 and in fp32
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    one = {}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for dtype in ('bfloat16', 'float32'):
            twin = copy.deepcopy(model)
            twin.dtype = getattr(torch, dtype)
            twin_step = train_step_for(twin)
            twin_step.state.step = step.state.step
            m = twin_step(*batches[0],
                          torch.Generator(device='cuda').manual_seed(1))
            one[dtype] = (m['loss'].item(), m['grad_norm'].item())
            del twin, twin_step, m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = [abs(a - b) / abs(b) for a, b in zip(one['bfloat16'],
                                                one['float32'])]
    print('train compare: ' + json.dumps(dict(
        bf16=one['bfloat16'], fp32=one['float32'], loss_rel=rel[0],
        grad_norm_rel=rel[1], tol=[2e-2, 5e-2])))
    require(rel[0] <= 2e-2, f'bf16 vs fp32 loss: relative {rel[0]}')
    require(rel[1] <= 5e-2, f'bf16 vs fp32 grad norm: relative {rel[1]}')

    # the trained model answers a dense-test video through the kernel
    model.eval()
    eval_step = make_eval_step(model,
                               norm_cfg=dict(cfg.img_norm_cfg, device=True))
    video = np.random.RandomState(0).randint(
        0, 256, (1, VIEWS * TRAIN_BATCH[1], CROP, CROP, 3), dtype=np.uint8)
    launches = compare_with_plain('train eval', eval_step, model, video)
    expected = {('bfloat16',) + shape + (cm,): per_video
                for _, shape, cm, per_video in FUSED_SHAPES if per_video}
    require(launches == expected,
            f'trained model: fused kernel launches {launches}, expected '
            f'{expected}')


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
        phase_train()
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
