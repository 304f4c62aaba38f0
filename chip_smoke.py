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
5. data: prints the host's image libraries, cores and memory, writes a
   rawframe dataset (8 videos x 300 JPEG frames of 455x256,
   cv2.imwrite) and a random flagship checkpoint (.pth) to a temporary
   directory, and runs the port's dense-test CLI in-process with
   ``--fcn_testing``, once with the config's host ``Normalize`` (float32
   frames uploaded) and once with ``Normalize(device=True)`` (uint8), each
   as a warm-up pass, a timed pass and a profiled pass. Checks the pickled
   scores (8 rows of 400, finite, summing to 1), the printed accuracies
   against numpy, the CLI's scores against the eval step on the same
   frames and the two cases against each other (within 1e-5), and 2 + 3
   bf16 fused launches per video at the two shapes only; prints a ``data:``
   line per case (decoder, host and loader rates, bytes uploaded, device
   busy time and idle share).

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
# the data phase: a rawframe dataset of DATA_VIDEOS videos of DATA_FRAMES
# JPEG frames of DATA_HW (a 16:9 Kinetics frame after the short-edge-256
# extraction), labels 0.. of 400 classes, driven through the port's CLI
DATA_VIDEOS, DATA_FRAMES, DATA_HW = 8, 300, (256, 455)
# CLI scores against the eval step on the same frames, and host against
# device normalization: the same arithmetic, so at most rounding apart
DATA_TOL = 1e-5
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
    copies = {}
    for s, e, name in spans:
        us = e - s
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0) + us
        by_name[name[:80]] = by_name.get(name[:80], 0) + us
        if name.startswith('Memcpy'):
            n, t = copies.get(name, (0, 0.0))
            copies[name] = (n + 1, t + us)
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        wall_ms=wall_ms, kernels=len(spans),
        kernel_ms=sum(by_kind.values()) / 1e3, busy_ms=busy / 1e3,
        idle_share=1 - busy / 1e3 / wall_ms,
        by_kind_ms={k: v / 1e3 for k, v in sorted(
            by_kind.items(), key=lambda kv: -kv[1])},
        top_kernels_ms=[[n, v / 1e3] for n, v in top],
        copies={k: dict(count=n, ms=t / 1e3) for k, (n, t) in copies.items()})


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


def host_census():
    """What the machine offers the host pipeline: the image libraries, the
    JPEG headers and shared libraries, cores and memory."""
    import ctypes.util
    import importlib
    out = {}
    for mod in ('cv2', 'PIL', 'numpy', 'torchvision'):
        try:
            out[mod] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod] = None
    out['jpeglib.h'] = os.path.exists('/usr/include/jpeglib.h')
    out['nvjpeg.h'] = os.path.exists('/usr/local/cuda/include/nvjpeg.h')
    out['libjpeg'] = ctypes.util.find_library('jpeg')
    out['libnvjpeg'] = ctypes.util.find_library('nvjpeg')
    out['cpu_count'] = os.cpu_count()
    out['mem_gib'] = (os.sysconf('SC_PAGE_SIZE')
                      * os.sysconf('SC_PHYS_PAGES') / 2 ** 30)
    return out


def _synthetic_video(path, seed):
    """DATA_FRAMES JPEGs of smooth random content that fades between two
    coarse fields, with mid-frequency texture and mild noise (white noise
    would encode at many times a real frame's size); their sizes."""
    import cv2
    import numpy as np
    rs = np.random.RandomState(seed)
    h, w = DATA_HW
    a, b = (rs.rand(6, 10, 3).astype(np.float32) * 255 for _ in range(2))
    mid = cv2.resize((rs.randn(32, 57, 3) * 20).astype(np.float32), (w, h))
    noise = [(rs.randn(h, w, 3) * 2).astype(np.float32) for _ in range(4)]
    os.makedirs(path)
    sizes = []
    for t in range(DATA_FRAMES):
        s = t / max(DATA_FRAMES - 1, 1)
        img = cv2.resize(a * (1 - s) + b * s, (w, h),
                         interpolation=cv2.INTER_CUBIC)
        img = np.clip(img + mid + noise[t % 4], 0, 255).astype(np.uint8)
        name = os.path.join(path, f'img_{t + 1:05}.jpg')
        require(cv2.imwrite(name, img), f'cv2.imwrite failed for {name}')
        sizes.append(os.path.getsize(name))
    return sizes


def write_dataset(root):
    """The rawframe videos and their annotation file under ``root``; returns
    the annotation file and the mean frame size in bytes."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(DATA_VIDEOS, os.cpu_count() or 1)) as pool:
        sizes = list(pool.map(
            lambda i: _synthetic_video(os.path.join(root, f'video_{i}'), i),
            range(DATA_VIDEOS)))
    ann = os.path.join(root, 'test_list.txt')
    with open(ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for i in range(DATA_VIDEOS))
    return ann, statistics.mean(s for v in sizes for s in v)


def write_config(root, ann, device_norm):
    """A config that inherits the flagship and overrides the test split's
    annotation file and data root and, with ``device_norm``, its
    ``Normalize`` (the whole pipeline list, since lists replace)."""
    import re
    from mvfnet_tpu_torch.config import Config
    test = dict(ann_file=ann, data_root=root)
    if device_norm:
        test['pipeline'] = [
            dict(op, device=True) if op['type'] == 'Normalize' else dict(op)
            for op in Config.fromfile(CONFIG).data['test']['pipeline']]
    text = re.sub(r'\binf\b', "float('inf')",
                  f'_base_ = {CONFIG!r}\ndata = dict(test={test!r})\n')
    path = os.path.join(root, f'test_{int(device_norm)}.py')
    with open(path, 'w') as f:
        f.write(text)
    return path


def run_cli(config, ckpt, out):
    """The port's CLI in-process, as a user runs the dense test; returns
    what it printed."""
    import contextlib
    import io
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main([config, ckpt, '--fcn_testing', '--videos_per_gpu', '1',
                  '--out', out])
    return buf.getvalue()


class _TimedOp:
    """A pipeline op that appends its ms per call to ``log[name]``."""

    def __init__(self, op, log):
        self.op, self.log = op, log

    def __call__(self, results):
        t0 = time.perf_counter()
        out = self.op(results)
        self.log.setdefault(type(self.op).__name__, []).append(
            (time.perf_counter() - t0) * 1e3)
        return out


def numpy_accuracy(scores, labels):
    """Top-1, top-5 and mean-class accuracy recomputed in numpy, with the
    reference's confusion matrix over the labels and predictions seen."""
    import numpy as np
    scores, labels = np.asarray(scores), np.asarray(labels)
    order = np.argsort(scores, axis=1)
    top1 = float(np.mean(order[:, -1] == labels))
    top5 = float(np.mean((order[:, -5:] == labels[:, None]).any(1)))
    pred = scores.argmax(1)
    accs = [float(np.mean(pred[labels == c] == c)) if (labels == c).any()
            else 0.0 for c in np.unique(np.concatenate([pred, labels]))]
    return top1, top5, float(np.mean(accs))


def phase_data():
    """The dense-test entry point on a rawframe dataset: the port's CLI with
    host and with device normalization. Returns the fused kernel's launches
    in each case's timed pass, by (dtype, N, H, W, Cin, Cm)."""
    import pickle
    import re
    import tempfile

    import cv2
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import (DataLoader, ShardedSampler,
                                       build_dataset, default_collate,
                                       device_norm_cfg)
    from mvfnet_tpu_torch.engine import eval as eval_mod
    from mvfnet_tpu_torch.engine import prefetch
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import test_recognizer as cli

    expected = {('bfloat16',) + shape + (cm,): per_video * DATA_VIDEOS
                for _, shape, cm, per_video in FUSED_SHAPES if per_video}
    launches, rows = {}, {}
    print('host: ' + json.dumps(host_census()))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ann, frame_bytes = write_dataset(root)
        print(f'data set: {DATA_VIDEOS} videos x {DATA_FRAMES} frames of '
              f'{DATA_HW[1]}x{DATA_HW[0]}, mean JPEG {frame_bytes:.0f} bytes, '
              f'written in {time.perf_counter() - t0:.3f} s with cv2 '
              f'{cv2.__version__}')
        ckpt = os.path.join(root, 'mvf_r50_random.pth')
        flagship = Config.fromfile(CONFIG)
        model = cli.build_model(flagship, True, 'prob')
        model.init_weights(torch.Generator().manual_seed(0),
                           randomize_bn=True)
        torch.save(model.state_dict(), ckpt)
        model.to('cuda')
        labels = list(range(DATA_VIDEOS))

        for case, device_norm in (('host_norm', False), ('device_norm', True)):
            config = write_config(root, ann, device_norm)
            out = os.path.join(root, f'scores_{case}.pkl')
            run_cli(config, ckpt, out)                       # warm-up pass
            torch.cuda.synchronize()
            fb.bottleneck_eval_cuda.launches = 0
            fb.bottleneck_eval_cuda.launches_by_shape.clear()
            # the timed pass records the eval loop's time and keeps the
            # stager that uploads its batches, for its byte counters
            evaluate, eval_s = eval_mod.evaluate_dataset, []
            stager_cls, stagers = prefetch.PinnedStager, []

            def timed_evaluate(*args, **kwargs):
                t1 = time.perf_counter()
                scores = evaluate(*args, **kwargs)   # on the host: synced
                eval_s.append(time.perf_counter() - t1)
                return scores

            def kept_stager(device):
                stagers.append(stager_cls(device))
                return stagers[-1]
            eval_mod.evaluate_dataset = timed_evaluate
            prefetch.PinnedStager = kept_stager
            t0 = time.perf_counter()
            try:
                text = run_cli(config, ckpt, out)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            finally:
                eval_mod.evaluate_dataset = evaluate
                prefetch.PinnedStager = stager_cls
            require(len(stagers) == 1, f'{case}: {len(stagers)} stagers')
            stager = stagers[0]
            launches[case] = dict(fb.bottleneck_eval_cuda.launches_by_shape)
            with open(out, 'rb') as f:
                rows[case] = pickle.load(f)

            require(len(rows[case]) == DATA_VIDEOS and all(
                r.shape == (400,) for r in rows[case]),
                f'{case}: scores {[r.shape for r in rows[case]]}')
            got = np.stack(rows[case])
            require(bool(np.isfinite(got).all()), f'{case}: non-finite')
            require(bool((np.abs(got.sum(1) - 1) <= 1e-3).all()),
                    f'{case}: class probabilities sum to {got.sum(1)}')
            require(launches[case] == expected,
                    f'{case}: fused kernel launches {launches[case]}, '
                    f'expected {expected}')
            require(fb.bottleneck_eval_cuda.launches
                    == sum(expected.values()),
                    f'{case}: fused kernel launched '
                    f'{fb.bottleneck_eval_cuda.launches} times in all')
            printed = dict(re.findall(r'^(Top-1|Top-5|Mean Class) Accuracy '
                                      r'= (\d+\.\d\d)$', text, re.M))
            want = numpy_accuracy(got, labels)
            require(printed == {k: f'{v * 100:.02f}' for k, v in zip(
                ('Top-1', 'Top-5', 'Mean Class'), want)},
                f'{case}: printed {printed}, numpy {want}')

            # the same frames straight through the eval step, each
            # pipeline op, the collate and the pinned copy timed
            cfg = Config.fromfile(config)
            dataset = build_dataset(dict(cfg.data['test']))
            decoder = dataset.pipeline.transforms[1].decoder
            step = make_eval_step(model, norm_cfg=device_norm_cfg(
                cfg.data['test']['pipeline']))
            op_ms, item_ms, direct, pinned = {}, [], [], None
            ops = dataset.pipeline.transforms
            dataset.pipeline.transforms = [_TimedOp(t, op_ms) for t in ops]
            for i in range(DATA_VIDEOS):
                t1 = time.perf_counter()
                sample = dataset[i]
                item_ms.append((time.perf_counter() - t1) * 1e3)
                t1 = time.perf_counter()
                batch = default_collate([sample])['img_group']
                op_ms.setdefault('collate', []).append(
                    (time.perf_counter() - t1) * 1e3)
                if pinned is None:
                    pinned = torch.empty(batch.shape, pin_memory=True,
                                         dtype=torch.from_numpy(batch).dtype)
                t1 = time.perf_counter()
                pinned.numpy()[...] = batch
                op_ms.setdefault('pinned_copy', []).append(
                    (time.perf_counter() - t1) * 1e3)
                direct.append(step(model, batch).float().cpu().numpy()[0])
            dataset.pipeline.transforms = ops
            err = float(np.abs(got - np.stack(direct)).max())
            require(err <= DATA_TOL, f'{case}: CLI scores vs eval step: max '
                                     f'abs err {err} > {DATA_TOL}')
            loader = DataLoader(dataset, 1, ShardedSampler(
                len(dataset), shuffle=False),
                num_workers=cfg.data['workers_per_gpu'])
            t1 = time.perf_counter()
            n = sum(len(b['img_group']) for b in loader)
            loader_s = time.perf_counter() - t1
            prof = device_profile(lambda: run_cli(config, ckpt, out))
            require('busy_ms' in prof, f'{case} profile: {prof}')
            htod = {k: v for k, v in prof['copies'].items() if 'HtoD' in k}
            print('data: ' + json.dumps(dict(
                case=case, decoder=decoder,
                cpu_count=os.cpu_count(), videos=DATA_VIDEOS,
                clips_per_video=VIEWS, pass_s=secs, eval_s=eval_s[0],
                videos_per_s=DATA_VIDEOS / secs,
                clips_per_s=DATA_VIDEOS * VIEWS / secs,
                item_ms_one_thread=statistics.median(item_ms),
                host_ms_by_op={k: statistics.median(v)
                               for k, v in op_ms.items()},
                loader_videos_per_s=n / loader_s,
                loader_workers=cfg.data['workers_per_gpu'],
                bytes_uploaded_per_video=stager.bytes_uploaded
                / stager.uploads,
                upload_dtype=str(sample['img_group'].dtype),
                htod_copies=htod, device_busy_ms=prof['busy_ms'],
                device_idle_share=prof['idle_share'],
                profiled_pass_ms=prof['wall_ms'],
                fused_launches=sum(launches[case].values()),
                cli_vs_step_max_abs_err=err, card=card_line())))
            print(f'data profile {case}: ' + json.dumps(prof))
            del dataset, loader, step, pinned
    err = float(np.abs(np.stack(rows['host_norm'])
                       - np.stack(rows['device_norm'])).max())
    print(f'data compare: host vs device normalization max abs err {err}')
    require(err <= DATA_TOL, f'host vs device normalization: max abs err '
                             f'{err} > {DATA_TOL}')
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
        phase_train()
        data_launches = phase_data()
        for r in records:
            key = (r['dtype'],) + tuple(r['shape'])
            r['launches'] = launches.get(key, 0)
            r['launches_cli'] = {case: n.get(key, 0)
                                 for case, n in data_launches.items()}
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
