#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. build: compiles the port's CUDA kernels from ``mvfnet_tpu_torch/csrc``
   with nvcc, one process per source at once, and prints ptxas's register
   report.
2. kernel: holds each kernel against its plain PyTorch version on the card,
   in float32 (TF32 off) and bfloat16, at the unit-test shapes and at the
   shapes the dense-test path and the train CLI's evaluation give it, and
   times kernel, plain version and the bound with CUDA events (at the four
   small eval shapes also the kernel's device time from torch.profiler).
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
6. train CLI: on the same videos (each listed 6 times in a train split, 48
   entries; once in a val split) runs the port's train CLI in-process on
   a config that inherits the flagship (2 epochs of 4 iterations of
   12 x 8 x 224^2, bf16, the recipe's SGD and clip at 40, a checkpoint, a
   log line per iteration and an evaluation after each epoch), with the
   config's host ``Normalize`` and with ``Normalize(device=True)``. Checks
   finite losses, the first near ln 400, the checkpoints and ``train.log``,
   that ``latest.pth`` imports with an empty report into a model equal to
   the trained one, 2 + 3 bf16 fused launches per val video at the
   evaluation's two shapes and none in the train steps, the logged top-1/5
   against numpy on the evaluations' scores, one val video of the trained
   model against its plain path, and a run resumed from ``epoch_1.pth``
   against epoch 2 of the unbroken run; then profiles one more epoch and
   times the train loader and its ops; prints a ``train_cli:`` line per
   case (s/iter, clips/s, loader rate, bytes per iteration, device busy
   time and idle share, fused launches by shape).
7. the JAX package's other entry points, on the same videos: the seeded
   model written as a ``.msgpack`` (``save_msgpack_checkpoint``) scores
   through the test CLI within 1e-5 of phase 5's ``.pth`` (device
   normalization), with each format's bytes and load time; phase 6's
   state after epoch 1 written as a ``.msgpack`` with its SGD state in
   optax's layout resumes the train CLI to epoch 2's losses within 2e-2 of
   the ``.pth`` resume's; the feature CLI (``--fcn_testing``, device
   normalization, the ``.msgpack``) writes 8 entries of 30 x 2048 finite
   floats with 2 + 3 fused launches a video, whose FC lies within
   3e-2 of the largest of the eval step's per-clip logits, with a warm-up,
   a timed and a profiled pass (a ``features:`` line); ``count_flops`` on
   the flagship gives 24,342,416 parameters and the convolution and FC
   multiply-adds worked out from the layers' shapes; ``report_accuracy`` on
   phase 5's two score pickles prints numpy's accuracies, with and without
   a softmax.
8. the engine's processes, on the same videos, checkpoint and train
   config (b): (a) under torchrun at world 1 with ``--launcher env`` on
   NCCL, the test CLI (scores within 1e-5 of phase 5's, 16 + 24 fused
   launches) and the train CLI (phase 6's losses within 2e-2, its s/iter
   beside phase 6's); (b) two ranks on one card over gloo (NCCL refuses
   two ranks on one device), spawned as ``--gpus`` spawns them: the test
   CLI (scores in dataset order within 1e-5 of phase 5's, 8 + 12 launches
   a rank), 3 train steps of 2 ranks x 6 clips at 224^2, bf16, against
   world 1 on the 12 clips (losses within 2e-2, grad norms within 5e-2)
   and the train CLI for an epoch with an evaluation (one set of
   checkpoints, importing with an empty report; 8 + 12 launches a rank).
   Every rank and torchrun run has a deadline; ``dist:`` lines. The
   ranks run this script again as ``chip_smoke.py --rank REPORT JOBS``.

9. video files: prints a census of the host's video stack (cv2's
   backends and FFmpeg, PyAV and decord looked up but not imported,
   libavcodec), writes phase 5's frames as 8 mp4v files of 300 frames at
   30 fps (cv2 must read back every frame and probe 300), then: (c) the
   test CLI on the unchanged model and test pipeline of the 4x16 video
   recipe (R50+MVF, T=4, ``PyAVDecode(accurate=False)``, 10 clips x 3
   crops of 256^2, ``--fcn_testing``, bf16) as a warm-up, a timed and a
   profiled pass: scores, printed accuracies against numpy, 2 + 3 bf16
   fused launches a video at N = 120, one video against the plain path,
   seek against sequential decode of the same indices; (d) the train CLI
   for one epoch of 4 iterations of 12 x 4 x 224^2 on the recipe's train
   and val pipelines, with an evaluation (2 + 3 launches a val video at
   N = 4, none in the steps) and a checkpoint; (e) the flagship train
   step from one state with and without ``with_cp``: loss, gradient norm
   and BatchNorm statistics within 2e-2, each BatchNorm counting one
   batch, and less peak memory with it; (f) R18+MVF, R34, R50 with
   avg_down + avd + deep_stem and R50 with GN: a bf16 eval forward on the
   card within 3e-2 of max|logit| of the fp32 forward on the CPU, the
   fused launches expected, and one finite bf16 train step
   (``video_data:``, ``with_cp:`` and ``options:`` lines).

10. the 3-D families, on phase 5's frames: (a) for each shipped 3-D config
   (I3D-R50 32x2, SlowFast-R50 packed and unpacked, X3D), unchanged but
   for its test split, seeded random weights as a ``.pth`` and the test
   CLI (10 clips x 3 crops of 256^2, bf16) over 2 videos as a warm-up, a
   timed and a profiled pass: scores, printed accuracies against numpy,
   videos/s, device ms a video and idle share, no fused launch, one view
   of one video on the card within 3e-2 of max|logit| of the fp32 CPU
   forward, and the packed and unpacked SlowFast scores equal; (b) each
   family's train step at its config's batch (I3D 8 x 32, SlowFast 8 x
   64, X3D 16 x 16, 224^2): finite losses, median ms, peak GiB, and the
   I3D step with ``with_cp`` (the same loss, less peak memory); (c) the
   train CLI on the I3D config for 2 epochs of 2 iterations with
   evaluations and checkpoints, and a run resumed from epoch 1; (d) the
   feature CLI on the SlowFast config, rows of 2048 + 256 (``video3d:``,
   ``train3d:``, ``with_cp3d:``, ``train_cli3d:``, ``features3d:``
   lines).

11. the other 2-D families, on the same frames, bf16, seeded weights: (a)
   the shipped BNInception config (its splits and ``compute_dtype`` set):
   the test CLI over 2 videos (25 segments x TenCrop of 224^2) as a
   warm-up, a timed and a profiled pass, ``convert_checkpoint`` of its
   ``.pth`` scored again through the CLI (within 1e-5), a train step at
   its batch, the train CLI for 2 epochs of 2 iterations and a resume;
   (b)-(d) the flagship config with MobileNetV2-1.0 and TSM or MVF, R50
   with CoST or non-local blocks, the flagship with a TRN or TRNmultiscale
   head: a train step at 12 x 8 x 224^2 (bf16 against fp32 from one state,
   the median of 5 after 2 warm-ups, the peak) and a dense video through
   the eval step, its fused launches against the count worked out from
   the config (``expected_fused``); (e) the I3D config with non-local
   blocks in stages 2-3: one video and a train step; (f) RecognizerC2D,
   one clip; (g) ``validate_k400`` on the 8 videos with phase 5's flagship
   ``.pth`` (its JSON line). One view of each case on the card lies within
   3e-2 of max|logit| of the fp32 CPU forward (``family11:`` lines).

12. the int8 eval path and the last two 3-D backbones, bf16, seeded
   weights: (b) the flagship's dense test (240 x 256^2, the 5th of phase
   5's videos through its test pipeline) under ``int8``,
   ``int8_static`` with ``quant_stages`` (1, 1, 0, 0) and (1, 1, 1, 1),
   each calibrated through the test CLI with ``--calib_videos`` on 4 of
   phase 5's videos, and the (1, 1, 1, 1) ``quant_carry`` variant: per-clip
   logits within 5% rms of the same model's bf16 ones (the carry within 2%
   of its unfused twin), the fused launches worked out from
   ``quant_stages`` (none at quantized stages), clips/s, device ms a
   video, idle share and the device time of the quantize passes (their
   ``record_function`` ranges); (c) ``validate_k400 --quant int8_static
   --quant-stages 1 1 0 0`` on the 8 videos; (d) the shipped I3D config
   under ``int8_static`` (calibrated on the video) and the X3D config
   under ``int8``, one dense video each within 5% of bf16; (e) the
   (1, 1, 0, 0) model's ``.msgpack`` read back into a fresh model, logits
   within 1e-5; (g) a quantized model in training raises; (a) the int8
   kernel at every shape (b) and (d) launched, bit for bit against its
   plain version (N cut to 16 for the f64 plain version, both epilogues),
   timed beside the plain version, its bound and ``torch._int_mm`` at the
   1x1 stride-1 shapes; (f) R(2+1)D-34 at 8 x 112^2 and InceptionV1-I3D at
   64 x 224^2: a train step (median of 5 after 2 warm-ups, the peak), a
   dense video's device time, one view against the fp32 CPU forward
   (``int8:``, ``int8 kernel:``, ``family12:`` lines).

13. the native decode worker and the Orbax step directories, on phase 5's
   frames: (a) a census of nvJPEG (version, backend), libzstd and
   zstandard (looked up, not imported); (b) nvJPEG (with the ycc_to_bgr
   kernel) against cv2.imdecode on every frame of the set and on the JPEG
   kinds of ``tools/jpeg_kinds.py`` (4:2:0, 4:4:4, 4:2:2, grayscale, odd
   size, restart markers, progressive): max and mean absolute difference,
   the share of values that differ, within the card tests' bounds, every
   frame of the set equal to ycc_to_bgr's plain version on the planes
   nvJPEG decoded, and a video's batch equal to its single decodes; (c)
   decode ms a frame: nvJPEG batched, cv2 on one thread, and the 4-thread
   loader with each;
   (d) the test CLI with host and with device normalization, each on
   nvJPEG frames and on cv2 frames (``FrameSelector(use_native=False)``):
   videos/s, device ms a video, idle share, the frames each decoder gave
   (none to cv2 on nvJPEG), the frames the ycc_to_bgr kernel converted
   (those nvJPEG decoded) and its launches (one a decode call), 2 + 3
   fused launches a video, probabilities within 3e-2 of the largest of the
   cv2 run's; then the ycc_to_bgr kernel on a decode call's 80 frames and
   on one frame, bit for bit against its plain version, its device time
   from torch.profiler and CUDA events; (e) the flagship's state
   after two train steps through ``save_checkpoint_orbax`` and
   ``load_checkpoint_orbax``: weights and momentum bit for bit, seconds and
   MB; (f) the committed JAX-written Orbax fixture
   (``tests/golden/orbax``) equal to its ``.msgpack`` twin bit for bit
   (``decode:``, ``decode_cli:`` and ``orbax:`` lines).

Prints the ``{"kernels": [...]}`` line (launches of the fused kernel per
shape in phases 3, 5, 6 and 7, per rank in phase 8's cases as
``launches_dist``, per case in phase 9 as ``launches_video``, in phase
10 as ``launches_3d``, in phase 11 as ``launches_2d``, in phase 12 as
``launches_int8`` and in phase 13 as ``launches_decode``; then one record
per shape of the int8 kernel, its ``launches`` those of phase 12's timed
calls; then the ycc_to_bgr kernel's, its ``launches`` and ``frames``
those of phase 13 (d)'s device-normalization run on nvJPEG, every case's
in ``launches_decode``; the four fused records of ``DEVICE_TIMED`` and
the ycc_to_bgr record carry ``device_ms``, the profiler's device time,
beside the event-timed ``ms``), the card's name and power limit, and
last ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside it, it exits non-zero and prints no result.
"""

import collections
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
    ('val_layer1', (8, 56, 56, 256), 64, 0),
    ('val_layer2', (8, 28, 28, 512), 128, 0),
    ('video_layer1', (120, 64, 64, 256), 64, 0),
    ('video_layer2', (120, 32, 32, 512), 128, 0),
    ('video_val_layer1', (4, 56, 56, 256), 64, 0),
    ('video_val_layer2', (4, 28, 28, 512), 128, 0),
    ('nonlocal_layer3', (240, 16, 16, 1024), 256, 0),
    ('nonlocal_layer4', (240, 8, 8, 2048), 512, 0),
]
# val_layer1-2 are the train CLI's mid-train evaluation (one clip of 8
# frames at a 224^2 centre crop); their launches per val video. The video_
# shapes are the 4x16 video recipe's (phase 9): its dense test (3 crops x
# 10 clips x 4 frames at 256^2) and its train CLI's evaluation (4 frames);
# nonlocal_layer3-4 are phase 11's R50 without MVF (non-local blocks), whose
# stages 3-4 fuse too
VAL_LAUNCHES = {'val_layer1': 2, 'val_layer2': 3}
# bf16 shapes whose rows do not fit the tiled kernel's shared memory: they
# take the general kernel (every other bf16 shape with Cin and Cm multiples
# of 64 must take the tiled one)
GENERAL_BF16 = {'nonlocal_layer3'}
# shapes whose kernel is shorter than its Python wrapper: their records
# also carry the profiler's device time (``device_ms``)
DEVICE_TIMED = {'val_layer1', 'val_layer2', 'video_val_layer1',
                'video_val_layer2'}
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
# the train CLI phase: the data phase's videos listed TRAIN_REPEAT times
# in the train split (48 entries: 4 iterations of 12 an epoch) and once in
# the val split, TRAIN_EPOCHS epochs with a checkpoint, a log line and an
# evaluation after each; a run resumed from epoch 1 repeats epoch 2's
# losses within RESUME_TOL relative (cuDNN's bf16 backward is not bitwise
# deterministic; the CPU test checks equality)
TRAIN_REPEAT, TRAIN_EPOCHS = 6, 2
RESUME_TOL = 2e-2
# phase 8: the ranks' device under torchrun (cuda:LOCAL_RANK, NCCL) and
# the one card two gloo ranks share; DIST_STEPS train steps of DIST_CLIPS
# clips a rank; every rank and torchrun run get DIST_TIMEOUT seconds
DIST_DEVICE, DIST_SHARED_DEVICE = 'cuda', 'cuda:0'
DIST_STEPS, DIST_CLIPS = 3, 6
DIST_TIMEOUT = 300
# phase 9: the 4x16 video recipe, read from mp4v files of phase 5's frames
# at VIDEO_FPS; its seek decode must equal its sequential decode of the same
# indices within VIDEO_DECODE_DIFF (0: as on the CPU, with cv2 4.13's
# FFmpeg)
VIDEO_CONFIG = os.path.join(ROOT, 'configs', 'mvf', 'k400',
                            'mvf_kinetics400_video_r50_4x16_dense.py')
VIDEO_FPS = 30
VIDEO_DECODE_DIFF = 0
# phase 10: the shipped 3-D configs, unchanged but for their data splits;
# the dense test scores DENSE3D_VIDEOS of phase 5's videos (300 frames hold
# each config's clip: I3D 32 x 2, SlowFast 64 x 1, X3D 16 x 5); the train
# step takes each family's configured batch, TRAIN3D_STEPS timed steps
# after one warm-up
CONFIGS_3D = {
    'i3d': os.path.join(ROOT, 'configs', 'i3d', 'i3d_r50_32x2_k400.py'),
    'slowfast': os.path.join(ROOT, 'configs', 'slowfast',
                             'slowfast_r50_k400.py'),
    'slowfast_unpacked': os.path.join(ROOT, 'configs', 'slowfast',
                                      'slowfast_r50_k400_unpacked.py'),
    'x3d': os.path.join(ROOT, 'configs', 'x3d', 'x3d_k400.py'),
}
DENSE3D_VIDEOS = 2
TRAIN3D_STEPS = 3
# phase 11: the shipped BNInception config's test CLI over FAMILY_VIDEOS of
# phase 5's videos (25 segments x TenCrop of 224^2); the 2-D cases of
# FAMILY_2D (MobileNetV2-1.0 with TSM and with MVF, R50 with CoST or
# non-local blocks in place of MVF, the flagship with a TRN and a
# TRNmultiscale head) each train at the flagship's batch and score a dense
# video FAMILY_EVAL_RUNS times
BNI_CONFIG = os.path.join(ROOT, 'configs', 'tsn', 'tsn_bninception_k400.py')
FAMILY_VIDEOS = 2
FAMILY_2D = ('mbv2_tsm', 'mbv2_mvf', 'r50_cost', 'r50_nonlocal', 'mvf_trn',
             'mvf_trnmultiscale')
FAMILY_EVAL_RUNS = 3
# phase 12: the flagship's dense test under each int8 case (backbone
# options over the config's; the static ones calibrated by the test CLI on
# INT8_CALIB_VIDEOS of phase 5's videos, the carry with the stats of its
# unfused twin; one case leaves stages unquantized that then fuse), INT8_RUNS timed calls each; the int8 kernel checked bit
# for bit at every shape with N cut to INT8_CHECK_N for its f64 plain
# version; R(2+1)D-34 at its paper's 8 x 112^2 clips and InceptionV1-I3D at
# the I3D paper's 64 x 224^2 (backbone, feature width, frames, crop, train
# batch)
INT8_CASES = {
    'int8': dict(quant='int8'),
    'static_1100': dict(quant='int8_static', quant_stages=(1, 1, 0, 0)),
    'static_1111': dict(quant='int8_static', quant_stages=(1, 1, 1, 1)),
    'carry_1111': dict(quant='int8_static', quant_stages=(1, 1, 1, 1),
                       quant_carry=True),
    # layer1-2 unquantized and without MVF: their blocks still fuse
    'int8_0011': dict(quant='int8', quant_stages=(0, 0, 1, 1)),
}
INT8_CALIBRATED = ('static_1100', 'static_1111')
# the carry case: the calibration of its unfused twin, and held against it
INT8_TWIN = {'carry_1111': 'static_1111'}
INT8_MSGPACK = 'static_1100'
INT8_CALIB_VIDEOS, INT8_RUNS, INT8_CHECK_N = 4, 3, 16
INT8_KERNEL = dict(name='int8_conv', route='cuda',
                   source='mvfnet_tpu_torch/csrc/int8_conv.cu',
                   replaces='mvfnet_tpu/models/common.py:303')
NEW_3D = {
    'r2plus1d_34': (dict(type='ResNet_R3D', depth=34, block_type='2.5d',
                         bn_eval=False, bn_frozen=False), 512, 8, 112, 8),
    'inception_i3d': (dict(type='InceptionV1_I3D', bn_eval=False), 1024, 64,
                      224, 4),
}
KERNEL = dict(name='fused_bottleneck', route='cuda',
              source='mvfnet_tpu_torch/csrc/fused_bottleneck.cu',
              replaces='mvfnet_tpu/ops/fused_block.py:144')
# phase 13: nvJPEG against cv2 (tests/test_torch_native_io.py's bounds:
# mean absolute difference a value, and the largest: the IDCTs round apart
# by 1 a sample, which B = Y + 1.772 (Cb - 128) turns into at most 3); the
# CLI's probabilities on nvJPEG frames against cv2 frames, relative to the
# largest; the committed JAX-written Orbax fixture and its step. The
# ycc_to_bgr kernel replaces no TPU kernel: the JAX package's native worker
# converts to BGR in libjpeg (the line named)
DECODE_MEAN_ABS, DECODE_MAX_ABS = 1.0, 3
DECODE_TOL = 3e-2
GOLDEN_ORBAX, GOLDEN_STEP = os.path.join(ROOT, 'tests', 'golden'), 7
YCC_KERNEL = dict(name='ycc_to_bgr', route='cuda',
                  source='mvfnet_tpu_torch/csrc/nvjpeg_decode.cu',
                  replaces='native/jpeg_decoder.cpp:61')


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
    queued back to back with no sync between them, so the host's work in a
    call hides behind the device's work of the one before only where that
    work is longer: for a kernel shorter than its Python wrapper, the events
    measure the wrapper (``device_ms`` reads the kernel's own time)."""
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


def device_ms(fn, match, runs=TIMED_RUNS, warmup=3):
    """The device time of one call of ``fn``, which launches one kernel
    whose name holds ``match``: the mean of its durations from
    torch.profiler over ``runs`` calls queued back to back after warm-up
    (``tools/ycc_bench.kernel_spans``)."""
    from mvfnet_tpu_torch.tools.ycc_bench import kernel_spans
    for _ in range(warmup):
        fn()
    spans = kernel_spans(fn, runs, match, launches=1)
    return sum(e - s for s, e in spans) / len(spans) / 1e3


def phase_build():
    """The three CUDA sources compiled at once (one nvcc each), then
    loaded."""
    from concurrent.futures import ThreadPoolExecutor
    from mvfnet_tpu_torch.data import native_io
    from mvfnet_tpu_torch.ops import _cuda
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.ops import int8_conv as q8
    sources = ('fused_bottleneck', 'int8_conv', 'nvjpeg_decode')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_cuda._build, sources))
    libs = [fb.library(), q8.library(), native_io.library()]
    secs = time.perf_counter() - t0
    for name in sources:
        for line in _cuda.build_logs.get(name, '').splitlines():
            if 'registers' in line or 'Compiling' in line or 'spill' in line:
                print(f'nvcc {name}: {line.strip()}')
    print(f'build: {", ".join(os.path.basename(lib._name) for lib in libs)} '
          f'in {secs:.3f} s')


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
                if name in DEVICE_TIMED:
                    with torch.inference_mode():
                        kernel_device_ms = device_ms(
                            lambda: fb.bottleneck_eval_cuda(*args),
                            'fused_bottleneck')
                rec = dict(
                    KERNEL, case=name, shape=list(shape) + [cm],
                    dtype=dtype_name,
                    path=fb.kernel_path(dtype, h, w, cin, cm),
                    max_abs_err=err, tol=tol, ms=kernel_ms, plain_ms=plain_ms,
                    bound_ms=max(t_ops, t_bytes),
                    bound_by='bytes' if t_bytes >= t_ops else 'operations',
                    flops=flops, bytes=nbytes, library_ms=None)
                if name in DEVICE_TIMED:
                    rec['device_ms'] = kernel_device_ms
                print('kernel check: ' + json.dumps(rec))
                require(ok, f'fused_bottleneck {name} {dtype_name}: max abs '
                            f'err {err} > tol {tol}')
                want_path = 'general' if name in GENERAL_BF16 else 'tiled'
                require(rec['path'] == want_path or dtype_name != 'bfloat16'
                        or cin % 64 or cm % 64,
                        f'fused_bottleneck {name}: bf16 took the '
                        f'{rec["path"]} kernel, not the {want_path} one')
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
                       ('int8_conv', ('int8_conv',)),
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


def device_profile(fn, spans=False):
    """Device time of one call by kernel kind, from torch.profiler: kernel
    time summed, the union of kernel intervals, and the call's host-clock
    wall time (its complement is the device's idle share). With ``spans``
    the port's spans are on during the call, so that its ranges (the
    ``int8_`` quantize passes) reach the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mvfnet_tpu_torch.utils import tracing
    was_on = tracing.enabled()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if spans:
            tracing.enable()
        t0 = time.perf_counter()
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            if spans and not was_on:
                tracing.disable()
                tracing.clear()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels and copies, not the device-side ranges of annotations
    # such as the optimizer's record_function
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False))
    # the device spans of the port's own ranges (the int8 quantize passes)
    ranges = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA and e.name.startswith('int8_')
                and getattr(e, 'is_user_annotation', False)):
            ranges[e.name] = ranges.get(e.name, 0.0) + (
                e.time_range.end - e.time_range.start) / 1e3
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
        copies={k: dict(count=n, ms=t / 1e3) for k, (n, t) in copies.items()},
        ranges_ms=ranges)


def compare_with_plain(phase, step, model, video):
    """One video's per-clip logits through the kernels against the same
    model with the kernels' plain versions; returns the fused kernel's
    launches in the kernel path's call, by (dtype, N, H, W, Cin, Cm)."""
    import torch
    from mvfnet_tpu_torch.ops import fused_block as fb
    test_cfg = model.test_cfg
    model.test_cfg = dict(average_clips=None)
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    kernel = fb.bottleneck_eval
    try:
        logits = step(model, video).float().cpu()
        launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)
        fb.bottleneck_eval = fb.bottleneck_eval_plain
        plain = step(model, video).float().cpu()
    finally:
        fb.bottleneck_eval = kernel
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
    import importlib.metadata
    out = {}
    for mod in ('cv2', 'PIL', 'numpy', 'torchvision'):
        try:
            out[mod] = importlib.import_module(mod).__version__
        except ImportError:
            out[mod] = None
    # information only, and not imported: the port carries its own codec
    try:
        out['msgpack'] = importlib.metadata.version('msgpack')
    except importlib.metadata.PackageNotFoundError:
        out['msgpack'] = None
    out['jpeglib.h'] = os.path.exists('/usr/include/jpeglib.h')
    out['nvjpeg.h'] = os.path.exists('/usr/local/cuda/include/nvjpeg.h')
    out['libjpeg'] = ctypes.util.find_library('jpeg')
    out['libnvjpeg'] = ctypes.util.find_library('nvjpeg')
    # the worker's nvJPEG (built in phase 1), and what the Orbax reader
    # does without: looked up, not imported
    from mvfnet_tpu_torch.data import native_io
    out['nvjpeg'] = '.'.join(map(str, native_io.nvjpeg_version()))
    out['nvjpeg_backend'] = ('NVJPEG_BACKEND_DEFAULT (hybrid: Huffman on '
                             'the calling thread, IDCT on the card)')
    # nvjpegCreateEx's status for NVJPEG_BACKEND_HARDWARE (3), the JPEG
    # engines: 0 where this machine exposes them
    out['nvjpeg_hardware_backend_status'] = \
        native_io.library().mvf_nvjpeg_backend_status(0, 3)
    out['libzstd'] = ctypes.util.find_library('zstd')
    for pkg in ('zstandard', 'orbax-checkpoint', 'tensorstore'):
        try:
            out[pkg] = importlib.metadata.version(pkg)
        except importlib.metadata.PackageNotFoundError:
            out[pkg] = None
    out['cpu_count'] = os.cpu_count()
    out['mem_gib'] = (os.sysconf('SC_PAGE_SIZE')
                      * os.sysconf('SC_PHYS_PAGES') / 2 ** 30)
    return out


def _synthetic_frames(seed):
    """DATA_FRAMES frames of DATA_HW of smooth random content that fades
    between two coarse fields, with mid-frequency texture and mild noise
    (white noise would encode at many times a real frame's size)."""
    import cv2
    import numpy as np
    rs = np.random.RandomState(seed)
    h, w = DATA_HW
    a, b = (rs.rand(6, 10, 3).astype(np.float32) * 255 for _ in range(2))
    mid = cv2.resize((rs.randn(32, 57, 3) * 20).astype(np.float32), (w, h))
    noise = [(rs.randn(h, w, 3) * 2).astype(np.float32) for _ in range(4)]
    for t in range(DATA_FRAMES):
        s = t / max(DATA_FRAMES - 1, 1)
        img = cv2.resize(a * (1 - s) + b * s, (w, h),
                         interpolation=cv2.INTER_CUBIC)
        yield np.clip(img + mid + noise[t % 4], 0, 255).astype(np.uint8)


def _synthetic_video(path, seed):
    """The synthetic frames as JPEGs under ``path``; their sizes."""
    import cv2
    os.makedirs(path)
    sizes = []
    for t, img in enumerate(_synthetic_frames(seed)):
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


def write_config(root, ann, device_norm, use_native=True):
    """A config that inherits the flagship and overrides the test split's
    annotation file and data root and, with ``device_norm``, its
    ``Normalize``, without ``use_native`` its ``FrameSelector`` (cv2
    frames on the card too; the whole pipeline list, since lists
    replace)."""
    import re
    from mvfnet_tpu_torch.config import Config
    test = dict(ann_file=ann, data_root=root)
    if device_norm or not use_native:
        ops = [dict(op) for op in Config.fromfile(CONFIG).data['test'][
            'pipeline']]
        for op in ops:
            if op['type'] == 'Normalize' and device_norm:
                op['device'] = True
            if op['type'] == 'FrameSelector' and not use_native:
                op['use_native'] = False
        test['pipeline'] = ops
    text = re.sub(r'\binf\b', "float('inf')",
                  f'_base_ = {CONFIG!r}\ndata = dict(test={test!r})\n')
    path = os.path.join(root, f'test_{int(device_norm)}'
                        f'{"" if use_native else "_cv2"}.py')
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


def pipeline_op_ms(fn):
    """Run ``fn`` with the port's spans on; the ms of each pipeline op's
    calls (the ``data.op.<Op>`` spans), by op."""
    from mvfnet_tpu_torch.utils import tracing
    tracing.clear()
    tracing.enable()
    try:
        fn()
    finally:
        tracing.disable()
    log = {}
    for s in tracing.collect():
        if s['name'].startswith('data.op.'):
            log.setdefault(s['name'][len('data.op.'):], []).append(
                (s['end_ns'] - s['start_ns']) / 1e6)
    tracing.clear()
    return log


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


def phase_data(root, ann):
    """The dense-test entry point on the rawframe dataset under ``root``
    (annotation file ``ann``): the port's CLI with host and with device
    normalization. Returns the fused kernel's launches in each case's timed
    pass, by (dtype, N, H, W, Cin, Cm)."""
    import pickle
    import re

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import (DataLoader, ShardedSampler,
                                       build_dataset, dataset_decoder,
                                       default_collate, device_norm_cfg)
    from mvfnet_tpu_torch.engine import eval as eval_mod
    from mvfnet_tpu_torch.engine import prefetch
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import test_recognizer as cli

    expected = {('bfloat16',) + shape + (cm,): per_video * DATA_VIDEOS
                for _, shape, cm, per_video in FUSED_SHAPES if per_video}
    launches, rows = {}, {}
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
        # stager that uploads its batches, for its byte counters; the
        # eval step, handed the batches on the card, makes none
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
        dataset = build_dataset(dict(cfg.data['test']), 'cuda')
        decoder = dataset_decoder(dataset)
        step = make_eval_step(model, norm_cfg=device_norm_cfg(
            cfg.data['test']['pipeline']))
        copy_ms, item_ms, direct, samples = {}, [], [], []

        def items():
            for i in range(DATA_VIDEOS):
                t1 = time.perf_counter()
                samples.append(dataset[i])
                item_ms.append((time.perf_counter() - t1) * 1e3)
        op_ms = pipeline_op_ms(items)
        pinned = None
        for sample in samples:
            t1 = time.perf_counter()
            batch = default_collate([sample])['img_group']
            copy_ms.setdefault('collate', []).append(
                (time.perf_counter() - t1) * 1e3)
            if pinned is None:
                pinned = torch.empty(batch.shape, pin_memory=True,
                                     dtype=torch.from_numpy(batch).dtype)
            t1 = time.perf_counter()
            pinned.numpy()[...] = batch
            copy_ms.setdefault('pinned_copy', []).append(
                (time.perf_counter() - t1) * 1e3)
            direct.append(step(model, batch).float().cpu().numpy()[0])
        op_ms.update(copy_ms)
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
            upload_chunks=stager.chunks, upload_slot_waits=stager.slot_waits,
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


def write_train_config(root, device_norm):
    """A config that inherits the flagship and overrides the train and val
    splits' annotation files and data root (with ``device_norm``, their
    ``Normalize``), the epochs and the hooks' intervals; its path."""
    import re
    from mvfnet_tpu_torch.config import Config
    flagship = Config.fromfile(CONFIG)
    train_ann = os.path.join(root, 'train_list.txt')
    with open(train_ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for _ in range(TRAIN_REPEAT) for i in range(DATA_VIDEOS))
    data = dict(train=dict(ann_file=train_ann, data_root=root),
                val=dict(ann_file=os.path.join(root, 'test_list.txt'),
                         data_root=root))
    if device_norm:
        for split in data:
            data[split]['pipeline'] = [
                dict(op, device=True) if op['type'] == 'Normalize'
                else dict(op) for op in flagship.data[split]['pipeline']]
    text = re.sub(r'\binf\b', "float('inf')", '\n'.join([
        f'_base_ = {CONFIG!r}', f'data = dict(**{data!r})',
        f'total_epochs = {TRAIN_EPOCHS}', 'resume_from = None',
        'checkpoint_config = dict(interval=1)',
        'log_config = dict(interval=1)', 'eval_interval = 1', '']))
    path = os.path.join(root, f'train_{int(device_norm)}.py')
    with open(path, 'w') as f:
        f.write(text)
    return path


_LOG_ITER = (r'Epoch \[(\d+)\]\[(\d+)/(\d+)\] lr: (\S+), time: (\S+)s/iter, '
             r'loss_cls: (\S+), loss: (\S+), grad_norm: (\S+)$')


def train_log(work_dir):
    """The iteration lines of ``work_dir/train.log`` as dicts, and the
    evaluation lines as {(epoch, k): accuracy text}."""
    import re
    with open(os.path.join(work_dir, 'train.log')) as f:
        text = f.read()
    iters = [dict(epoch=int(e), iter=int(i), lr=float(lr), s=float(t),
                  loss=float(loss), grad_norm=float(g))
             for e, i, _, lr, t, _, loss, g in re.findall(_LOG_ITER, text,
                                                          re.M)]
    evals = {(int(e), int(k)): a for e, k, a in re.findall(
        r'Eval epoch (\d+): top-(\d) acc: (\S+)$', text, re.M)}
    return iters, evals


def phase_train_cli(root):
    """The train entry point on the rawframe dataset under ``root``: the
    port's train CLI in-process with host and with device normalization,
    a resumed run, one profiled epoch. Returns the fused kernel's launches
    in each case's run, by (dtype, N, H, W, Cin, Cm), and each case's
    epoch-2 losses resumed from ``epoch_1.pth``."""
    import math

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import (DataLoader, ShardedSampler,
                                       build_dataset, device_norm_cfg)
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import train_recognizer as cli
    from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                                   load_torch_state_dict)

    shapes = {name: ('bfloat16',) + shape + (cm,)
              for name, shape, cm, _ in FUSED_SHAPES}
    expected = {shapes[name]: n * DATA_VIDEOS * TRAIN_EPOCHS
                for name, n in VAL_LAUNCHES.items()}
    launches, resumed_losses = {}, {}
    for case, device_norm in (('host_norm', False), ('device_norm', True)):
        config = write_train_config(root, device_norm)
        work = os.path.join(root, f'train_{case}')
        fb.bottleneck_eval_cuda.launches = 0
        fb.bottleneck_eval_cuda.launches_by_shape.clear()
        t0 = time.perf_counter()
        loop = cli.main([config, '--work_dir', work, '--validate'])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches[case] = dict(fb.bottleneck_eval_cuda.launches_by_shape)
        iters, evals = train_log(work)
        losses = [r['loss'] for r in iters]
        n_iter = TRAIN_EPOCHS * loop.iters_per_epoch
        require(loop.iters_per_epoch == DATA_VIDEOS * TRAIN_REPEAT
                // loop.loader.batch_size,
                f'{case}: {loop.iters_per_epoch} iterations an epoch')
        require(len(iters) == n_iter == loop.step,
                f'{case}: {len(iters)} log lines, {loop.step} steps')
        require(all(math.isfinite(v) for r in iters for v in r.values()),
                f'{case}: non-finite train metrics {iters}')
        require(FIRST_LOSS[0] <= losses[0] <= FIRST_LOSS[1],
                f'{case}: first loss {losses[0]} outside {FIRST_LOSS}')
        for name in [f'epoch_{e + 1}.pth' for e in range(TRAIN_EPOCHS)] \
                + ['latest.pth', 'train.log']:
            require(os.path.exists(os.path.join(work, name)),
                    f'{case}: {name} not written')
        require(launches[case] == expected,
                f'{case}: fused kernel launches {launches[case]}, expected '
                f'{expected} (none in the train steps)')
        require(fb.bottleneck_eval_cuda.launches == sum(expected.values()),
                f'{case}: fused kernel launched '
                f'{fb.bottleneck_eval_cuda.launches} times in all')

        # the log's accuracies against numpy on the evaluations' scores
        cfg = Config.fromfile(config)
        val = build_dataset(dict(cfg.data['val']))
        labels = [info['label'] for info in val.video_infos]
        require([e['epoch'] for e in loop.eval_history]
                 == list(range(1, TRAIN_EPOCHS + 1)),
                 f'{case}: evaluations {loop.eval_history}')
        for e in loop.eval_history:
            scores = np.asarray(e['scores'])
            require(scores.shape == (DATA_VIDEOS, 400)
                    and bool(np.isfinite(scores).all()),
                    f'{case}: eval scores {scores.shape}')
            top1, top5, _ = numpy_accuracy(scores, labels)
            require(evals.get((e['epoch'], 1)) == f'{top1:.4f}'
                    and evals.get((e['epoch'], 5)) == f'{top5:.4f}',
                    f'{case}: logged accuracies {evals}, numpy '
                    f'{top1} {top5} at epoch {e["epoch"]}')

        # latest.pth holds the trained model, every key
        model = loop.model
        fresh = build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype))
        report = import_torch_state_dict(
            fresh, load_torch_state_dict(os.path.join(work, 'latest.pth')))
        require(report['missing'] == report['unexpected']
                == report['mismatched'] == [],
                f'{case}: latest.pth import report {report}')
        trained = model.state_dict()
        differ = [k for k, v in fresh.state_dict().items()
                  if not torch.equal(v, trained[k].cpu())
                  and not k.endswith('num_batches_tracked')]
        require(not differ, f'{case}: latest.pth differs at {differ[:5]}')

        # one val video of the trained model against its plain path
        step = make_eval_step(model, norm_cfg=device_norm_cfg(
            cfg.data['val']['pipeline']))
        video = np.asarray(val[0]['img_group'])[None]
        got = compare_with_plain(f'train_cli {case}', step, model, video)
        want = {shapes[name]: n for name, n in VAL_LAUNCHES.items()}
        require(got == want, f'{case}: trained model launches {got}, '
                             f'expected {want}')

        # a run resumed from epoch 1 repeats epoch 2's losses
        resumed = os.path.join(root, f'resumed_{case}')
        again = cli.main([config, '--work_dir', resumed, '--resume_from',
                          os.path.join(work, 'epoch_1.pth')])
        tail, _ = train_log(resumed)
        per_epoch = loop.iters_per_epoch
        rel = [abs(a['loss'] - b['loss']) / abs(b['loss'])
               for a, b in zip(tail, iters[per_epoch:])]
        require(again.step == n_iter and len(tail) == per_epoch
                and [r['epoch'] for r in tail] == [2] * per_epoch,
                f'{case}: resumed run {again.step} steps, log {tail}')
        require(max(rel) <= RESUME_TOL,
                f'{case}: resumed losses differ by {rel} relative')
        resumed_losses[case] = [r['loss'] for r in tail]
        del again

        # one more epoch of the same loop, profiled, without hooks
        loop.hooks = []
        loop.epoch = loop.total_epochs
        loop.total_epochs += 1
        prof = device_profile(loop.run)
        require('busy_ms' in prof, f'{case} train profile: {prof}')

        # the train split's loader alone, and each op on one thread
        train = build_dataset(dict(cfg.data['train']), 'cuda')
        loader = DataLoader(train, cfg.data['videos_per_gpu'],
                            ShardedSampler(len(train), shuffle=False),
                            num_workers=cfg.data['workers_per_gpu'],
                            drop_last=True)
        t1 = time.perf_counter()
        n = sum(len(b['img_group']) for b in loader)
        loader_s = time.perf_counter() - t1
        op_ms = pipeline_op_ms(lambda: [train[i]
                                        for i in range(DATA_VIDEOS)])

        secs = [r['s'] for r in iters[1:]]
        med = statistics.median(secs)
        print('train_cli: ' + json.dumps(dict(
            case=case, iterations=n_iter, batch=[
                loop.loader.batch_size] + list(video.shape[1:]),
            dtype=cfg.compute_dtype, run_s=run_s, s_per_iter=secs,
            median_s_per_iter=med,
            clips_per_s=loop.loader.batch_size / med,
            loss=losses, resumed_loss=[r['loss'] for r in tail],
            resume_loss_rel=rel,
            loader_videos_per_s=n / loader_s,
            loader_workers=cfg.data['workers_per_gpu'],
            host_ms_by_op={k: statistics.median(v)
                           for k, v in op_ms.items()},
            bytes_uploaded_per_iter=loop.stager.bytes_uploaded
            / loop.stager.uploads,
            # 1 for uint8 frames (normalized on the card), 4 for float32
            upload_bytes_per_element=loop.stager.bytes_uploaded
            / loop.stager.uploads / (loop.loader.batch_size
                                     * int(np.prod(video.shape[1:]))),
            upload_chunks=loop.stager.chunks,
            upload_slot_waits=loop.stager.slot_waits,
            epoch_device_busy_ms=prof['busy_ms'],
            epoch_device_idle_share=prof['idle_share'],
            profiled_epoch_ms=prof['wall_ms'],
            # the profiler slows the host: the busy time against as many
            # unprofiled iterations of the median time
            idle_share_of_median_iters=1 - prof['busy_ms'] / (
                loop.iters_per_epoch * med * 1e3),
            fused_launches={f'{k[1]}x{k[2]}x{k[3]}x{k[4]}/{k[5]}': v
                            for k, v in launches[case].items()},
            card=card_line())))
        print(f'train_cli profile {case}: ' + json.dumps(prof))
        del loop, model, fresh, step, train, loader
        torch.cuda.empty_cache()
    return launches, resumed_losses


def _quiet(fn, *args):
    """``fn(*args)`` with its standard output captured; (result, text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def worked_out_macs(shape):
    """The flagship's convolution and FC multiply-adds in a test forward at
    ``shape``, from each layer's shapes: every convolution's output
    elements times its weight's fan-in per output (``in / groups * kH *
    kW``), the output sizes read with forward hooks in train mode (where
    each block calls its convolutions as modules) on the meta device, and
    the FC's frames x in x out. The MVF taps are elementwise in the port."""
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.models import build_recognizer
    cfg = Config.fromfile(CONFIG)
    model = build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype),
                             test_cfg=dict(average_clips=None))
    model.to('meta').train()
    macs = []

    def hook(module, _, out):
        w = module.weight
        macs.append(out.numel() * w.shape[1] * w[0, 0].numel())

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(shape, device='meta'), None, return_loss=False)
    fc = model.cls_head.new_fc
    return sum(macs) + shape[0] * shape[1] * fc.in_features * fc.out_features


def _msgpack_round_trip(root, ann):
    """The seeded model of phase 5 as a ``.msgpack``, scored by the test
    CLI against phase 5's ``.pth`` scores; returns its path."""
    import pickle

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    from mvfnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   save_msgpack_checkpoint)
    pth = os.path.join(root, 'mvf_r50_random.pth')
    path = os.path.join(root, 'mvf_r50_random.msgpack')
    model = cli.build_model(Config.fromfile(CONFIG), True, 'prob')
    model.load_state_dict(torch.load(pth, weights_only=True))
    t0 = time.perf_counter()
    save_msgpack_checkpoint(path, model, meta={'epoch': 0, 'iter': 0})
    save_s = time.perf_counter() - t0
    load_s = {}
    for name, ckpt in (('pth', pth), ('msgpack', path)):
        t0 = time.perf_counter()
        load_checkpoint(ckpt)
        load_s[name] = time.perf_counter() - t0
    out = os.path.join(root, 'scores_msgpack.pkl')
    run_cli(write_config(root, ann, True), path, out)
    scores = {}
    for name, pkl in (('msgpack', out), ('pth', os.path.join(
            root, 'scores_device_norm.pkl'))):
        with open(pkl, 'rb') as f:
            scores[name] = np.stack(pickle.load(f))
    err = float(np.abs(scores['msgpack'] - scores['pth']).max())
    print('checkpoints: ' + json.dumps(dict(
        pth_bytes=os.path.getsize(pth), msgpack_bytes=os.path.getsize(path),
        load_s=load_s, msgpack_save_s=save_s, scores_max_abs_err=err,
        card=card_line())))
    require(err <= DATA_TOL, f'.msgpack vs .pth scores: max abs err {err} '
                             f'> {DATA_TOL}')
    return path


def _resume_from_msgpack(root, want_losses):
    """Phase 6's device-normalization run after epoch 1, written as a
    ``.msgpack`` with its SGD state in optax's layout, resumes the train
    CLI; its epoch-2 losses against the ``.pth`` resume's."""
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset
    from mvfnet_tpu_torch.engine.train_loop import TrainLoop
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.tools import train_recognizer as cli
    from mvfnet_tpu_torch.utils.checkpoint import save_msgpack_checkpoint
    config = os.path.join(root, 'train_1.py')
    cfg = Config.fromfile(config)
    cfg.resume_from = os.path.join(root, 'train_device_norm', 'epoch_1.pth')
    model = build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype),
                             test_cfg=cfg.get('test_cfg'))
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train']), 'cuda'),
                     cfg)
    path = os.path.join(root, 'epoch_1.msgpack')
    save_msgpack_checkpoint(path, loop.model, loop.optimizer,
                            meta={'epoch': loop.epoch, 'iter': loop.step})
    del loop, model
    resumed = os.path.join(root, 'resumed_msgpack')
    again = cli.main([config, '--work_dir', resumed, '--resume_from', path])
    tail, _ = train_log(resumed)
    got = [r['loss'] for r in tail]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want_losses)]
    print('resume_msgpack: ' + json.dumps(dict(
        msgpack_bytes=os.path.getsize(path), loss=got, pth_loss=want_losses,
        rel=rel)))
    require(again.step == TRAIN_EPOCHS * again.iters_per_epoch
            and len(got) == len(want_losses) == again.iters_per_epoch
            and [r['epoch'] for r in tail] == [2] * len(got),
            f'.msgpack resume: {again.step} steps, log {tail}')
    require(max(rel) <= RESUME_TOL,
            f'.msgpack resume: losses differ by {rel} relative')
    del again
    torch.cuda.empty_cache()


def _features(root, ann, ckpt):
    """The feature CLI in-process on the videos; returns the fused
    kernel's launches in its timed pass, by (dtype, N, H, W, Cin, Cm)."""
    import math

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset, device_norm_cfg
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import feature_extractor
    from mvfnet_tpu_torch.tools import test_recognizer as test_cli
    from mvfnet_tpu_torch.utils.checkpoint import load_weights

    config = write_config(root, ann, True)
    out = os.path.join(root, 'features.json')
    args = [config, ckpt, '--fcn_testing', '--out', out]
    _quiet(feature_extractor.main, args)                # warm-up pass
    torch.cuda.synchronize()
    fb.bottleneck_eval_cuda.launches = 0
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    t0 = time.perf_counter()
    _quiet(feature_extractor.main, args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)
    total = fb.bottleneck_eval_cuda.launches
    expected = {('bfloat16',) + shape + (cm,): per_video * DATA_VIDEOS
                for _, shape, cm, per_video in FUSED_SHAPES if per_video}
    require(launches == expected and total == 5 * DATA_VIDEOS,
            f'features: fused kernel launches {launches} ({total} in all), '
            f'expected {expected}')
    with open(out) as f:
        written = json.load(f)
    dim = 2048
    require(list(written) == [f'video_{i}' for i in range(DATA_VIDEOS)]
            and all(len(v) == VIEWS * dim and all(map(math.isfinite, v))
                    for v in written.values()),
            f'features: {len(written)} entries of '
            f'{sorted({len(v) for v in written.values()})} floats')
    prof = device_profile(lambda: _quiet(feature_extractor.main, args))
    require('busy_ms' in prof, f'features profile: {prof}')

    # the FC of each video's rows against the eval step's per-clip logits
    cfg = Config.fromfile(config)
    model = test_cli.build_model(cfg, True, None)
    load_weights(model, ckpt)
    step = make_eval_step(model, norm_cfg=device_norm_cfg(
        cfg.data['test']['pipeline']))
    dataset = build_dataset(dict(cfg.data['test']), 'cuda')
    err, tol = 0.0, math.inf
    for i, rows in enumerate(written.values()):
        logits = step(model, dataset[i]['img_group'][None]).float()
        feats = torch.tensor(rows, device=logits.device).reshape(VIEWS, dim)
        with torch.inference_mode():
            fc = model.cls_head.fc(feats)
        err = max(err, (fc - logits).abs().max().item())
        tol = min(tol, 3e-2 * logits.abs().max().item())
    print('features: ' + json.dumps(dict(
        videos=DATA_VIDEOS, rows_per_video=VIEWS, dim=dim, pass_s=secs,
        videos_per_s=DATA_VIDEOS / secs, json_bytes=os.path.getsize(out),
        device_busy_ms=prof['busy_ms'], device_idle_share=prof['idle_share'],
        profiled_pass_ms=prof['wall_ms'], fused_launches=total,
        fc_vs_logits_max_abs_err=err, tol=tol, card=card_line())))
    print('features profile: ' + json.dumps(prof))
    require(err <= tol, f'features: FC of the features vs the per-clip '
                        f'logits {err} > {tol}')
    del model, step
    torch.cuda.empty_cache()
    return launches


def _host_tools(root, ann):
    """``count_flops`` on the flagship, ``report_accuracy`` on phase 5's
    two score pickles."""
    import pickle
    import re

    import numpy as np
    from mvfnet_tpu_torch.tools import count_flops, report_accuracy
    stats, text = _quiet(count_flops.main, [CONFIG])
    macs = worked_out_macs(stats['shape'])
    print('count_flops: ' + json.dumps(dict(
        shape=stats['shape'], params=stats['params'], macs=stats['macs'],
        worked_out_macs=macs, gmacs=stats['gmacs'])))
    require(stats['params'] == 24342416 and stats['macs'] == macs,
            f'count_flops: {stats}, worked out {macs} MACs')
    pkls = [os.path.join(root, f'scores_{case}.pkl')
            for case in ('host_norm', 'device_norm')]
    arrays = []
    for pkl in pkls:
        with open(pkl, 'rb') as f:
            arrays.append(np.stack(pickle.load(f)))
    labels = list(range(DATA_VIDEOS))
    for softmax in (False, True):
        args = ['--scores', *pkls, '--coefficients', '1', '1',
                '--datalist', ann] + (['--apply_softmax'] if softmax else [])
        _, text = _quiet(report_accuracy.main, args)
        printed = dict(re.findall(r'^(Top-1|Top-5|Mean Class) Accuracy '
                                  r'= (\d+\.\d\d)$', text, re.M))
        fused = 0
        for a in arrays:
            if softmax:
                e = np.exp(a - a.max(1, keepdims=True))
                a = e / e.sum(1, keepdims=True)
            fused = fused + a
        want = numpy_accuracy(fused, labels)
        require(printed == {k: f'{v * 100:.02f}' for k, v in zip(
            ('Top-1', 'Top-5', 'Mean Class'), want)},
            f'report_accuracy softmax={softmax}: printed {printed}, '
            f'numpy {want}')
        print(f'report_accuracy softmax={softmax}: {printed}')


def phase_entry_points(root, ann, resumed_losses):
    """Phase 7 on the dataset and checkpoints of phases 5 and 6; returns
    the fused kernel's launches in the feature CLI's timed pass."""
    ckpt = _msgpack_round_trip(root, ann)
    _resume_from_msgpack(root, resumed_losses['device_norm'])
    launches = _features(root, ann, ckpt)
    _host_tools(root, ann)
    return launches


def run_bounded(cmd, timeout, env=None):
    """``cmd`` in a session of its own, killed with everything it started
    after ``timeout`` seconds; (return code, stdout, stderr)."""
    import signal
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise SmokeFailure(f'{cmd[:6]}...: no end within {timeout} s')
    return proc.returncode, out, err


def _dist_steps(job):
    """``job['steps']`` train steps of the flagship (``job['config']``) from
    seed 0 on this rank's share of each global batch of ``job['clips']``
    uint8 videos: its losses, grad norms and step times (the first builds
    cuDNN's plans)."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer,
                                               frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.parallel import world_rank
    world, rank = world_rank()
    cfg = Config.fromfile(job['config'])
    model = build_recognizer({**cfg.model, 'dtype': cfg.compute_dtype},
                             train_cfg=cfg.train_cfg, test_cfg=cfg.test_cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH, cfg.total_epochs)
    opt = build_optimizer(
        model.to(job['device']), cfg.optimizer, schedule,
        grad_clip=cfg.optimizer_config['grad_clip'],
        frozen_prefixes=frozen_prefixes_from_backbone(cfg.model['backbone']))
    step = make_train_step(model, opt, schedule,
                           norm_cfg=dict(cfg.img_norm_cfg, device=True),
                           device=job['device'], seed=0)
    n = job['clips']
    mine = slice(rank * n // world, (rank + 1) * n // world)
    classes = cfg.model['cls_head']['num_classes']
    out = dict(loss=[], grad_norm=[], step_s=[])
    for t in range(job['steps']):
        rs = np.random.RandomState(2000 + t)
        imgs = rs.randint(0, 256, (n,) + tuple(job['shape']), dtype=np.uint8)
        labels = rs.randint(0, classes, n)
        t0 = time.perf_counter()
        m = step(imgs[mine], labels[mine])
        out['loss'].append(m['loss'].item())         # waits for the step
        out['step_s'].append(time.perf_counter() - t0)
        out['grad_norm'].append(m['grad_norm'].item())
    return out


def run_rank(jobs, report, backend=None, device=None):
    """Phase 8's work in one rank: each job of ``jobs`` in turn, a CLI's
    ``main`` (``{'cli': name, 'args': [...]}``) or ``_dist_steps``
    (``{'steps': ...}``), with the fused kernel's launches counted from 0
    for each; the records go to ``report.RANK.json``. With ``backend``
    this rank joins the group first (``init_distributed('env')`` on
    ``device``), and the CLIs find it joined; without, each CLI joins and
    leaves it. Each join's backend and world size are recorded."""
    import importlib
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.parallel import init_distributed
    joins, join = [], dist.init_process_group

    def recorded_join(backend=None, *args, **kwargs):
        joins.append([backend, kwargs.get('world_size')])
        return join(backend, *args, **kwargs)

    dist.init_process_group = recorded_join
    if backend:
        init_distributed('env', backend=backend, device=device,
                         timeout=timedelta(seconds=DIST_TIMEOUT))
    rank = int(os.environ['RANK'])
    records = []
    for job in jobs:
        fb.bottleneck_eval_cuda.launches = 0
        fb.bottleneck_eval_cuda.launches_by_shape.clear()
        t0 = time.perf_counter()
        if 'cli' in job:
            module = importlib.import_module(
                f'mvfnet_tpu_torch.tools.{job["cli"]}')
            module.main(job['args'])
            res = {}
        else:
            res = _dist_steps(job)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        records.append(dict(
            res, name=job['name'], wall_s=time.perf_counter() - t0,
            launches=fb.bottleneck_eval_cuda.launches,
            launches_by_shape=[[list(k), v] for k, v in
                               fb.bottleneck_eval_cuda.launches_by_shape
                               .items()]))
    if dist.is_initialized():
        dist.destroy_process_group()
    with open(f'{report}.{rank}.json', 'w') as f:
        json.dump(dict(rank=rank, joins=joins, records=records), f)


def rank_cli(argv):
    """``chip_smoke.py --rank REPORT JOBS``, one rank under torchrun: the
    jobs (JSON) of ``run_rank``, the group joined by the CLIs."""
    sys.path.insert(0, ROOT)
    run_rank(json.loads(argv[1]), argv[0])
    return 0


def read_ranks(report, world):
    """The ranks' records of ``run_rank``, by job name: [rank 0's, ...]."""
    ranks = []
    for r in range(world):
        with open(f'{report}.{r}.json') as f:
            ranks.append(json.load(f))
    return ranks, {rec['name']: [rk['records'][i] for rk in ranks]
                   for i, rec in enumerate(ranks[0]['records'])}


def _shape_counts(rec):
    return {tuple(k): v for k, v in rec['launches_by_shape']}


def _pickle_err(path, want):
    import pickle

    import numpy as np
    with open(path, 'rb') as f:
        got = np.stack(pickle.load(f))
    return float(np.abs(got - want).max()) if got.shape == want.shape \
        else float('inf')


def phase_dist(root, ann):
    """Phase 8: the engine's processes on the card, with phase 5's videos
    and ``.pth`` and phase 6's train config (b). Returns the fused kernel's
    launches per rank, by case and (dtype, N, H, W, Cin, Cm)."""
    import pickle

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.parallel import free_port, spawn_local
    from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                                   load_torch_state_dict)

    t_phase = time.perf_counter()
    ckpt = os.path.join(root, 'mvf_r50_random.pth')
    test_cfg, train_cfg = (os.path.join(root, 'test_1.py'),
                           os.path.join(root, 'train_1.py'))
    with open(os.path.join(root, 'scores_device_norm.pkl'), 'rb') as f:
        want_scores = np.stack(pickle.load(f))
    test_args = [test_cfg, ckpt, '--fcn_testing', '--videos_per_gpu', '1']
    shapes = {name: ('bfloat16',) + shape + (cm,)
              for name, shape, cm, _ in FUSED_SHAPES}
    per_video = {shapes[name]: n for name, _, _, n in FUSED_SHAPES if n}
    per_val = {shapes[name]: n for name, n in VAL_LAUNCHES.items()}
    launches = {}

    # (a) NCCL at world 1 through torchrun and --launcher env
    env = dict(os.environ, PYTHONPATH=ROOT)
    runs = {}
    for name, job in (
            ('nccl_test', dict(cli='test_recognizer', args=test_args + [
                '--launcher', 'env', '--device', DIST_DEVICE, '--out',
                os.path.join(root, 'scores_nccl.pkl')])),
            ('nccl_train_cli', dict(cli='train_recognizer', args=[
                train_cfg, '--work_dir', os.path.join(root, 'train_nccl'),
                '--validate', '--launcher', 'env', '--device',
                DIST_DEVICE]))):
        report = os.path.join(root, name)
        t0 = time.perf_counter()
        rc, out, err = run_bounded(
            [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
             '--nproc_per_node', '1', '--master_addr', '127.0.0.1',
             '--master_port', str(free_port()), os.path.abspath(__file__),
             '--rank', report, json.dumps([dict(job, name=name)])],
            DIST_TIMEOUT, env)
        require(rc == 0, f'{name}: torchrun exited {rc}:\n{err[-3000:]}')
        ranks, recs = read_ranks(report, 1)
        runs[name] = (time.perf_counter() - t0, ranks[0], recs[name][0])
        launches[name] = [_shape_counts(recs[name][0])]

    secs, rank0, rec = runs['nccl_test']
    err = _pickle_err(os.path.join(root, 'scores_nccl.pkl'), want_scores)
    want = {k: n * DATA_VIDEOS for k, n in per_video.items()}
    print('dist: ' + json.dumps(dict(
        case='nccl_test', joins=rank0['joins'],
        devices=[DIST_DEVICE], wall_s=secs, cli_s=rec['wall_s'],
        launches=[rec['launches']], vs_phase5_max_abs_err=err,
        tol=DATA_TOL)))
    require(rank0['joins'] == [['nccl', 1]],
            f'nccl_test: joined {rank0["joins"]}')
    require(err <= DATA_TOL, f'nccl_test: scores vs phase 5: {err}')
    require(launches['nccl_test'] == [want],
            f'nccl_test: launches {launches["nccl_test"]}, expected {want}')

    secs, rank0, rec = runs['nccl_train_cli']
    got, _ = train_log(os.path.join(root, 'train_nccl'))
    ref, _ = train_log(os.path.join(root, 'train_device_norm'))
    rel = [abs(a['loss'] - b['loss']) / abs(b['loss'])
           for a, b in zip(got, ref)]
    want = {k: n * DATA_VIDEOS * TRAIN_EPOCHS for k, n in per_val.items()}
    print('dist: ' + json.dumps(dict(
        case='nccl_train_cli', joins=rank0['joins'],
        devices=[DIST_DEVICE], wall_s=secs,
        cli_s=rec['wall_s'],
        median_s_per_iter=statistics.median(r['s'] for r in got[1:]),
        phase6_median_s_per_iter=statistics.median(r['s'] for r in ref[1:]),
        loss=[r['loss'] for r in got], phase6_loss=[r['loss'] for r in ref],
        loss_rel=rel, tol=RESUME_TOL, launches=[rec['launches']])))
    require(rank0['joins'] == [['nccl', 1]] and len(got) == len(ref) > 0
            and max(rel) <= RESUME_TOL,
            f'nccl_train_cli: joined {rank0["joins"]}, losses {rel} '
            'relative')
    require(launches['nccl_train_cli'] == [want],
            f'nccl_train_cli: launches {launches["nccl_train_cli"]}, '
            f'expected {want}')

    # (b) gloo at world 2, both ranks on one card: NCCL refuses two ranks
    # on one device
    one = os.path.join(root, 'train_1epoch.py')
    with open(one, 'w') as f:
        f.write(f'_base_ = {train_cfg!r}\ntotal_epochs = 1\n')
    work = os.path.join(root, 'train_gloo')
    step_job = dict(steps=DIST_STEPS, clips=2 * DIST_CLIPS, config=CONFIG,
                    shape=list(TRAIN_BATCH[1:]), device=DIST_SHARED_DEVICE)
    jobs = [dict(name='gloo_test', cli='test_recognizer', args=test_args + [
                '--launcher', 'env', '--device', DIST_SHARED_DEVICE, '--out',
                os.path.join(root, 'scores_gloo.pkl')]),
            dict(step_job, name='gloo_steps'),
            dict(name='gloo_train_cli', cli='train_recognizer', args=[
                one, '--work_dir', work, '--validate', '--launcher', 'env',
                '--device', DIST_SHARED_DEVICE])]
    world1 = _dist_steps(dict(step_job, device=DIST_SHARED_DEVICE))
    torch.cuda.empty_cache()
    report = os.path.join(root, 'gloo')
    t0 = time.perf_counter()
    spawn_local(run_rank, 2, (jobs, report, 'gloo', DIST_SHARED_DEVICE),
                timeout=DIST_TIMEOUT)
    secs = time.perf_counter() - t0
    ranks, recs = read_ranks(report, 2)
    require([r['joins'] for r in ranks] == [[['gloo', 2]]] * 2,
            f'gloo: joined {[r["joins"] for r in ranks]}')
    for name in ('gloo_test', 'gloo_train_cli'):
        launches[name] = [_shape_counts(r) for r in recs[name]]

    err = _pickle_err(os.path.join(root, 'scores_gloo.pkl'), want_scores)
    want = {k: n * DATA_VIDEOS // 2 for k, n in per_video.items()}
    print('dist: ' + json.dumps(dict(
        case='gloo_test', backend='gloo', world=2,
        devices=[DIST_SHARED_DEVICE] * 2, wall_s=secs,
        cli_s=[r['wall_s'] for r in recs['gloo_test']],
        launches=[r['launches'] for r in recs['gloo_test']],
        vs_phase5_max_abs_err=err, tol=DATA_TOL)))
    require(err <= DATA_TOL, f'gloo_test: scores vs phase 5: {err}')
    require(launches['gloo_test'] == [want, want],
            f'gloo_test: launches {launches["gloo_test"]}, expected {want} '
            'a rank')

    got = recs['gloo_steps']
    rel = {k: [abs(a - b) / abs(b) for r in got
               for a, b in zip(r[k], world1[k])]
           for k in ('loss', 'grad_norm')}
    print('dist: ' + json.dumps(dict(
        case='gloo_steps', backend='gloo', world=2,
        devices=[DIST_SHARED_DEVICE] * 2, clips_per_rank=DIST_CLIPS,
        shape=list(TRAIN_BATCH[1:]), job_s=[r['wall_s'] for r in got],
        step_s=[r['step_s'] for r in got], world1_step_s=world1['step_s'],
        loss=got[0]['loss'], world1_loss=world1['loss'],
        grad_norm=got[0]['grad_norm'], world1_grad_norm=world1['grad_norm'],
        max_loss_rel=max(rel['loss']),
        max_grad_norm_rel=max(rel['grad_norm']), tol=[2e-2, 5e-2])))
    require(max(rel['loss']) <= 2e-2 and max(rel['grad_norm']) <= 5e-2,
            f'gloo_steps against world 1: relative {rel}')

    want = {k: n * DATA_VIDEOS // 2 for k, n in per_val.items()}
    written = sorted(os.listdir(work))
    model = build_recognizer(dict(Config.fromfile(one).model))
    imported = import_torch_state_dict(model, load_torch_state_dict(
        os.path.join(work, 'latest.pth')))
    iters, _ = train_log(work)
    print('dist: ' + json.dumps(dict(
        case='gloo_train_cli', backend='gloo', world=2,
        devices=[DIST_SHARED_DEVICE] * 2,
        cli_s=[r['wall_s'] for r in recs['gloo_train_cli']],
        s_per_iter=[r['s'] for r in iters], loss=[r['loss'] for r in iters],
        written=written,
        launches=[r['launches'] for r in recs['gloo_train_cli']],
        phase_s=time.perf_counter() - t_phase, card=card_line())))
    require(written == ['epoch_1.pth', 'latest.pth', 'train.log'],
            f'gloo_train_cli wrote {written}')
    require(len(iters) == DATA_VIDEOS * TRAIN_REPEAT // (2 * 12)
            and all(np.isfinite([r['loss'] for r in iters])),
            f'gloo_train_cli: log {iters}')
    require(imported['missing'] == imported['unexpected']
            == imported['mismatched'] == [],
            f'gloo_train_cli: latest.pth import report {imported}')
    require(launches['gloo_train_cli'] == [want, want],
            f'gloo_train_cli: launches {launches["gloo_train_cli"]}, '
            f'expected {want} a rank')
    return launches


def video_census():
    """The host's video stack: cv2's video backends and whether its build
    has FFmpeg, whether PyAV and decord are installed (looked up, never
    imported: the port decodes with cv2), and libavcodec's headers and
    libraries (for a native decode worker)."""
    import ctypes.util
    import importlib.util
    import cv2
    out = {}
    try:
        reg = cv2.videoio_registry
        out['cv2_backends'] = [reg.getBackendName(b)
                               for b in reg.getBackends()]
        out['cv2_stream_backends'] = [reg.getBackendName(b)
                                      for b in reg.getStreamBackends()]
    except AttributeError:
        out['cv2_backends'] = None
    info = cv2.getBuildInformation()
    out['cv2_ffmpeg'] = [line.strip() for line in info.splitlines()
                         if line.strip().startswith('FFMPEG')]
    for mod in ('av', 'decord'):
        out[mod] = importlib.util.find_spec(mod) is not None
    out['avcodec.h'] = [p for p in (
        '/usr/include/libavcodec/avcodec.h',
        '/usr/include/x86_64-linux-gnu/libavcodec/avcodec.h',
        '/usr/local/include/libavcodec/avcodec.h') if os.path.exists(p)]
    out['libavcodec'] = ctypes.util.find_library('avcodec')
    out['libavformat'] = ctypes.util.find_library('avformat')
    return out


def _synthetic_mp4(path, seed):
    """The synthetic frames as an mp4v file at VIDEO_FPS; its size, and the
    frames cv2 reads back and probes."""
    import cv2
    from mvfnet_tpu_torch.data.video_io import probe_num_frames
    h, w = DATA_HW
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'),
                             VIDEO_FPS, (w, h))
    require(writer.isOpened(), f'cv2.VideoWriter cannot write mp4v to '
                               f'{path}: {video_census()}')
    for img in _synthetic_frames(seed):
        writer.write(img)
    writer.release()
    cap = cv2.VideoCapture(path)
    read = 0
    while cap.read()[0]:
        read += 1
    cap.release()
    return os.path.getsize(path), read, probe_num_frames(path)


def write_videos(root):
    """DATA_VIDEOS mp4v files under ``root/videos`` and a test and a train
    list (each video TRAIN_REPEAT times); cv2 must read back every frame
    and probe DATA_FRAMES. Returns the test list and the mean file size."""
    from concurrent.futures import ThreadPoolExecutor
    vdir = os.path.join(root, 'videos')
    os.makedirs(vdir)
    with ThreadPoolExecutor(min(DATA_VIDEOS, os.cpu_count() or 1)) as pool:
        made = list(pool.map(
            lambda i: _synthetic_mp4(os.path.join(vdir, f'video_{i}.mp4'), i),
            range(DATA_VIDEOS)))
    for i, (_, read, probed) in enumerate(made):
        require(read == probed == DATA_FRAMES,
                f'video_{i}.mp4: cv2 read {read} frames and probed '
                f'{probed}, {DATA_FRAMES} written')
    ann = os.path.join(vdir, 'test_list.txt')
    with open(ann, 'w') as f:
        f.writelines(f'video_{i}.mp4 {i}\n' for i in range(DATA_VIDEOS))
    with open(os.path.join(vdir, 'train_list.txt'), 'w') as f:
        f.writelines(f'video_{i}.mp4 {i}\n'
                     for _ in range(TRAIN_REPEAT) for i in range(DATA_VIDEOS))
    return ann, statistics.mean(m[0] for m in made)


def write_video_config(root, name, extra):
    """A config that inherits the 4x16 video recipe unchanged but for its
    splits' annotation files and data roots, and ``extra`` lines."""
    import re
    vdir = os.path.join(root, 'videos')
    data = {split: dict(ann_file=os.path.join(vdir, f'{ann}_list.txt'),
                        data_root=vdir)
            for split, ann in (('train', 'train'), ('val', 'test'),
                               ('test', 'test'))}
    text = re.sub(r'\binf\b', "float('inf')", '\n'.join(
        [f'_base_ = {VIDEO_CONFIG!r}', f'data = dict(**{data!r})']
        + extra + ['']))
    path = os.path.join(root, f'{name}.py')
    with open(path, 'w') as f:
        f.write(text)
    return path


def _video_test_cli(root, ann):
    """(c) the test CLI on the videos with the recipe's model and test
    pipeline; returns the fused launches of the timed pass."""
    import pickle
    import re

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import (build_dataset, dataset_decoder,
                                       device_norm_cfg, video_io)
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import test_recognizer as cli

    config = write_video_config(root, 'video_test', [])
    cfg = Config.fromfile(config)
    clip_len = cfg.model['module_cfg']['n_segment']
    views = [op for op in cfg.data['test']['pipeline']
             if op['type'] == 'SampleFrames'][0]['num_clips'] * 3
    require(clip_len == 4 and views == 30, f'4x16 recipe: T={clip_len}, '
                                           f'{views} views')
    shapes = {('bfloat16', views * clip_len) + shape[1:] + (cm,): n
              for _, shape, cm, n in FUSED_SHAPES if n}
    expected = {k: n * DATA_VIDEOS for k, n in shapes.items()}
    ckpt = os.path.join(root, 'mvf_r50_random.pth')
    out = os.path.join(root, 'scores_video.pkl')
    run_cli(config, ckpt, out)                             # warm-up pass
    torch.cuda.synchronize()
    fb.bottleneck_eval_cuda.launches = 0
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    t0 = time.perf_counter()
    text = run_cli(config, ckpt, out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)
    with open(out, 'rb') as f:
        rows = pickle.load(f)
    require(len(rows) == DATA_VIDEOS and all(r.shape == (400,)
                                             for r in rows),
            f'video test CLI: scores {[r.shape for r in rows]}')
    got = np.stack(rows)
    require(bool(np.isfinite(got).all()), 'video test CLI: non-finite')
    require(bool((np.abs(got.sum(1) - 1) <= 1e-3).all()),
            f'video test CLI: class probabilities sum to {got.sum(1)}')
    require(launches == expected,
            f'video test CLI: fused launches {launches}, expected '
            f'{expected}')
    printed = dict(re.findall(r'^(Top-1|Top-5|Mean Class) Accuracy '
                              r'= (\d+\.\d\d)$', text, re.M))
    want = numpy_accuracy(got, list(range(DATA_VIDEOS)))
    require(printed == {k: f'{v * 100:.02f}' for k, v in zip(
        ('Top-1', 'Top-5', 'Mean Class'), want)},
        f'video test CLI: printed {printed}, numpy {want}')

    # one video through the kernel and through the plain path, on the
    # frames the pipeline decoded
    dataset = build_dataset(dict(cfg.data['test']))
    decoder = dataset_decoder(dataset)
    require(decoder == video_io.DECODERS[False],
            f'video test CLI decoded with {decoder}')
    model = cli.build_model(cfg, True, 'prob')
    cli.load_checkpoint(model, ckpt)
    model.to('cuda')
    step = make_eval_step(model, norm_cfg=device_norm_cfg(
        cfg.data['test']['pipeline']))
    video = np.asarray(dataset[0]['img_group'])[None]
    one = compare_with_plain('video', step, model, video)
    require(one == shapes, f'video: one video launched {one}, expected '
                           f'{shapes}')

    # seek against sequential decode of the pipeline's indices, and the
    # decode time per frame
    sampler = dataset.pipeline.transforms[0]
    diff, seek_ms, acc_ms, n_frames = 0, 0.0, 0.0, 0
    for info in dataset.video_infos:
        inds = sampler.get_frame_inds(DATA_FRAMES, True,
                                      np.random.default_rng(0))
        t1 = time.perf_counter()
        seek = video_io.decode_frames_seek(info['filename'], inds)
        t2 = time.perf_counter()
        acc = video_io.decode_frames_accurate(info['filename'], inds)
        t3 = time.perf_counter()
        seek_ms += (t2 - t1) * 1e3
        acc_ms += (t3 - t2) * 1e3
        n_frames += len(inds)
        diff = max(diff, max(int(np.abs(a.astype(np.int16) - b).max())
                             for a, b in zip(seek, acc)))
    print(f'video decode: seek vs sequential max abs diff {diff} over '
          f'{n_frames} frames')
    require(diff <= VIDEO_DECODE_DIFF,
            f'seek and sequential decode differ by {diff} > '
            f'{VIDEO_DECODE_DIFF}')
    prof = device_profile(lambda: run_cli(config, ckpt, out))
    require('busy_ms' in prof, f'video profile: {prof}')
    print('video_data: ' + json.dumps(dict(
        case='test_cli', decoder=decoder, videos=DATA_VIDEOS,
        frames_per_video=views * clip_len, pass_s=secs,
        videos_per_s=DATA_VIDEOS / secs,
        clips_per_s=DATA_VIDEOS * views / secs,
        seek_decode_ms_per_frame=seek_ms / n_frames,
        sequential_decode_ms_per_frame=acc_ms / n_frames,
        seek_vs_sequential_max_abs_diff=diff,
        device_busy_ms=prof['busy_ms'], device_idle_share=prof['idle_share'],
        profiled_pass_ms=prof['wall_ms'],
        fused_launches=sum(launches.values()), card=card_line())))
    print('video profile: ' + json.dumps(prof))
    del model, step
    torch.cuda.empty_cache()
    return launches


def _video_train_cli(root):
    """(d) one epoch of the train CLI on the videos with the recipe's
    train and val pipelines; returns the fused launches."""
    import math

    import torch
    from mvfnet_tpu_torch.data import (DataLoader, ShardedSampler,
                                       build_dataset)
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import train_recognizer as cli
    config = write_video_config(root, 'video_train', [
        'total_epochs = 1', 'resume_from = None',
        'checkpoint_config = dict(interval=1)',
        'log_config = dict(interval=1)', 'eval_interval = 1'])
    work = os.path.join(root, 'train_video')
    fb.bottleneck_eval_cuda.launches = 0
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    t0 = time.perf_counter()
    loop = cli.main([config, '--work_dir', work, '--validate'])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)
    iters, _ = train_log(work)
    losses = [r['loss'] for r in iters]
    clip_len = loop.cfg.model['module_cfg']['n_segment']
    expected = {('bfloat16', clip_len) + shape[1:] + (cm,):
                VAL_LAUNCHES[name] * DATA_VIDEOS
                for name, shape, cm, _ in FUSED_SHAPES
                if name in VAL_LAUNCHES}
    require(loop.iters_per_epoch == 4 == len(iters) == loop.step,
            f'video train CLI: {loop.iters_per_epoch} iterations an epoch, '
            f'{len(iters)} logged, {loop.step} steps')
    require(all(math.isfinite(v) for r in iters for v in r.values()),
            f'video train CLI: non-finite train metrics {iters}')
    require(FIRST_LOSS[0] <= losses[0] <= FIRST_LOSS[1],
            f'video train CLI: first loss {losses[0]} outside {FIRST_LOSS}')
    for name in ('epoch_1.pth', 'latest.pth', 'train.log'):
        require(os.path.exists(os.path.join(work, name)),
                f'video train CLI: {name} not written')
    require(launches == expected,
            f'video train CLI: fused launches {launches}, expected '
            f'{expected} (none in the train steps)')
    require(len(loop.eval_history) == 1 and loop.eval_history[0][
        'scores'].shape == (DATA_VIDEOS, 400), 'video train CLI: evaluation')
    train = build_dataset(dict(loop.cfg.data['train']))
    clip = list(train[0]['img_group'].shape)
    loader = DataLoader(train, loop.loader.batch_size,
                        ShardedSampler(len(train), shuffle=False),
                        num_workers=loop.cfg.data['workers_per_gpu'],
                        drop_last=True)
    t1 = time.perf_counter()
    n = sum(len(b['img_group']) for b in loader)
    loader_s = time.perf_counter() - t1
    secs = [r['s'] for r in iters[1:]]
    med = statistics.median(secs)
    print('video_data: ' + json.dumps(dict(
        case='train_cli', batch=[loop.loader.batch_size] + clip,
        iterations=len(iters), run_s=run_s, s_per_iter=[r['s'] for r in
                                                       iters],
        median_s_per_iter=med, clips_per_s=loop.loader.batch_size / med,
        loss=losses, loader_videos_per_s=n / loader_s,
        loader_workers=loop.cfg.data['workers_per_gpu'],
        fused_launches=sum(launches.values()), card=card_line())))
    del loop, train, loader
    torch.cuda.empty_cache()
    return launches


def _flagship_state():
    """The flagship recognizer (seed 0), its recipe's schedule and a step
    builder, on the card."""
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer,
                                               frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    from mvfnet_tpu_torch.models import build_recognizer
    cfg = Config.fromfile(CONFIG)

    def model_for(backbone=None, in_channels=None, mvf=True, dtype=None):
        mcfg = dict(cfg.model, dtype=dtype or cfg.compute_dtype)
        if backbone is not None:
            mcfg['backbone'] = dict(cfg.model['backbone'], **backbone)
        if in_channels is not None:
            mcfg['cls_head'] = dict(cfg.model['cls_head'],
                                    in_channels=in_channels)
        if not mvf:
            mcfg.pop('module_cfg')
        model = build_recognizer(mcfg, train_cfg=cfg.train_cfg,
                                 test_cfg=dict(average_clips=None))
        model.init_weights(torch.Generator().manual_seed(0),
                           randomize_bn=True)
        return model

    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH, cfg.total_epochs)

    def step_for(model, remat=False):
        opt = build_optimizer(
            model, cfg.optimizer, schedule,
            grad_clip=cfg.optimizer_config['grad_clip'],
            frozen_prefixes=frozen_prefixes_from_backbone(
                cfg.model['backbone']))
        return make_train_step(model, opt, schedule,
                               norm_cfg=dict(cfg.img_norm_cfg, device=True),
                               remat=remat)
    return cfg, model_for, step_for


def _with_cp():
    """(e) the flagship train step from one state with and without
    ``with_cp``: the same loss, gradient norm and BatchNorm statistics,
    less peak memory."""
    import copy

    import numpy as np
    import torch
    from mvfnet_tpu_torch.models.common import BatchNorm
    cfg, model_for, step_for = _flagship_state()
    base = model_for()
    rs = np.random.RandomState(0)
    batch = (rs.randint(0, 256, TRAIN_BATCH, dtype=np.uint8),
             rs.randint(0, 400, TRAIN_BATCH[0]))
    runs = {}
    for remat in (False, True):
        model = copy.deepcopy(base).to('cuda')
        step = step_for(model, remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m = step(*batch, torch.Generator(device='cuda').manual_seed(1))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        stats = torch.cat([b.detach().float().reshape(-1).cpu()
                           for mod in model.modules()
                           if isinstance(mod, BatchNorm)
                           for b in (mod.running_mean, mod.running_var)])
        counts = {int(mod.num_batches_tracked) for mod in model.modules()
                  if isinstance(mod, BatchNorm)}
        secs = []
        for i in range(3):
            t0 = time.perf_counter()
            step(*batch, torch.Generator(device='cuda').manual_seed(2 + i))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        runs[remat] = dict(loss=m['loss'].item(),
                           grad_norm=m['grad_norm'].item(), peak=peak,
                           stats=stats, counts=counts,
                           step_ms=statistics.median(secs) * 1e3)
        del model, step, m
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    loss_rel = abs(on['loss'] - off['loss']) / abs(off['loss'])
    norm_rel = abs(on['grad_norm'] - off['grad_norm']) / abs(off['grad_norm'])
    stats_rel = float((on['stats'] - off['stats']).abs().max()
                      / off['stats'].abs().max())
    print('with_cp: ' + json.dumps(dict(
        batch=list(TRAIN_BATCH), dtype=cfg.compute_dtype,
        loss=[off['loss'], on['loss']],
        grad_norm=[off['grad_norm'], on['grad_norm']],
        loss_rel=loss_rel, grad_norm_rel=norm_rel, bn_stats_rel=stats_rel,
        num_batches_tracked=[sorted(off['counts']), sorted(on['counts'])],
        step_ms=[off['step_ms'], on['step_ms']],
        max_memory_allocated_gib=[off['peak'] / 2 ** 30,
                                  on['peak'] / 2 ** 30],
        tol=RESUME_TOL, card=card_line())))
    require(max(loss_rel, norm_rel, stats_rel) <= RESUME_TOL,
            f'with_cp against without: loss {loss_rel}, grad norm '
            f'{norm_rel}, BN statistics {stats_rel} relative')
    require(on['counts'] == off['counts'] == {1},
            f'with_cp: BatchNorm counted {on["counts"]} batches, without '
            f'{off["counts"]}')
    require(on['peak'] < off['peak'],
            f'with_cp: peak memory {on["peak"]} not below {off["peak"]}')


# (f) the ResNet's options on the flagship's model: (name, backbone
# options, head input channels, MVF in stages 3-4, fused launches of one
# eval video by shape name)
OPTIONS = [
    ('r18_mvf', dict(depth=18), 512, True, {}),
    ('r34', dict(depth=34), 512, False, {}),
    ('r50_avg_down_avd_deep_stem', dict(avg_down=True, avd=True,
                                        deep_stem=True), 2048, True,
     VAL_LAUNCHES),
    ('r50_gn', dict(norm_cfg=dict(type='GN', num_groups=32)), 2048, True,
     {}),
]


def _layer_options():
    """(f) each option: a bf16 eval forward on the card against the same
    weights' fp32 forward on the CPU, and one finite bf16 train step;
    returns the fused launches of the eval forwards."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.ops import fused_block as fb
    cfg, model_for, step_for = _flagship_state()
    frames = TRAIN_BATCH[1]
    rs = np.random.RandomState(3)
    video = rs.randint(0, 256, (1, frames) + TRAIN_BATCH[2:], dtype=np.uint8)
    batch = (rs.randint(0, 256, (2,) + TRAIN_BATCH[1:], dtype=np.uint8),
             rs.randint(0, 400, 2))
    norm = dict(cfg.img_norm_cfg, device=True)
    shapes = {name: ('bfloat16',) + shape + (cm,)
              for name, shape, cm, _ in FUSED_SHAPES}
    launches, lines = {}, []
    for name, backbone, channels, mvf, per_video in OPTIONS:
        model = model_for(backbone, channels, mvf)
        cpu = model_for(backbone, channels, mvf, dtype='float32')
        cpu.load_state_dict(model.state_dict())
        want = make_eval_step(cpu, norm_cfg=norm, device='cpu')(cpu, video)
        fb.bottleneck_eval_cuda.launches_by_shape.clear()
        got = make_eval_step(model, norm_cfg=norm)(model, video).float().cpu()
        launches[name] = dict(fb.bottleneck_eval_cuda.launches_by_shape)
        err = float((got - want).abs().max())
        tol = 3e-2 * float(want.abs().max())
        step = step_for(model)
        m = step(*batch, torch.Generator(device='cuda').manual_seed(0))
        loss, grad_norm = m['loss'].item(), m['grad_norm'].item()
        lines.append(dict(name=name, backbone=backbone, mvf=mvf,
                          max_abs_err=err, tol=tol, argmax_agree=bool(
                              (got.argmax(-1) == want.argmax(-1)).all()),
                          loss=loss, grad_norm=grad_norm,
                          fused_launches=sum(launches[name].values())))
        require(bool(torch.isfinite(got).all()) and err <= tol,
                f'{name}: bf16 card vs fp32 CPU logits {err} > {tol}')
        require(np.isfinite(loss) and np.isfinite(grad_norm),
                f'{name}: train step loss {loss}, grad norm {grad_norm}')
        want_launches = {shapes[k]: n for k, n in per_video.items()}
        require(launches[name] == want_launches,
                f'{name}: fused launches {launches[name]}, expected '
                f'{want_launches}')
        del model, cpu, step, m
        torch.cuda.empty_cache()
    print('options: ' + json.dumps(dict(options=lines, card=card_line())))
    return launches


def phase_video(root):
    """Phase 9, video files, in ``root`` beside phase 5's checkpoint:
    returns the fused launches by case."""
    import cv2
    t0 = time.perf_counter()
    print('host: ' + json.dumps(dict(video=video_census())))
    ann, size = write_videos(root)
    print(f'video set: {DATA_VIDEOS} mp4v videos x {DATA_FRAMES} frames of '
          f'{DATA_HW[1]}x{DATA_HW[0]} at {VIDEO_FPS} fps, mean '
          f'{size:.0f} bytes, written and read back in '
          f'{time.perf_counter() - t0:.3f} s with cv2 {cv2.__version__}')
    launches = dict(test_cli=_video_test_cli(root, ann),
                    train_cli=_video_train_cli(root))
    _with_cp()
    launches.update(_layer_options())
    print(f'phase 9: {time.perf_counter() - t0:.3f} s')
    return launches


def write_config_3d(root, name, base, data, extra=()):
    """A config that inherits the shipped 3-D config ``base`` unchanged but
    for the data splits in ``data`` and ``extra`` lines; its path."""
    import re
    text = re.sub(r'\binf\b', "float('inf')", '\n'.join(
        [f'_base_ = {base!r}', f'data = dict(**{data!r})'] + list(extra)
        + ['']))
    path = os.path.join(root, f'{name}.py')
    with open(path, 'w') as f:
        f.write(text)
    return path


def _fused_total():
    from mvfnet_tpu_torch.ops import fused_block as fb
    return fb.bottleneck_eval_cuda.launches


def _random_3d_checkpoint(root, name):
    """The config's recognizer with seeded random weights (BN statistics
    drawn too), saved as ``.pth``; its path."""
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.models import build_recognizer
    cfg = Config.fromfile(CONFIGS_3D[name])
    model = build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    path = os.path.join(root, f'{name}_random.pth')
    torch.save(model.state_dict(), path)
    return path


def _one_view_against_cpu(name, config, ckpt):
    """One view of one video through the card in the config's compute dtype
    against the same weights' fp32 forward on the CPU; the error, the
    tolerance (3e-2 of the CPU's largest logit) and the CPU's argmax."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset, device_norm_cfg
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    from mvfnet_tpu_torch.utils.checkpoint import load_weights
    cfg = Config.fromfile(config)
    norm = device_norm_cfg(cfg.data['test']['pipeline'])
    view = np.asarray(build_dataset(dict(cfg.data['test']))[0][
        'img_group'])[None, :1]
    model = cli.build_model(cfg, False, None)
    load_weights(model, ckpt)
    got = make_eval_step(model, norm_cfg=norm)(model, view).float().cpu()
    cpu = build_recognizer(dict(cfg.model, dtype='float32'),
                           test_cfg=dict(average_clips=None))
    cpu.load_state_dict(model.state_dict())
    want = make_eval_step(cpu, norm_cfg=norm, device='cpu')(cpu, view)
    err = float((got - want).abs().max())
    tol = 3e-2 * float(want.abs().max())
    require(bool(torch.isfinite(got).all()) and err <= tol,
            f'{name}: card vs fp32 CPU logits of one view {err} > {tol}')
    del model, cpu
    torch.cuda.empty_cache()
    return dict(view_shape=list(view.shape), max_abs_err=err, tol=tol,
                argmax_agree=bool((got.argmax(-1) == want.argmax(-1)).all()))


def _dense_3d(root):
    """(a) the test CLI on each shipped 3-D config: a warm-up, a timed and
    a profiled pass over DENSE3D_VIDEOS of phase 5's videos; returns the
    fused launches of each timed pass and each config's scores."""
    import pickle
    import re

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    ann = os.path.join(root, 'test_list_3d.txt')
    with open(ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for i in range(DENSE3D_VIDEOS))
    ckpts = {name: _random_3d_checkpoint(root, name)
             for name in ('i3d', 'slowfast', 'x3d')}
    ckpts['slowfast_unpacked'] = ckpts['slowfast']
    launches, scores = {}, {}
    for name, base in CONFIGS_3D.items():
        config = write_config_3d(root, f'test3d_{name}', base, dict(
            test=dict(ann_file=ann, data_root=root)))
        cfg = Config.fromfile(config)
        sample = [op for op in cfg.data['test']['pipeline']
                  if op['type'] == 'SampleFrames'][0]
        views = sample['num_clips'] * 3
        out = os.path.join(root, f'scores3d_{name}.pkl')
        args = [config, ckpts[name], '--out', out]
        _quiet(cli.main, args)                              # warm-up pass
        torch.cuda.synchronize()
        before = _fused_total()
        t0 = time.perf_counter()
        _, text = _quiet(cli.main, args)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = _fused_total() - before
        with open(out, 'rb') as f:
            rows = np.stack(pickle.load(f))
        scores[name] = rows
        require(rows.shape == (DENSE3D_VIDEOS, 400)
                and bool(np.isfinite(rows).all())
                and bool((np.abs(rows.sum(1) - 1) <= 1e-3).all()),
                f'{name}: scores {rows.shape}, sums {rows.sum(1)}')
        printed = dict(re.findall(r'^(Top-1|Top-5|Mean Class) Accuracy '
                                  r'= (\d+\.\d\d)$', text, re.M))
        want = numpy_accuracy(rows, list(range(DENSE3D_VIDEOS)))
        require(printed == {k: f'{v * 100:.02f}' for k, v in zip(
            ('Top-1', 'Top-5', 'Mean Class'), want)},
            f'{name}: printed {printed}, numpy {want}')
        require(launches[name] == 0,
                f'{name}: the fused 2-D kernel launched {launches[name]} '
                f'times on a 3-D path')
        prof = device_profile(lambda: _quiet(cli.main, args))
        require('busy_ms' in prof, f'{name} profile: {prof}')
        one = _one_view_against_cpu(name, config, ckpts[name])
        clip = list(build_dataset(dict(cfg.data['test']))[0][
            'img_group'].shape)
        print('video3d: ' + json.dumps(dict(
            case=name, recognizer=cfg.model['type'],
            backbone=cfg.model['backbone']['type'],
            dtype=cfg.compute_dtype, videos=DENSE3D_VIDEOS,
            views_per_video=views, video=clip, pass_s=secs,
            videos_per_s=DENSE3D_VIDEOS / secs,
            clips_per_s=DENSE3D_VIDEOS * views / secs,
            device_ms_per_video=prof['busy_ms'] / DENSE3D_VIDEOS,
            device_idle_share=prof['idle_share'],
            profiled_pass_ms=prof['wall_ms'], fused_launches=launches[name],
            one_view_vs_cpu_fp32=one, card=card_line())))
        print(f'video3d profile {name}: ' + json.dumps(prof))
    diff = float(np.abs(scores['slowfast']
                        - scores['slowfast_unpacked']).max())
    print(f'video3d: packed vs unpacked SlowFast scores max abs diff {diff}')
    require(diff == 0, f'packed and unpacked SlowFast scores differ by '
                       f'{diff}')
    return launches, ckpts


def _train_shape_3d(cfg):
    """The config's train batch shape: videos_per_gpu clips of its train
    pipeline's clip length at its crop."""
    ops = {op['type']: op for op in cfg.data['train']['pipeline']}
    crop = [op for t, op in ops.items() if t.startswith('Random')
            and 'input_size' in op][0]['input_size']
    return (cfg.data['videos_per_gpu'], 1, ops['SampleFrames']['clip_len'],
            crop, crop, 3)


def _train_batch_3d(cfg, seed):
    """A uint8 batch of the config's train shape, and labels."""
    import numpy as np
    shape = _train_shape_3d(cfg)
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 256, shape, dtype=np.uint8),
            rs.randint(0, 400, shape[0]))


def _train_state_3d(cfg, remat=False, model=None):
    """The config's recognizer (seeded unless given) and its recipe's
    train step on the card."""
    import torch
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer,
                                               frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    from mvfnet_tpu_torch.models import build_recognizer
    if model is None:
        model = build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype),
                                 test_cfg=dict(cfg.test_cfg))
        model.init_weights(torch.Generator().manual_seed(0),
                           randomize_bn=True)
    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH, cfg.total_epochs)
    opt = build_optimizer(model, cfg.optimizer, schedule,
                          grad_clip=cfg.optimizer_config['grad_clip'],
                          frozen_prefixes=frozen_prefixes_from_backbone(
                              cfg.model['backbone']))
    step = make_train_step(model, opt, schedule,
                           norm_cfg=dict(cfg.img_norm_cfg, device=True),
                           remat=remat)
    return model, step


def _train_steps_3d():
    """(b) each family's train step at its config's batch: a warm-up and
    TRAIN3D_STEPS timed steps (finite, their median time, peak memory),
    and the I3D step with and without ``with_cp`` from one state; returns
    the fused launches per family."""
    import copy
    import math

    import torch
    from mvfnet_tpu_torch.config import Config
    launches = {}
    for family in ('i3d', 'slowfast', 'x3d'):
        cfg = Config.fromfile(CONFIGS_3D[family])
        model, step = _train_state_3d(cfg)
        batches = [_train_batch_3d(cfg, s) for s in range(TRAIN3D_STEPS + 1)]
        before = _fused_total()
        gen = torch.Generator(device='cuda')
        losses = [step(*batches[0], gen.manual_seed(0))['loss'].item()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for i, batch in enumerate(batches[1:]):
            t0 = time.perf_counter()
            m = step(*batch, gen.manual_seed(i + 1))
            losses.append(m['loss'].item())
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches[family] = _fused_total() - before
        require(all(math.isfinite(v) for v in losses),
                f'{family}: train losses {losses}')
        require(launches[family] == 0,
                f'{family}: the fused kernel launched in the train steps')
        print('train3d: ' + json.dumps(dict(
            case=family, backbone=cfg.model['backbone']['type'],
            batch=list(batches[0][0].shape), dtype=cfg.compute_dtype,
            loss=losses, step_ms=[s * 1e3 for s in secs],
            median_step_ms=statistics.median(secs) * 1e3,
            clips_per_s=batches[0][0].shape[0] / statistics.median(secs),
            max_memory_allocated_gib=peak, card=card_line())))
        if family == 'i3d':
            base = copy.deepcopy(model).cpu()
        del model, step
        torch.cuda.empty_cache()

    cfg = Config.fromfile(CONFIGS_3D['i3d'])
    batch = _train_batch_3d(cfg, 0)
    runs = {}
    for remat in (False, True):
        model, step = _train_state_3d(cfg, remat, copy.deepcopy(base))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = step(*batch, torch.Generator(device='cuda').manual_seed(1))
        loss = m['loss'].item()
        runs[remat] = dict(loss=loss, grad_norm=m['grad_norm'].item(),
                           ms=(time.perf_counter() - t0) * 1e3,
                           peak=torch.cuda.max_memory_allocated() / 2 ** 30)
        del model, step, m
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    print('with_cp3d: ' + json.dumps(dict(
        case='i3d', batch=list(batch[0].shape), loss=[off['loss'],
                                                      on['loss']],
        grad_norm=[off['grad_norm'], on['grad_norm']],
        step_ms=[off['ms'], on['ms']],
        max_memory_allocated_gib=[off['peak'], on['peak']],
        card=card_line())))
    # the same forward: equal far below bf16's resolution
    require(abs(on['loss'] - off['loss']) <= 1e-6 * abs(off['loss']),
            f'I3D with_cp: loss {on["loss"]} against {off["loss"]}')
    require(on['peak'] < off['peak'],
            f'I3D with_cp: peak {on["peak"]} GiB not below {off["peak"]}')
    return launches


def _train_cli_3d(root):
    """(c) the train CLI on the I3D config: phase 5's videos listed twice
    in the train split, two of them in the val split, two epochs with a
    checkpoint and an evaluation each, then a run resumed from epoch 1;
    returns the fused launches."""
    import math

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.tools import train_recognizer as cli
    train_ann = os.path.join(root, 'train_list_3d.txt')
    with open(train_ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for _ in range(2) for i in range(DATA_VIDEOS))
    val = dict(ann_file=os.path.join(root, 'test_list_3d.txt'),
               data_root=root)
    base = Config.fromfile(CONFIGS_3D['i3d'])
    config = write_config_3d(root, 'train3d_i3d', CONFIGS_3D['i3d'], dict(
        train=dict(ann_file=train_ann, data_root=root),
        val=dict(base.data['test'], **val)), [
        'total_epochs = 2', 'resume_from = None',
        'checkpoint_config = dict(interval=1)',
        'log_config = dict(interval=1)', 'eval_interval = 1'])
    work = os.path.join(root, 'train3d_i3d')
    before = _fused_total()
    t0 = time.perf_counter()
    loop = cli.main([config, '--work_dir', work, '--validate'])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    iters, _ = train_log(work)
    losses = [r['loss'] for r in iters]
    per_epoch = loop.iters_per_epoch
    require(per_epoch == 2 * DATA_VIDEOS // loop.loader.batch_size
            and len(iters) == 2 * per_epoch == loop.step,
            f'I3D train CLI: {per_epoch} iterations an epoch, {len(iters)} '
            f'logged, {loop.step} steps')
    require(all(math.isfinite(v) for r in iters for v in r.values()),
            f'I3D train CLI: non-finite metrics {iters}')
    for name in ('epoch_1.pth', 'epoch_2.pth', 'latest.pth', 'train.log'):
        require(os.path.exists(os.path.join(work, name)),
                f'I3D train CLI: {name} not written')
    require([e['epoch'] for e in loop.eval_history] == [1, 2]
            and all(np.asarray(e['scores']).shape == (DENSE3D_VIDEOS, 400)
                    for e in loop.eval_history),
            f'I3D train CLI: evaluations {loop.eval_history}')
    with open(os.path.join(work, 'train.log')) as f:
        require('model: Recognizer3D(ResNet_I3D, I3DClsHead)' in f.read(),
                'I3D train CLI: the log does not name the model')
    again = cli.main([config, '--work_dir', os.path.join(root, 'resumed3d'),
                      '--resume_from', os.path.join(work, 'epoch_1.pth')])
    tail, _ = train_log(os.path.join(root, 'resumed3d'))
    rel = [abs(a['loss'] - b['loss']) / abs(b['loss'])
           for a, b in zip(tail, iters[per_epoch:])]
    require(again.step == 2 * per_epoch and len(tail) == per_epoch
            and max(rel) <= RESUME_TOL,
            f'I3D train CLI: resumed {again.step} steps, losses {rel} '
            f'relative')
    launches = _fused_total() - before
    require(launches == 0, f'I3D train CLI: {launches} fused launches')
    secs = [r['s'] for r in iters[1:]]
    print('train_cli3d: ' + json.dumps(dict(
        case='i3d', batch=list(_train_shape_3d(loop.cfg)),
        iterations=len(iters), run_s=run_s, s_per_iter=secs,
        median_s_per_iter=statistics.median(secs), loss=losses,
        resumed_loss=[r['loss'] for r in tail], resume_loss_rel=rel,
        fused_launches=launches, card=card_line())))
    del loop, again
    torch.cuda.empty_cache()
    return launches


def _features_3d(root, ckpt):
    """(d) the feature CLI on the SlowFast config: each view's row is the
    slow and fast pathways' pooled features, 2048 + 256 wide; the FC of
    one video's rows against its per-view logits. Returns the fused
    launches."""
    import math

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset, device_norm_cfg
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.tools import feature_extractor
    from mvfnet_tpu_torch.tools import test_recognizer as test_cli
    from mvfnet_tpu_torch.utils.checkpoint import load_weights
    config = os.path.join(root, 'test3d_slowfast.py')
    cfg = Config.fromfile(config)
    views = [op for op in cfg.data['test']['pipeline']
             if op['type'] == 'SampleFrames'][0]['num_clips'] * 3
    dim = 2048 + 256
    out = os.path.join(root, 'features3d.json')
    before = _fused_total()
    t0 = time.perf_counter()
    _quiet(feature_extractor.main, [config, ckpt, '--out', out])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _fused_total() - before
    with open(out) as f:
        written = json.load(f)
    require(len(written) == DENSE3D_VIDEOS and all(
        len(v) == views * dim and all(map(math.isfinite, v))
        for v in written.values()),
        f'features3d: {len(written)} entries of '
        f'{sorted({len(v) for v in written.values()})} floats')
    require(launches == 0, f'features3d: {launches} fused launches')
    model = test_cli.build_model(cfg, False, None)
    load_weights(model, ckpt)
    step = make_eval_step(model, norm_cfg=device_norm_cfg(
        cfg.data['test']['pipeline']))
    video = build_dataset(dict(cfg.data['test']), 'cuda')[0]['img_group'][
        None]
    logits = step(model, video).float()
    feats = torch.tensor(np.asarray(written['video_0']),
                         device=logits.device).reshape(views, dim)
    with torch.inference_mode():
        fc = model.cls_head.fc(feats)
    err = float((fc - logits).abs().max())
    tol = 3e-2 * float(logits.abs().max())
    print('features3d: ' + json.dumps(dict(
        case='slowfast', videos=DENSE3D_VIDEOS, rows_per_video=views,
        dim=dim, pass_s=secs, videos_per_s=DENSE3D_VIDEOS / secs,
        fused_launches=launches, fc_vs_logits_max_abs_err=err, tol=tol,
        card=card_line())))
    require(err <= tol, f'features3d: FC of the rows vs the logits {err} > '
                        f'{tol}')
    del model, step
    torch.cuda.empty_cache()
    return launches


def phase_3d(root):
    """Phase 10, the shipped 3-D configs, in ``root`` beside phase 5's
    videos: returns the fused launches by case (all 0)."""
    t0 = time.perf_counter()
    launches, ckpts = _dense_3d(root)
    launches = {f'test_{k}': v for k, v in launches.items()}
    launches.update({f'train_{k}': v
                     for k, v in _train_steps_3d().items()})
    launches['train_cli_i3d'] = _train_cli_3d(root)
    launches['features_slowfast'] = _features_3d(root, ckpts['slowfast'])
    print(f'phase 10: {time.perf_counter() - t0:.3f} s')
    return launches

def expected_fused(model_cfg, frames, hw, batches=1):
    """The fused kernel's launches worked out from a 2-D model config alone,
    by (dtype, N, H, W, Cin, Cm): ``batches`` eval batches of ``frames``
    frames of hw^2 through a bottleneck ResNet (strides 1, 2, 2, 2 after the
    stem's 4) launch it once in each block after a stage's first, in each
    stage that no temporal module takes (MVF takes a selected stage's every
    block, CoST every block after the first: neither fuses) and that
    ``quant_stages`` leaves unquantized. Every other backbone launches
    nothing."""
    bb = model_cfg['backbone']
    out = collections.Counter()
    if bb['type'] != 'ResNet' or bb['depth'] < 50:
        return out
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
              152: (3, 8, 36, 3)}[bb['depth']]
    module = model_cfg.get('module_cfg') or {}
    freq = (module.get('mvf_freq', module.get('shift_freq', (1, 1, 1, 1)))
            if module else (0, 0, 0, 0))
    quant = (bb.get('quant_stages', (1, 1, 1, 1)) if bb.get('quant')
             else (0, 0, 0, 0))
    side = hw // 4
    for i, n in enumerate(blocks):
        side = side if i == 0 else side // 2
        planes = 64 * 2 ** i
        if not freq[i] and not quant[i]:
            out[('bfloat16', frames, side, side, 4 * planes, planes)] += \
                (n - 1) * batches
    return out


def _launches_by_shape():
    from mvfnet_tpu_torch.ops import fused_block as fb
    return collections.Counter(fb.bottleneck_eval_cuda.launches_by_shape)


def _family_model_cfg(name):
    """Phase 11's 2-D cases as model configs: the flagship's (R50 + MVF in
    stages 3-4, 8 segments, 400 classes, bf16) with MobileNetV2-1.0 and TSM
    or MVF, CoST or non-local blocks in place of MVF, or a TRN head, and the
    shipped BNInception config's."""
    from mvfnet_tpu_torch.config import Config
    if name == 'bninception':
        cfg = Config.fromfile(BNI_CONFIG)
        return dict(cfg.model, dtype='bfloat16'), cfg
    cfg = Config.fromfile(CONFIG)
    model = dict(cfg.model, dtype=cfg.compute_dtype)
    head = dict(model['cls_head'])
    mvf = dict(model['module_cfg'])
    if name.startswith('mbv2'):
        model['backbone'] = dict(type='MobileNetV2', width_mult=1.0)
        head['in_channels'] = 1280
        model['module_cfg'] = (dict(type='tsm', n_segment=8, n_div=8)
                               if name == 'mbv2_tsm' else mvf)
    elif name == 'r50_cost':
        model['module_cfg'] = dict(type='CoST', n_segment=8,
                                   shift_freq=(0, 0, 1, 1))
    elif name == 'r50_nonlocal':
        model['module_cfg'] = None
        model['nonlocal_cfg'] = dict(n_segment=8)
    elif name in ('mvf_trn', 'mvf_trnmultiscale'):
        # the TSN path: frames pooled, projected to 256 and related (the
        # fcn path would return the projection, as the JAX head does)
        model['fcn_testing'] = False
        head['consensus_cfg'] = dict(
            type='TRN' if name == 'mvf_trn' else 'TRNmultiscale',
            num_frames=8)
    model['cls_head'] = head
    return model, cfg


def tame_nonlocal(model, scale=0.1):
    """The non-local blocks' ``conv_in`` and BatchNorm gamma scaled down
    after the random init, as in the CPU tests: their cubic affinity
    overflows bf16 from the plain init, in the JAX package too."""
    import torch
    from mvfnet_tpu_torch.models.modules.nonlocal_attention import \
        LocalAttention
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, LocalAttention):
                m.conv_in.weight.mul_(scale)
                m.bn.weight.mul_(scale)
    return model


def _family_model(model_cfg, seed=0):
    """The config's recognizer with seeded random weights (BN statistics
    drawn too), non-local blocks tamed."""
    import torch
    from mvfnet_tpu_torch.models import build_recognizer
    model = build_recognizer(dict(model_cfg), test_cfg=dict(
        average_clips='prob'))
    model.init_weights(torch.Generator().manual_seed(seed),
                       randomize_bn=True)
    return tame_nonlocal(model)


def _family_step(model, cfg):
    """The config's recipe as a train step on the card (device
    normalization)."""
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer,
                                               frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH, cfg.total_epochs)
    opt = build_optimizer(model, cfg.optimizer, schedule,
                          grad_clip=cfg.optimizer_config['grad_clip'],
                          frozen_prefixes=frozen_prefixes_from_backbone(
                              cfg.model['backbone']))
    return make_train_step(model, opt, schedule,
                           norm_cfg=dict(cfg.img_norm_cfg, device=True))


def _family_train(name, model, cfg, shape):
    """One case's train step on uint8 batches of ``shape``: one step from
    copies of the initial state in bf16 and in fp32 (TF32 off; the losses
    within 2e-2), then TRAIN_WARMUP warm-up and TRAIN_STEPS timed steps
    (finite, the median, the peak memory, no fused launch)."""
    import copy
    import math

    import numpy as np
    import torch
    classes = cfg.model['cls_head']['num_classes']
    batches = [(np.random.RandomState(seed).randint(0, 256, shape,
                                                    dtype=np.uint8),
                np.random.RandomState(1000 + seed).randint(0, classes,
                                                           shape[0]))
               for seed in range(TRAIN_WARMUP + TRAIN_STEPS)]
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    one = {}
    try:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        for dtype in ('bfloat16', 'float32'):
            twin = copy.deepcopy(model)
            twin.dtype = getattr(torch, dtype)
            m = _family_step(twin, cfg)(
                *batches[0], torch.Generator(device='cuda').manual_seed(1))
            one[dtype] = m['loss'].item()
            del twin, m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    rel = abs(one['bfloat16'] - one['float32']) / abs(one['float32'])
    step = _family_step(model, cfg)
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = _fused_total()
    losses = [step(*b, gen)['loss'].item()
              for b in batches[:TRAIN_WARMUP]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for b in batches[TRAIN_WARMUP:]:
        t0 = time.perf_counter()
        losses.append(step(*b, gen)['loss'].item())
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fused = _fused_total() - before
    med = statistics.median(secs)
    print('family11: ' + json.dumps(dict(
        case=name, kind='train_step', batch=list(shape),
        dtype=str(model.compute_dtype).split('.')[-1], loss=losses,
        step_ms=[s * 1e3 for s in secs], median_step_ms=med * 1e3,
        clips_per_s=shape[0] / med, max_memory_allocated_gib=peak,
        bf16_vs_fp32_loss=[one['bfloat16'], one['float32']],
        loss_rel=rel, fused_launches=fused, card=card_line())))
    require(all(math.isfinite(v) for v in losses),
            f'{name}: train losses {losses}')
    require(rel <= 2e-2, f'{name}: bf16 vs fp32 loss relative {rel}')
    require(fused == 0, f'{name}: {fused} fused launches while training')
    del step
    torch.cuda.empty_cache()


def _view_against_cpu(name, model, model_cfg, view, norm):
    """One view through the card in bf16 against the same weights' fp32
    forward on the CPU; the error must lie within 3e-2 of the CPU's
    largest logit."""
    import torch
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.models import build_recognizer
    test_cfg = model.test_cfg
    model.test_cfg = dict(average_clips=None)
    try:
        got = make_eval_step(model, norm_cfg=norm)(model, view).float().cpu()
    finally:
        model.test_cfg = test_cfg
    cpu = build_recognizer(dict(model_cfg, dtype='float32'),
                           test_cfg=dict(average_clips=None))
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = make_eval_step(cpu, norm_cfg=norm, device='cpu')(cpu, view)
    err = float((got - want).abs().max())
    tol = 3e-2 * float(want.abs().max())
    require(bool(torch.isfinite(got).all()) and err <= tol,
            f'{name}: card vs fp32 CPU logits of one view {err} > {tol}')
    return dict(view_shape=list(view.shape), max_abs_err=err, tol=tol,
                argmax_agree=bool((got.argmax(-1) == want.argmax(-1)).all()))


def _family_eval(name, model, model_cfg, video, norm, expected):
    """One case's eval pass: a warm-up, FAMILY_EVAL_RUNS timed calls (the
    fused launches of each against ``expected``), a profiled call, and one
    view against the fp32 CPU forward."""
    import torch
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    model.eval()
    step = make_eval_step(model, norm_cfg=norm)
    scores = step(model, video)
    require(bool(torch.isfinite(scores).all()),
            f'{name}: non-finite eval scores')
    torch.cuda.synchronize()
    before = _launches_by_shape()
    secs = []
    for _ in range(FAMILY_EVAL_RUNS):
        t0 = time.perf_counter()
        step(model, video)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = _launches_by_shape() - before
    want = collections.Counter({k: v * FAMILY_EVAL_RUNS
                                for k, v in expected.items()})
    prof = device_profile(lambda: step(model, video))
    require('busy_ms' in prof, f'{name} profile: {prof}')
    one = _view_against_cpu(name, model, model_cfg,
                            video[:, :video.shape[1] // VIEWS], norm)
    med = statistics.median(secs)
    print('family11: ' + json.dumps(dict(
        case=name, kind='eval', video=list(video.shape),
        dtype=str(model.compute_dtype).split('.')[-1], pass_ms=[
            s * 1e3 for s in secs], videos_per_s=1 / med,
        device_ms_per_video=prof['busy_ms'],
        device_idle_share=prof['idle_share'],
        fused_launches={'/'.join(map(str, k)): v
                        for k, v in launches.items()},
        fused_expected={'/'.join(map(str, k)): v for k, v in want.items()},
        one_view_vs_cpu_fp32=one, card=card_line())))
    print(f'family11 profile {name}: ' + json.dumps(prof))
    require(launches == want, f'{name}: fused launches {dict(launches)}, '
                              f'expected from the config {dict(want)}')
    return launches


def _family_2d():
    """(b)-(d): each 2-D case's train step at the flagship's batch and a
    dense-test video through its eval path; returns the fused launches by
    case and shape."""
    import numpy as np
    import torch
    video = np.random.RandomState(0).randint(
        0, 256, (1, VIEWS * TRAIN_BATCH[1], CROP, CROP, 3), dtype=np.uint8)
    launches = {}
    for name in FAMILY_2D:
        model_cfg, cfg = _family_model_cfg(name)
        model = _family_model(model_cfg).to('cuda')
        _family_train(name, model, cfg, TRAIN_BATCH)
        launches[name] = _family_eval(
            name, model, model_cfg, video,
            dict(cfg.img_norm_cfg, device=True),
            expected_fused(model_cfg, VIEWS * TRAIN_BATCH[1], CROP))
        del model
        torch.cuda.empty_cache()
    return launches


def _random_checkpoint(root, name, model_cfg):
    import torch
    path = os.path.join(root, f'{name}_random.pth')
    torch.save(_family_model(model_cfg).state_dict(), path)
    return path


def _bninception(root):
    """(a) the shipped BNInception config: its test CLI over
    FAMILY_VIDEOS of phase 5's videos (25 segments x TenCrop), its train
    step, its train CLI for 2 epochs of 2 iterations and a resume, and
    ``convert_checkpoint`` of the seeded ``.pth`` scored again through the
    test CLI. Returns the fused launches (none)."""
    import math
    import pickle
    import re

    import numpy as np
    import torch
    from mvfnet_tpu_torch.tools import convert_checkpoint
    from mvfnet_tpu_torch.tools import test_recognizer as test_cli
    from mvfnet_tpu_torch.tools import train_recognizer as train_cli
    model_cfg, cfg = _family_model_cfg('bninception')
    ckpt = _random_checkpoint(root, 'bninception', model_cfg)
    ann = os.path.join(root, 'test_list_family.txt')
    with open(ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for i in range(FAMILY_VIDEOS))
    config = write_config_3d(root, 'test_bninception', BNI_CONFIG, dict(
        test=dict(ann_file=ann, data_root=root)),
        ["compute_dtype = 'bfloat16'"])
    views = 25 * 10
    out = os.path.join(root, 'scores_bninception.pkl')
    args = [config, ckpt, '--out', out]
    before = _fused_total()
    _quiet(test_cli.main, args)                              # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, text = _quiet(test_cli.main, args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with open(out, 'rb') as f:
        rows = np.stack(pickle.load(f))
    require(rows.shape == (FAMILY_VIDEOS, 400)
            and bool(np.isfinite(rows).all())
            and bool((np.abs(rows.sum(1) - 1) <= 1e-3).all()),
            f'bninception: scores {rows.shape}, sums {rows.sum(1)}')
    printed = dict(re.findall(r'^(Top-1|Top-5|Mean Class) Accuracy '
                              r'= (\d+\.\d\d)$', text, re.M))
    want = numpy_accuracy(rows, list(range(FAMILY_VIDEOS)))
    require(printed == {k: f'{v * 100:.02f}' for k, v in zip(
        ('Top-1', 'Top-5', 'Mean Class'), want)},
        f'bninception: printed {printed}, numpy {want}')
    prof = device_profile(lambda: _quiet(test_cli.main, args))
    require('busy_ms' in prof, f'bninception profile: {prof}')
    one = _one_view_against_cpu('bninception', config, ckpt)
    msgpack = os.path.join(root, 'bninception_random.msgpack')
    report = convert_checkpoint.main([config, ckpt, msgpack])
    require(not (report['missing'] or report['unexpected']
                 or report['mismatched']),
            f'bninception convert_checkpoint report {report}')
    out_mp = os.path.join(root, 'scores_bninception_msgpack.pkl')
    _quiet(test_cli.main, [config, msgpack, '--out', out_mp])
    with open(out_mp, 'rb') as f:
        diff = float(np.abs(np.stack(pickle.load(f)) - rows).max())
    require(diff <= DATA_TOL, f'bninception: .msgpack scores {diff} from '
                              f'the .pth ones')
    test_launches = _fused_total() - before
    print('family11: ' + json.dumps(dict(
        case='bninception', kind='test_cli', videos=FAMILY_VIDEOS,
        views_per_video=views, pass_s=secs,
        videos_per_s=FAMILY_VIDEOS / secs,
        clips_per_s=FAMILY_VIDEOS * views / secs,
        device_ms_per_video=prof['busy_ms'] / FAMILY_VIDEOS,
        device_idle_share=prof['idle_share'],
        msgpack_vs_pth_max_abs_diff=diff, fused_launches=test_launches,
        one_view_vs_cpu_fp32=one, card=card_line())))
    print('family11 profile bninception: ' + json.dumps(prof))

    model = _family_model(model_cfg).to('cuda')
    batch = (cfg.data['videos_per_gpu'], 3) + TRAIN_BATCH[2:]
    _family_train('bninception', model, cfg, batch)
    del model
    torch.cuda.empty_cache()

    train_ann = os.path.join(root, 'train_list_family.txt')
    reps = 2 * cfg.data['videos_per_gpu'] // DATA_VIDEOS
    with open(train_ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for _ in range(reps) for i in range(DATA_VIDEOS))
    train_config = write_config_3d(
        root, 'train_bninception', BNI_CONFIG,
        dict(train=dict(ann_file=train_ann, data_root=root)), [
            "compute_dtype = 'bfloat16'", 'total_epochs = 2',
            'resume_from = None', 'checkpoint_config = dict(interval=1)',
            'log_config = dict(interval=1)'])
    work = os.path.join(root, 'train_bninception')
    before = _fused_total()
    t0 = time.perf_counter()
    loop = train_cli.main([train_config, '--work_dir', work])
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    iters, _ = train_log(work)
    per_epoch = loop.iters_per_epoch
    require(per_epoch == 2 and len(iters) == 4 == loop.step,
            f'bninception train CLI: {per_epoch} iterations an epoch, '
            f'{len(iters)} logged, {loop.step} steps')
    require(all(math.isfinite(v) for r in iters for v in r.values()),
            f'bninception train CLI: non-finite metrics {iters}')
    again = train_cli.main([train_config, '--work_dir',
                            os.path.join(root, 'resumed_bninception'),
                            '--resume_from',
                            os.path.join(work, 'epoch_1.pth')])
    tail, _ = train_log(os.path.join(root, 'resumed_bninception'))
    rel = [abs(a['loss'] - b['loss']) / abs(b['loss'])
           for a, b in zip(tail, iters[per_epoch:])]
    require(again.step == 4 and len(tail) == per_epoch
            and max(rel) <= RESUME_TOL,
            f'bninception train CLI: resumed {again.step} steps, losses '
            f'{rel} relative')
    train_launches = _fused_total() - before
    require(test_launches == train_launches == 0,
            f'bninception: {test_launches} + {train_launches} fused '
            f'launches')
    secs = [r['s'] for r in iters[1:]]
    print('family11: ' + json.dumps(dict(
        case='bninception', kind='train_cli', batch=list(batch),
        iterations=len(iters), run_s=run_s, s_per_iter=secs,
        median_s_per_iter=statistics.median(secs),
        loss=[r['loss'] for r in iters],
        resumed_loss=[r['loss'] for r in tail], resume_loss_rel=rel,
        fused_launches=train_launches, card=card_line())))
    del loop, again
    torch.cuda.empty_cache()
    return {'bninception_test_cli': collections.Counter(),
            'bninception_train_cli': collections.Counter()}


def _i3d_nonlocal(root):
    """(e) the shipped I3D config with non-local blocks after every block
    of stages 2-3 (``nonlocal_stages=(1, 2)``, the default
    ``nonlocal_freq``): one video of its test pipeline (10 clips x 3 crops
    of 32 frames) through the eval step, and a train step at its batch.
    (f) ``RecognizerC2D`` (ResNet-50 without inflation on 8-frame clips):
    one forward against the fp32 CPU forward."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset, device_norm_cfg
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    ann = os.path.join(root, 'test_list_family_3d.txt')
    with open(ann, 'w') as f:
        f.write(f'video_0 {DATA_FRAMES} 0\n')
    config = write_config_3d(root, 'i3d_nonlocal', CONFIGS_3D['i3d'], dict(
        test=dict(ann_file=ann, data_root=root)), [
        'model = dict(backbone=dict(nonlocal_stages=(1, 2), '
        'nonlocal_cfg=dict()))'])
    cfg = Config.fromfile(config)
    model_cfg = dict(cfg.model, dtype=cfg.compute_dtype)
    model = _family_model(model_cfg).to('cuda')
    blocks = sum(1 for n, _ in model.named_modules()
                 if n.endswith('nonlocal_block'))
    require(blocks == 4 + 6, f'i3d_nonlocal: {blocks} non-local blocks')
    norm = device_norm_cfg(cfg.data['test']['pipeline'])
    video = np.asarray(build_dataset(dict(cfg.data['test']))[0][
        'img_group'])[None]
    launches = {'i3d_nonlocal': _family_eval(
        'i3d_nonlocal', model, model_cfg, video, norm, {})}
    shape = (cfg.data['videos_per_gpu'],) + _train_shape_3d(cfg)[1:]
    model.train()
    _family_train('i3d_nonlocal', model, cfg, shape)
    del model
    torch.cuda.empty_cache()

    c2d_cfg = dict(
        type='RecognizerC2D', modality='RGB', dtype='bfloat16',
        backbone=dict(type='ResNet_I3D', depth=50, out_indices=(3,),
                      inflate_freq=0, conv1_kernel=(1, 7, 7),
                      conv1_stride_t=1, pool1_stride_t=1, no_pool2=True,
                      norm_eval=False),
        cls_head=dict(type='I3DClsHead', in_channels=2048, num_classes=400,
                      dropout_ratio=0.5))
    model = _family_model(c2d_cfg).to('cuda').eval()
    clip = np.random.RandomState(3).randint(
        0, 256, (1, 1) + TRAIN_BATCH[1:], dtype=np.uint8)
    before = _fused_total()
    t0 = time.perf_counter()
    scores = make_eval_step(model, norm_cfg=norm)(model, clip)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    one = _view_against_cpu('c2d', model, c2d_cfg, clip, norm)
    launches['c2d'] = collections.Counter()
    fused = _fused_total() - before
    print('family11: ' + json.dumps(dict(
        case='c2d', kind='forward', clip=list(clip.shape),
        scores=list(scores.shape), forward_ms=secs * 1e3,
        fused_launches=fused, one_view_vs_cpu_fp32=one, card=card_line())))
    require(fused == 0, f'c2d: {fused} fused launches')
    del model
    torch.cuda.empty_cache()
    return launches


def _validate(root, ann):
    """(g) ``validate_k400`` on phase 5's videos with the flagship's seeded
    ``.pth`` (phase 5's): its JSON line, its fused launches."""
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.tools import validate_k400
    out = os.path.join(root, 'verdict.json')
    before = _launches_by_shape()
    t0 = time.perf_counter()
    code, _ = _quiet(validate_k400.main, [
        '--checkpoint', os.path.join(root, 'mvf_r50_random.pth'),
        '--ann', ann, '--data-root', root, '--config', CONFIG,
        '--out', out])
    secs = time.perf_counter() - t0
    launches = _launches_by_shape() - before
    with open(out) as f:
        verdict = json.load(f)
    print(json.dumps(verdict))
    want = expected_fused(dict(Config.fromfile(CONFIG).model),
                          VIEWS * TRAIN_BATCH[1], CROP, DATA_VIDEOS)
    print('family11: ' + json.dumps(dict(
        case='validate_k400', kind='runbook', videos=DATA_VIDEOS,
        pass_s=secs, videos_per_s=DATA_VIDEOS / secs, exit_code=code,
        top1=verdict['top1'], fused_launches={
            '/'.join(map(str, k)): v for k, v in launches.items()},
        card=card_line())))
    require(verdict['n_videos'] == DATA_VIDEOS
            and verdict['expected_top1'] == 76.0
            and code == (1 if verdict['pass'] is False else 0),
            f'validate_k400: {verdict}, exit code {code}')
    require(launches == want, f'validate_k400: fused launches '
                              f'{dict(launches)}, expected {dict(want)}')
    return {'validate_k400': launches}


def phase_family(root, ann):
    """Phase 11, the other 2-D families, I3D's non-local blocks,
    ``RecognizerC2D`` and the user tools, in ``root`` beside phase 5's
    videos: returns the fused launches by case and shape."""
    t0 = time.perf_counter()
    launches = _bninception(root)
    launches.update(_family_2d())
    launches.update(_i3d_nonlocal(root))
    launches.update(_validate(root, ann))
    print(f'phase 11: {time.perf_counter() - t0:.3f} s')
    return launches


def _int8_config(root, name, backbone, ann):
    """A config inheriting the flagship with the backbone options in
    ``backbone`` and the test split on ``ann``; its path."""
    import re
    text = re.sub(r'\binf\b', "float('inf')", (
        f'_base_ = {CONFIG!r}\n'
        f'model = dict(backbone={backbone!r})\n'
        f'data = dict(test=dict(ann_file={ann!r}, data_root={root!r}))\n'))
    path = os.path.join(root, f'int8_{name}.py')
    with open(path, 'w') as f:
        f.write(text)
    return path


def _int8_model(cfg, ckpt, backbone):
    """The config's recognizer for per-clip logits (fcn testing), the
    checkpoint's weights, ``backbone`` options over the config's, on the
    card in eval mode."""
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    from mvfnet_tpu_torch.utils.checkpoint import load_weights
    model = cli.build_model(cfg, True, None, backbone=backbone)
    load_weights(model, ckpt)
    return model.to('cuda').eval()


def _rms_rel(got, want):
    return float(((got - want) ** 2).mean().sqrt()
                 / (want ** 2).mean().sqrt())


def _int8_pass(name, model, video, norm, want, runs=INT8_RUNS):
    """A warm-up, ``runs`` timed calls and a profiled one of the eval step
    on ``video``; per-clip logits against ``want`` (rms relative); returns
    the record (the logits under ``'logits'``)."""
    import torch
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    from mvfnet_tpu_torch.ops import int8_conv as q8
    step = make_eval_step(model, norm_cfg=norm)
    logits = step(model, video).float().cpu()
    torch.cuda.synchronize()
    before = _launches_by_shape()
    q8.int8_conv_cuda.launches_by_shape.clear()
    q8.int8_conv_cuda.launches_by_variant.clear()
    secs = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step(model, video)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    fused = _launches_by_shape() - before
    int8 = collections.Counter(q8.int8_conv_cuda.launches_by_shape)
    variants = dict(q8.int8_conv_cuda.launches_by_variant)
    prof = device_profile(lambda: step(model, video), spans=True)
    require('busy_ms' in prof, f'{name} profile: {prof}')
    require(bool(torch.isfinite(logits).all()), f'{name}: non-finite logits')
    med = statistics.median(secs)
    clips = video.shape[1] if video.ndim == 6 else video.shape[1] // 8
    return dict(
        case=name, video=list(video.shape), pass_ms=[s * 1e3 for s in secs],
        clips_per_s=clips / med, device_ms_per_video=prof['busy_ms'],
        device_idle_share=prof['idle_share'],
        int8_conv_ms=prof['by_kind_ms'].get('int8_conv', 0.0),
        quantize_ranges_ms=prof['ranges_ms'],
        by_kind_ms=prof['by_kind_ms'],
        rms_vs_reference=None if want is None else _rms_rel(logits, want),
        fused_launches={'/'.join(map(str, k)): v for k, v in fused.items()},
        int8_launches=sum(int8.values()),
        int8_variants=variants,
        fused=fused, int8=int8,
        logits=logits)


def _int8_flagship(root, ann, counts):
    """(b), (c), (e), (g): the flagship's dense test under each int8 case,
    the static cases calibrated through the test CLI; validate_k400 with
    --quant; a calibrated .msgpack read back; training refused."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.models.common import quant_buffers
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    from mvfnet_tpu_torch.tools import validate_k400
    from mvfnet_tpu_torch.utils.checkpoint import (load_weights,
                                                   save_msgpack_checkpoint)
    from mvfnet_tpu_torch.data import build_dataset
    ckpt = os.path.join(root, 'mvf_r50_random.pth')
    cfg = Config.fromfile(CONFIG)
    # a video the calibration did not see, through the config's test
    # pipeline (host normalization): the static scales hold on the
    # distribution they were calibrated on
    norm = None
    video = np.asarray(build_dataset(dict(
        cfg.data['test'], ann_file=ann, data_root=root), 'cuda')[
            INT8_CALIB_VIDEOS]['img_group'])[None]
    calib_ann = os.path.join(root, 'test_list_int8.txt')
    with open(calib_ann, 'w') as f:
        f.writelines(f'video_{i} {DATA_FRAMES} {i}\n'
                     for i in range(INT8_CALIB_VIDEOS))
    base = _int8_model(cfg, ckpt, {})
    ref = _int8_pass('bf16', base, video, norm, None)
    print('int8: ' + json.dumps({k: v for k, v in ref.items()
                                 if k not in ('logits', 'fused', 'int8')}))
    want = ref.pop('logits')
    del base
    torch.cuda.empty_cache()
    stats, logits, fused = {}, {}, {}
    for name, over in INT8_CASES.items():
        cli_s = None
        if name in INT8_CALIBRATED:
            config = _int8_config(root, name, over, calib_ann)
            t0 = time.perf_counter()
            out, _ = _quiet(cli.main, [config, ckpt, '--fcn_testing',
                                       '--calib_videos',
                                       str(INT8_CALIB_VIDEOS)])
            cli_s = time.perf_counter() - t0
            require(np.isfinite(out['scores']).all(),
                    f'{name}: CLI scores not finite')
            stats[name] = out['quant_stats']
        model = _int8_model(cfg, ckpt, over)
        source = INT8_TWIN.get(name, name)
        if source in stats:
            with torch.no_grad():
                for k, v in quant_buffers(model).items():
                    v.copy_(stats[source][k])
        rec = _int8_pass(name, model, video, norm, want)
        counts[name] = rec.pop('int8')
        logits[name] = rec.pop('logits')
        fused[name] = rec.pop('fused')
        model_cfg = dict(cfg.model, backbone=dict(cfg.model['backbone'],
                                                  **over))
        expected = expected_fused(model_cfg, VIEWS * TRAIN_BATCH[1], CROP,
                                  INT8_RUNS)
        rec.update(quant=over, calib_videos=(INT8_CALIB_VIDEOS if cli_s
                                             else None), cli_s=cli_s,
                   fused_expected={'/'.join(map(str, k)): v
                                   for k, v in expected.items()},
                   card=card_line())
        if name in INT8_TWIN:
            rec['rms_vs_unfused'] = _rms_rel(logits[name],
                                             logits[INT8_TWIN[name]])
        print('int8: ' + json.dumps(rec))
        require(rec['rms_vs_reference'] < 5e-2,
                f'{name}: int8 logits {rec["rms_vs_reference"]} of the bf16 '
                f'ones (rms)')
        require(rec.get('rms_vs_unfused', 0) < 2e-2,
                f'{name}: carry against unfused {rec.get("rms_vs_unfused")}')
        require(fused[name] == expected, f'{name}: fused launches '
                                         f'{dict(fused[name])}, expected '
                                         f'{dict(expected)}')
        require(counts[name], f'{name}: no int8 kernel launch')
        if name == INT8_MSGPACK:                                    # (e)
            path = os.path.join(root, f'int8_{name}.msgpack')
            save_msgpack_checkpoint(path, model)
            fresh = _int8_model(cfg, ckpt, over)
            load_weights(fresh, path)
            from mvfnet_tpu_torch.engine.train_step import make_eval_step
            again = make_eval_step(fresh, norm_cfg=norm)(
                fresh, video).float().cpu()
            err = float((again - logits[name]).abs().max())
            print('int8: ' + json.dumps(dict(
                case=f'{name}_msgpack', bytes=os.path.getsize(path),
                max_abs_err=err, card=card_line())))
            require(err <= 1e-5, f'{name}: .msgpack logits {err} apart')
            del fresh
        del model
        torch.cuda.empty_cache()
    # (c) validate_k400 on the 8 videos
    out = os.path.join(root, 'verdict_int8.json')
    t0 = time.perf_counter()
    code, _ = _quiet(validate_k400.main, [
        '--checkpoint', ckpt, '--ann', ann, '--data-root', root,
        '--config', CONFIG, '--quant', 'int8_static', '--quant-stages',
        '1', '1', '0', '0', '--calib-videos', str(INT8_CALIB_VIDEOS),
        '--out', out])
    secs = time.perf_counter() - t0
    with open(out) as f:
        verdict = json.load(f)
    print(json.dumps(verdict))
    print('int8: ' + json.dumps(dict(case='validate_k400', pass_s=secs,
                                     videos_per_s=DATA_VIDEOS / secs,
                                     exit_code=code, card=card_line())))
    require(verdict['quant'] == 'int8_static'
            and verdict['n_videos'] == DATA_VIDEOS
            and code == (1 if verdict['pass'] is False else 0),
            f'validate_k400 --quant: {verdict}, exit code {code}')
    # (g) training refused
    model = cli.build_model(cfg, True, None,
                            backbone=dict(quant='int8')).to('cuda').train()
    try:
        model(torch.zeros(1, 8, 64, 64, 3, device='cuda'), None,
              return_loss=False)
        refused = False
    except ValueError as e:
        refused = 'eval-only' in str(e)
    require(refused, 'quant with training did not raise')
    del model
    return fused


def _int8_3d(root, counts):
    """(d) the shipped I3D config with int8_static (calibrated on the video
    it scores) and the X3D config with int8: one dense video each against
    the same weights in bf16."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    for name, quant in (('i3d', 'int8_static'), ('x3d', 'int8')):
        cfg = Config.fromfile(CONFIGS_3D[name])
        ckpt = os.path.join(root, f'{name}_random.pth')
        sample = [op for op in cfg.data['test']['pipeline']
                  if op['type'] == 'SampleFrames'][0]
        video = np.random.RandomState(1).randint(
            0, 256, (1, sample['num_clips'] * 3, sample['clip_len'], 256,
                     256, 3), dtype=np.uint8)
        norm = dict(cfg.img_norm_cfg, device=True)
        base = _int8_model(cfg, ckpt, {})
        with torch.inference_mode():
            want = make_eval_step(base, norm_cfg=norm)(
                base, video).float().cpu()
        del base
        model = _int8_model(cfg, ckpt, dict(quant=quant))
        if quant == 'int8_static':
            with model.calibrate():
                make_eval_step(model, norm_cfg=norm)(model, video)
        rec = _int8_pass(f'{name}_{quant}', model, video, norm, want, runs=1)
        counts[name] = rec.pop('int8')
        rec.pop('logits')
        fused = rec.pop('fused')
        rec.update(card=card_line())
        print('int8: ' + json.dumps(rec))
        require(rec['rms_vs_reference'] < 5e-2,
                f'{name}: int8 logits {rec["rms_vs_reference"]} of bf16')
        require(not fused and counts[name],
                f'{name}: fused {dict(fused)}, int8 {dict(counts[name])}')
        del model
        torch.cuda.empty_cache()


def _new_backbones():
    """(f) R(2+1)D-34 and InceptionV1-I3D: a train step at their clips
    (median of TRAIN_STEPS after TRAIN_WARMUP), a dense video's device
    time, one view against the fp32 CPU forward."""
    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.models import build_recognizer
    cfg = Config.fromfile(CONFIGS_3D['i3d'])
    norm = dict(cfg.img_norm_cfg, device=True)
    for name, (backbone, width, frames, crop, batch) in NEW_3D.items():
        model_cfg = dict(
            type='Recognizer3D', backbone=backbone, dtype='bfloat16',
            cls_head=dict(type='I3DClsHead', spatial_size=-1,
                          temporal_size=-1, dropout_ratio=0.5,
                          in_channels=width, num_classes=400))
        cfg.model = dict(model_cfg)
        model = build_recognizer(dict(model_cfg),
                                 test_cfg=dict(average_clips=None))
        model.init_weights(torch.Generator().manual_seed(0),
                           randomize_bn=True)
        model.to('cuda')
        step = _family_step(model, cfg)
        gen = torch.Generator(device='cuda').manual_seed(0)
        shape = (batch, 1, frames, crop, crop, 3)
        batches = [(np.random.RandomState(s).randint(0, 256, shape,
                                                     dtype=np.uint8),
                    np.random.RandomState(100 + s).randint(0, 400, batch))
                   for s in range(TRAIN_WARMUP + TRAIN_STEPS)]
        losses = [step(*b, gen)['loss'].item()
                  for b in batches[:TRAIN_WARMUP]]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs = []
        for b in batches[TRAIN_WARMUP:]:
            t0 = time.perf_counter()
            losses.append(step(*b, gen)['loss'].item())
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del step
        model.eval()
        video = np.random.RandomState(2).randint(
            0, 256, (1, 30, frames, crop, crop, 3), dtype=np.uint8)
        rec = _int8_pass(name, model, video, norm, None, runs=1)
        for k in ('logits', 'fused', 'int8', 'rms_vs_reference'):
            rec.pop(k)
        one = _view_against_cpu(name, model, model_cfg, video[:, :1], norm)
        rec.update(kind='new_backbone', train_batch=list(shape),
                   loss=losses, step_ms=[s * 1e3 for s in secs],
                   median_step_ms=statistics.median(secs) * 1e3,
                   max_memory_allocated_gib=peak, one_view_vs_cpu_fp32=one,
                   card=card_line())
        print('family12: ' + json.dumps(rec))
        require(all(np.isfinite(losses)), f'{name}: losses {losses}')
        del model
        torch.cuda.empty_cache()


def _int8_kernel_records(counts):
    """(a) the int8 kernel at every distinct shape (b) and (d) launched,
    through ``tools/int8_bench.shape_record``: its int32 accumulators and
    both epilogues equal the plain version's (``torch.equal``, N cut to
    INT8_CHECK_N for the f64 plain version); its bare launch on operands
    prepared in its layouts (``ms``, the shape's epilogue; ``ms_int32``),
    the quantized modules' call to the wrapper (``wrapper_ms``), the plain
    version at the full shape, the bound (a strided 1x1 counts only the
    pixels it reads), ``torch._int_mm`` at the 1x1 stride-1 shapes
    (``library_ms``, int32 out) and cuDNN's bf16 ``channels_last`` conv
    (``bf16_ms``); the plan's variant and tile width."""
    from mvfnet_tpu_torch.tools import int8_bench
    total = collections.Counter()
    by_case = collections.defaultdict(dict)
    for case, c in counts.items():
        for k, n in c.items():
            total[k] += n
            by_case[k][case] = n
    records = []
    for i, (key, n) in enumerate(sorted(total.items(), key=str)):
        nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
        r = int8_bench.shape_record(key, 1000 + i, check_n=INT8_CHECK_N,
                                    plain=True)
        rec = dict(INT8_KERNEL, case=r['case'],
                   shape=dict(x=[nb, t, h, w, cin],
                              w=list(kernel) + [cin, cout],
                              stride=list(stride), padding=list(pad),
                              dilation=list(dil), epilogue=epi),
                   variant=r['variant'], tile_n=r['tile_n'], launches=n,
                   launches_by_case=by_case[key],
                   max_abs_err=r['max_abs_err'], equal=r['equal'],
                   check_n=r['check_n'], ms=r['ms'],
                   ms_int32=r['ms_int32'], wrapper_ms=r['wrapper_ms'],
                   plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                   bound_by=r['bound_by'], ops=r['ops'], bytes=r['bytes'],
                   share_of_bound=r['share_of_bound'],
                   library_ms=r['library_ms'], bf16_ms=r['bf16_ms'])
        if 'library_note' in r:
            rec['library_note'] = r['library_note']
        print('int8 kernel: ' + json.dumps(rec))
        require(rec['equal'], f'int8_conv {rec["case"]}: the kernel differs '
                              f'from its plain version')
        records.append(rec)
    return records


def phase_int8(root, ann):
    """Phase 12, the int8 eval path and the last two 3-D backbones, in
    ``root`` beside phase 5's videos and phase 10's checkpoints: returns
    the int8 kernel's records and the fused launches by case."""
    t0 = time.perf_counter()
    counts = {}
    fused = _int8_flagship(root, ann, counts)
    _int8_3d(root, counts)
    records = _int8_kernel_records(counts)
    _new_backbones()
    print(f'phase 12: {time.perf_counter() - t0:.3f} s')
    return records, fused


def _frame_paths(root, video, inds):
    return [os.path.join(root, f'video_{video}', f'img_{t + 1:05}.jpg')
            for t in inds]


def _decode_compare(root, loader):
    """(b) nvJPEG against cv2.imdecode on every frame of the set and on
    each JPEG kind; the ycc_to_bgr kernel's frames against its plain
    version on the planes nvJPEG decoded; a video's batch against its
    single decodes."""
    import tempfile

    import numpy as np
    import torch
    from mvfnet_tpu_torch.data import native_io
    from mvfnet_tpu_torch.tools.jpeg_kinds import (compare, cv2_decode, diff,
                                                   write_kinds)
    stats, single_equal, plain_equal = [], None, 0
    for v in range(DATA_VIDEOS):
        paths = _frame_paths(root, v, range(DATA_FRAMES))
        got = loader.load_batch_planes(paths)
        require(got is not None, f'nvJPEG refused a frame of video_{v}')
        got, planes = got
        for g, (y, cb, cr, hf, vf) in zip(got, planes):
            want = native_io.ycc_to_bgr_plain(
                *(None if p is None else torch.from_numpy(p).cuda()
                  for p in (y, cb, cr)), hf, vf)
            plain_equal += bool(np.array_equal(g, want.cpu().numpy()))
        stats += [diff(g, cv2_decode(p)) for p, g in zip(paths, got)]
        if v == 0:
            single_equal = all(np.array_equal(g, loader.load(p))
                               for p, g in zip(paths, got))
    with tempfile.TemporaryDirectory(dir=root) as d:
        kinds = compare(loader, write_kinds(d))
    frames = dict(max_abs=max(s['max_abs'] for s in stats),
                  mean_abs=statistics.mean(s['mean_abs'] for s in stats),
                  share_differ=statistics.mean(s['share_differ']
                                               for s in stats))
    print('decode: ' + json.dumps(dict(
        compare='nvjpeg vs cv2.imdecode', frames=len(stats),
        frame_stats=frames, kernel_equals_plain_frames=plain_equal,
        video_batch_equals_single=single_equal,
        kinds=kinds, bounds=dict(mean_abs=DECODE_MEAN_ABS,
                                 max_abs=DECODE_MAX_ABS),
        card=card_line())))
    require(single_equal, 'nvJPEG: a batch differs from its single decodes')
    require(plain_equal == len(stats),
            f'ycc_to_bgr: {len(stats) - plain_equal} of {len(stats)} decoded '
            f'frames differ from its plain version on their planes')
    for name, d in [('frames', frames)] + list(kinds.items()):
        require(d['mean_abs'] <= DECODE_MEAN_ABS
                and d['max_abs'] <= DECODE_MAX_ABS,
                f'nvJPEG vs cv2 on {name}: {d}')
        require(d.get('batch_equal', True), f'nvJPEG batch on {name}')


def _decode_ms(root, ann, loader):
    """(c) decode ms a frame over a dense-test video's frames (its
    SampleFrames: 10 clips x 8): nvJPEG batched, cv2 on one thread, and the
    4-thread loader with each (the test split with only its SampleFrames
    and FrameSelector)."""
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import (DataLoader, ShardedSampler,
                                       build_dataset, decode_counts)
    from mvfnet_tpu_torch.tools.jpeg_kinds import cv2_decode
    cfg = Config.fromfile(CONFIG)
    sample = dict(cfg.data['test']['pipeline'][0])
    require(sample['type'] == 'SampleFrames', f'first op {sample}')
    ds_cfg = dict(cfg.data['test'], ann_file=ann, data_root=root,
                  pipeline=[sample, dict(type='FrameSelector')])
    inds = build_dataset(dict(ds_cfg, pipeline=[sample]))[0]['frame_inds']
    clips = [_frame_paths(root, v, inds.reshape(-1))
             for v in range(DATA_VIDEOS)]
    n = sum(len(c) for c in clips)
    loader.load_batch(clips[0])                                # warm-up
    t0 = time.perf_counter()
    for c in clips:
        loader.load_batch(c)
    out = dict(frames=n, nvjpeg_batched=(time.perf_counter() - t0) * 1e3 / n)
    t0 = time.perf_counter()
    for c in clips:
        for p in c:
            cv2_decode(p)
    out['cv2_one_thread'] = (time.perf_counter() - t0) * 1e3 / n
    for name, device in (('nvjpeg', 'cuda'), ('cv2.imdecode', None)):
        dataset = build_dataset(dict(ds_cfg), device)
        batches = DataLoader(dataset, 1, ShardedSampler(
            len(dataset), shuffle=False), num_workers=4)
        list(batches)                                          # warm-up
        t0 = time.perf_counter()
        got = sum(len(b['img_group'][0]) for b in batches)
        out[f'loader_4_threads_{name}'] = (time.perf_counter() - t0) \
            * 1e3 / got
        out[f'loader_counts_{name}'] = decode_counts(dataset)
    print('decode ms a frame: ' + json.dumps(dict(out, card=card_line())))
    return out


def _decode_cli(root, ann):
    """(d) the test CLI on nvJPEG and on cv2 frames, with host and device
    normalization; returns the fused launches by case and the ycc_to_bgr
    kernel's launches, frames converted and decode calls (the
    ``decode.nvjpeg`` spans; every call of this set decodes) of each
    case."""
    import contextlib
    import io
    import pickle

    import numpy as np
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import native_io
    from mvfnet_tpu_torch.ops import fused_block as fb
    from mvfnet_tpu_torch.tools import test_recognizer as cli
    from mvfnet_tpu_torch.utils import tracing
    ckpt = os.path.join(root, 'mvf_r50_random.pth')
    sample = Config.fromfile(CONFIG).data['test']['pipeline'][0]
    frames = DATA_VIDEOS * sample['clip_len'] * sample['num_clips']
    expected = {('bfloat16',) + shape + (cm,): per_video * DATA_VIDEOS
                for _, shape, cm, per_video in FUSED_SHAPES if per_video}
    fused, ycc, rows, lines = {}, {}, {}, {}
    for norm in ('host_norm', 'device_norm'):
        for dec in ('nvjpeg', 'cv2'):
            case = f'{norm}_{dec}'
            config = write_config(root, ann, norm == 'device_norm',
                                  use_native=dec == 'nvjpeg')
            out = os.path.join(root, f'scores_decode_{case}.pkl')
            argv = [config, ckpt, '--fcn_testing', '--videos_per_gpu', '1',
                    '--out', out]
            torch.cuda.synchronize()
            fb.bottleneck_eval_cuda.launches = 0
            fb.bottleneck_eval_cuda.launches_by_shape.clear()
            native_io.ycc_to_bgr.launches = native_io.ycc_to_bgr.frames = 0
            tracing.clear()
            tracing.enable()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(io.StringIO()):
                    res = cli.main(argv)
                torch.cuda.synchronize()
            finally:
                tracing.disable()
            secs = time.perf_counter() - t0
            fused[case] = dict(fb.bottleneck_eval_cuda.launches_by_shape)
            ycc[case] = dict(launches=native_io.ycc_to_bgr.launches,
                             frames=native_io.ycc_to_bgr.frames,
                             decode_calls=sum(
                                 s['name'] == 'decode.nvjpeg'
                                 for s in tracing.collect()))
            tracing.clear()
            with open(out, 'rb') as f:
                rows[case] = np.stack(pickle.load(f))
            prof = device_profile(lambda: _quiet(cli.main, argv))
            require('busy_ms' in prof, f'decode {case} profile: {prof}')
            want_counts = {res['decoder']: frames}
            lines[case] = dict(
                case=case, decoder=res['decoder'],
                decode_counts=res['decode_counts'], pass_s=secs,
                videos_per_s=DATA_VIDEOS / secs,
                device_ms_per_video=prof['busy_ms'] / DATA_VIDEOS,
                device_idle_share=prof['idle_share'],
                fused_launches={'x'.join(map(str, k[1:])): v
                                for k, v in fused[case].items()},
                ycc_to_bgr=ycc[case])
            require(res['decoder'] == ('nvjpeg' if dec == 'nvjpeg'
                                       else 'cv2.imdecode'),
                    f'decode {case}: decoder {res["decoder"]}')
            require(res['decode_counts'] == want_counts,
                    f'decode {case}: frames decoded {res["decode_counts"]}, '
                    f'expected {want_counts}')
            require(fused[case] == expected,
                    f'decode {case}: fused launches {fused[case]}, '
                    f'expected {expected}')
            # every frame decoded on nvJPEG converted by the kernel, in one
            # launch a decode call
            require(ycc[case]['frames'] == (frames if dec == 'nvjpeg'
                                            else 0),
                    f'decode {case}: ycc_to_bgr converted '
                    f'{ycc[case]["frames"]} frames, not {frames}')
            require(ycc[case]['launches'] == ycc[case]['decode_calls'],
                    f'decode {case}: ycc_to_bgr launched '
                    f'{ycc[case]["launches"]} times in '
                    f'{ycc[case]["decode_calls"]} decode calls')
        err = float(np.abs(rows[f'{norm}_nvjpeg']
                           - rows[f'{norm}_cv2']).max())
        tol = DECODE_TOL * float(np.abs(rows[f'{norm}_cv2']).max())
        lines[f'{norm}_nvjpeg']['probs_vs_cv2_max_abs_err'] = err
        lines[f'{norm}_nvjpeg']['probs_tol'] = tol
        require(err <= tol, f'decode {norm}: nvJPEG vs cv2 probabilities '
                            f'{err} > {tol}')
    for line in lines.values():
        print('decode_cli: ' + json.dumps(dict(line, card=card_line())))
    return fused, ycc


def _tree_equal(a, b):
    import numpy as np
    if isinstance(b, dict):
        return isinstance(a, dict) and set(a) == set(b) and all(
            _tree_equal(a[k], b[k]) for k in b)
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and np.array_equal(a, b)


def _orbax(root):
    """(e) the flagship's state after two train steps through the Orbax
    step directory and back; (f) the committed JAX-written fixture against
    its ``.msgpack`` twin."""
    import tempfile

    import numpy as np
    import torch
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer,
                                               frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    from mvfnet_tpu_torch.utils import ocdbt, zstd
    from mvfnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   load_checkpoint_orbax,
                                                   load_optax_state,
                                                   save_checkpoint_orbax)
    cfg, model_for, _ = _flagship_state()
    schedule = build_lr_schedule(cfg.lr_config, cfg.optimizer['lr'],
                                 ITERS_PER_EPOCH, cfg.total_epochs)

    def trained(steps):
        model = model_for().to('cuda')
        opt = build_optimizer(
            model, cfg.optimizer, schedule,
            grad_clip=cfg.optimizer_config['grad_clip'],
            frozen_prefixes=frozen_prefixes_from_backbone(
                cfg.model['backbone']))
        step = make_train_step(model, opt, schedule,
                               norm_cfg=dict(cfg.img_norm_cfg, device=True))
        rs = np.random.RandomState(0)
        for i in range(steps):
            step(rs.randint(0, 256, TRAIN_BATCH, dtype=np.uint8),
                 rs.randint(0, 400, TRAIN_BATCH[0]),
                 torch.Generator(device='cuda').manual_seed(i))
        torch.cuda.synchronize()
        return model, opt

    model, opt = trained(2)
    meta = {'epoch': 0, 'iter': 2}
    with tempfile.TemporaryDirectory(dir=root) as d:
        t0 = time.perf_counter()
        nbytes = save_checkpoint_orbax(d, model, opt, meta, step=2)
        save_s = time.perf_counter() - t0
        files = sum(len(fs) for _, _, fs in os.walk(d))
        t0 = time.perf_counter()
        sd, opt_state, got_meta = load_checkpoint_orbax(d, 2)
        load_s = time.perf_counter() - t0
    want = {k: v.cpu() for k, v in model.state_dict().items()}
    weights_equal = all(torch.equal(sd[k], want[k]) and
                        sd[k].dtype == want[k].dtype
                        for k in want if not k.endswith('num_batches_tracked'))
    fresh, fresh_opt = trained(0)
    load_optax_state(fresh, fresh_opt, opt_state, 2)
    momentum_equal = all(
        torch.equal(opt.state[p]['momentum_buffer'],
                    fresh_opt.state[q]['momentum_buffer'])
        for p, q in zip(model.parameters(), fresh.parameters())
        if p in opt.state)
    buffers = sum(p in opt.state for p in model.parameters())

    t0 = time.perf_counter()
    g_sd, g_opt, g_meta = load_checkpoint_orbax(
        os.path.join(GOLDEN_ORBAX, 'orbax'), GOLDEN_STEP)
    golden_s = time.perf_counter() - t0
    # the zstd decoder on the chunks tensorstore compressed
    store = ocdbt.Store(os.path.join(GOLDEN_ORBAX, 'orbax',
                                     f'step_{GOLDEN_STEP}'))
    chunks = [store.get(k) for k in store.keys()
              if not k.endswith('.zarray')]
    t0 = time.perf_counter()
    zstd_out = sum(len(zstd.decompress(c)) for c in chunks)
    zstd_s = time.perf_counter() - t0
    t_sd, t_opt, t_meta = load_checkpoint(
        os.path.join(GOLDEN_ORBAX, 'orbax_twin.msgpack'))
    golden_equal = (set(g_sd) == set(t_sd) and all(
        torch.equal(g_sd[k], t_sd[k]) for k in t_sd)
        and _tree_equal(g_opt, t_opt) and g_meta == t_meta)
    print('orbax: ' + json.dumps(dict(
        state='flagship after 2 train steps', mb=nbytes / 1e6, files=files,
        save_s=save_s, load_s=load_s, write_mb_per_s=nbytes / 1e6 / save_s,
        read_mb_per_s=nbytes / 1e6 / load_s, weights_equal=weights_equal,
        momentum_buffers=buffers, momentum_equal=momentum_equal,
        meta_equal=got_meta == meta, golden_fixture_equal=golden_equal,
        golden_read_s=golden_s, golden_keys=len(g_sd),
        zstd_in_mb=sum(map(len, chunks)) / 1e6, zstd_out_mb=zstd_out / 1e6,
        zstd_mb_per_s=zstd_out / 1e6 / zstd_s, card=card_line())))
    require(weights_equal and got_meta == meta,
            'Orbax round trip: the weights differ')
    require(momentum_equal and buffers > 100,
            f'Orbax round trip: momentum ({buffers} buffers) differs')
    require(golden_equal, 'the JAX-written Orbax fixture differs from its '
                          '.msgpack twin')
    del model, opt, fresh, fresh_opt
    torch.cuda.empty_cache()


def _ycc_record(launches):
    """The ycc_to_bgr kernel on a decode call's frames at the set's size (a
    dense-test video's 80 frames, 4:2:0 as cv2 writes them) against its
    plain version on the card: ``tools/ycc_bench.record``'s device time
    from the profiler, CUDA events over back-to-back launches and a CUDA
    graph's replays, and the bound (bytes: the planes read, BGR written;
    some 20 integer operations a pixel on the 67 TFLOP/s of the non-tensor
    units take less); the wrapper's and the plain version's event times;
    the same for one frame."""
    import torch
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import native_io as nio
    from mvfnet_tpu_torch.tools import ycc_bench
    sample = Config.fromfile(CONFIG).data['test']['pipeline'][0]
    n = sample['clip_len'] * sample['num_clips']
    frames = ycc_bench.planes(n, *DATA_HW)
    lib = nio.library()
    before = (nio.ycc_to_bgr.launches, nio.ycc_to_bgr.frames)
    bench = ycc_bench.record('committed', lib, frames, runs=50)
    batch = [f + (2, 2) for f in frames]
    got = nio.ycc_to_bgr_batch(batch)
    err = max(int((g.int() - w.int()).abs().max()) for g, w in
              zip(got, nio.ycc_to_bgr_batch_plain(batch)))
    ms = median_ms(lambda: nio.ycc_to_bgr_batch(batch))
    plain_ms = median_ms(lambda: nio.ycc_to_bgr_batch_plain(batch), runs=5)
    one = batch[:1]
    one_bench = ycc_bench.record('committed', lib, frames[:1], runs=50)
    one_frame = dict(
        shape=list(DATA_HW) + [2, 2], device_ms=one_bench['device_ms'],
        event_ms=one_bench['event_ms'], graph_ms=one_bench['graph_ms'],
        ms=median_ms(lambda: nio.ycc_to_bgr_batch(one)),
        plain_ms=median_ms(lambda: nio.ycc_to_bgr_batch_plain(one)),
        bound_ms=one_bench['bound_ms'])
    # comparisons do not count
    nio.ycc_to_bgr.launches, nio.ycc_to_bgr.frames = before
    torch.cuda.synchronize()
    require(err == 0 and bench['equal'] and one_bench['equal'],
            f'ycc_to_bgr vs plain: max abs err {err}, bench equal '
            f'{bench["equal"]}, one frame {one_bench["equal"]}')
    case = launches['device_norm_nvjpeg']
    return dict(YCC_KERNEL, shape=[n] + list(DATA_HW) + [2, 2],
                launches=case['launches'], frames=case['frames'],
                launches_decode=launches, max_abs_err=err, ms=ms,
                device_ms=bench['device_ms'],
                device_span_ms=bench['device_span_ms'],
                event_ms=bench['event_ms'], graph_ms=bench['graph_ms'],
                plain_ms=plain_ms, bound_ms=bench['bound_ms'],
                bound_by='bytes', share_of_bound=bench['share_of_bound'],
                library_ms=None, one_frame=one_frame, card=card_line())


def phase_decode(root, ann):
    """Phase 13 on phase 5's rawframe set; returns the ycc_to_bgr kernel's
    record and the fused launches of (d) by case."""
    from mvfnet_tpu_torch.data.native_io import NativeImageLoader
    t0 = time.perf_counter()
    loader = NativeImageLoader('cuda')
    _decode_compare(root, loader)
    _decode_ms(root, ann, loader)
    fused, ycc = _decode_cli(root, ann)
    record = _ycc_record(ycc)
    _orbax(root)
    print(f'phase 13: {time.perf_counter() - t0:.3f} s')
    return record, fused


def phase_rawframes():
    """Phases 5-8 on one rawframe dataset in a temporary directory, then
    phase 9 on the same frames as video files and phases 10-13 on the
    same frames again; returns their fused-kernel launches by case (and
    shape but in phase 10, which counts them all), phase 12's int8 kernel
    records and phase 13's ycc_to_bgr record."""
    import tempfile

    import cv2
    print('host: ' + json.dumps(host_census()))
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        ann, frame_bytes = write_dataset(root)
        print(f'data set: {DATA_VIDEOS} videos x {DATA_FRAMES} frames of '
              f'{DATA_HW[1]}x{DATA_HW[0]}, mean JPEG {frame_bytes:.0f} bytes, '
              f'written in {time.perf_counter() - t0:.3f} s with cv2 '
              f'{cv2.__version__}')
        data_launches = phase_data(root, ann)
        train_launches, resumed_losses = phase_train_cli(root)
        feature_launches = phase_entry_points(root, ann, resumed_losses)
        dist_launches = phase_dist(root, ann)
        video_launches = phase_video(root)
        launches_3d = phase_3d(root)
        launches_2d = phase_family(root, ann)
        int8_records, launches_int8 = phase_int8(root, ann)
        ycc_record, launches_decode = phase_decode(root, ann)
        return (data_launches, train_launches, feature_launches,
                dist_launches, video_launches, launches_3d, launches_2d,
                int8_records, launches_int8, ycc_record, launches_decode)


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
        (data_launches, train_launches, feature_launches,
         dist_launches, video_launches, launches_3d,
         launches_2d, int8_records, launches_int8, ycc_record,
         launches_decode) = phase_rawframes()
        for r in records:
            key = (r['dtype'],) + tuple(r['shape'])
            r['launches'] = launches.get(key, 0)
            r['launches_cli'] = {case: n.get(key, 0)
                                 for case, n in data_launches.items()}
            r['launches_train_cli'] = {case: n.get(key, 0)
                                       for case, n in train_launches.items()}
            r['launches_features'] = feature_launches.get(key, 0)
            r['launches_dist'] = {case: [n.get(key, 0) for n in ranks]
                                  for case, ranks in dist_launches.items()}
            r['launches_video'] = {case: n.get(key, 0)
                                   for case, n in video_launches.items()}
            # the 3-D paths launch no fused kernel at any shape
            r['launches_3d'] = dict(launches_3d)
            r['launches_2d'] = {case: n.get(key, 0)
                                for case, n in launches_2d.items()}
            r['launches_int8'] = {case: n.get(key, 0)
                                  for case, n in launches_int8.items()}
            r['launches_decode'] = {case: n.get(key, 0)
                                    for case, n in launches_decode.items()}
        records += int8_records + [ycc_record]
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
    sys.exit(rank_cli(sys.argv[2:]) if sys.argv[1:2] == ['--rank']
             else main())
