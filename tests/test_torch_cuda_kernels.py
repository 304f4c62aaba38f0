"""The port's CUDA kernels against their plain PyTorch versions on the card
(the fused bottleneck, and the int8 convolution bit for bit at the int8
path's kinds of shape), a small quantized R50+MVF in bf16 that must launch
the int8 kernel and no fused one, a small train step that must not launch them, a bf16 train loop epoch whose
mid-train evaluation must, a feature-extraction pass that must, the eval
loop's pinned-memory prefetch, the synced BatchNorm on 2-D and 3-D maps,
and a small I3D in bf16 that must match the CPU and launch no kernel.

Every test here carries the ``cuda`` marker and skips without a GPU. This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch (the repository's ``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mvfnet_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from mvfnet_tpu_torch.engine.train_step import make_eval_step, make_train_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.ops import fused_block as fb
from mvfnet_tpu_torch.ops import int8_conv as q8

pytestmark = pytest.mark.cuda

# (N, H, W, Cin), Cm: the JAX suite's shapes (general kernel), shapes
# that take the tiled bf16 kernel at the edges of its strip walk: H and W
# not multiples of its tile, H not a multiple of the strip or the step
# (a ragged last step), H = 1, and H below the step with W ragged; the
# two shapes of the train loop's evaluation (8 frames at 224^2); and the
# 4x16 video recipe's: its dense test (3 crops x 10 clips x 4 frames at
# 256^2) and its train CLI's evaluation (4 frames at 224^2)
SHAPES = [((2, 8, 8, 32), 16), ((1, 6, 10, 24), 8), ((3, 13, 11, 128), 64),
          ((160, 37, 20, 128), 64), ((1, 1, 64, 256), 64),
          ((2, 3, 9, 192), 128), ((8, 56, 56, 256), 64),
          ((8, 28, 28, 512), 128), ((120, 64, 64, 256), 64),
          ((120, 32, 32, 512), 128), ((4, 56, 56, 256), 64),
          ((4, 28, 28, 512), 128)]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (chip_smoke.py makes the same '
                    'checks on the card)')
    # cuDNN's float32 convs default to TF32; the plain version must not
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)


def _inputs(shape, cm, dtype):
    cin = shape[-1]
    sizes = [shape, (cin, cm), (1, cm), (3, 3, cm, cm), (1, cm), (cm, cin),
             (1, cin)]
    arrs = [torch.from_numpy(np.random.RandomState(i).randn(*s) * 0.2)
            .float().cuda() for i, s in enumerate(sizes)]
    x, w1, b1, w2, b2, w3, b3 = arrs
    return x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype), b3


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,cm', SHAPES)
def test_fused_bottleneck_matches_plain(cuda, shape, cm, dtype):
    args = _inputs(shape, cm, getattr(torch, dtype))
    key = (dtype,) + shape + (cm,)
    n, h, w, cin = shape
    if dtype == 'bfloat16' and cin % 64 == 0 and cm % 64 == 0:
        assert fb.kernel_path(torch.bfloat16, h, w, cin, cm) == 'tiled'
    before = (fb.bottleneck_eval_cuda.launches,
              fb.bottleneck_eval_cuda.launches_by_shape[key])
    got = fb.bottleneck_eval(*args).float()
    torch.cuda.synchronize()
    assert (fb.bottleneck_eval_cuda.launches,
            fb.bottleneck_eval_cuda.launches_by_shape[key]) == (
                before[0] + 1, before[1] + 1)
    want = fb.bottleneck_eval_plain(*args).float()
    ref = want.abs().max().item()
    # f32: fp32 sums in another order; bf16: the plain version rounds each
    # conv output to bf16 before its bias, the kernel after (about one ulp)
    tol = 1e-5 * (1 + ref) if dtype == 'float32' else 1e-2 * ref
    assert (got - want).abs().max().item() <= tol


def test_fused_bottleneck_raises_on_what_it_does_not_take(cuda):
    x, w1, b1, w2, b2, w3, b3 = _inputs(*SHAPES[0], torch.float32)
    half = [t.half() for t in (x, w1, w2, w3)]
    with pytest.raises(TypeError, match='bfloat16 or float32'):
        fb.bottleneck_eval(half[0], half[1], b1, half[2], b2, half[3], b3)
    with pytest.raises(ValueError, match='contiguous NHWC'):
        fb.bottleneck_eval(x.transpose(1, 2), w1, b1, w2, b2, w3, b3)
    with pytest.raises(TypeError, match='weights must be in x.dtype'):
        fb.bottleneck_eval(x, w1.bfloat16(), b1, w2, b2, w3, b3)


def test_train_steps_launch_no_fused_kernel_and_eval_does(cuda):
    """Two bf16 train steps of a small R50+MVF on the card: finite metrics
    and no fused launch; then eval of the trained model launches it."""
    t, classes = 4, 10
    model = build_recognizer(dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=50, out_indices=(3,),
                      norm_eval=False),
        cls_head=dict(type='TSNClsHead', spatial_type='avg',
                      dropout_ratio=0.5, in_channels=2048, init_std=0.01,
                      num_classes=classes),
        module_cfg=dict(type='MVF', n_segment=t, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'),
        dtype='bfloat16'), test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0))
    sched = build_lr_schedule(dict(policy='step', step=[10]), 0.01, 1, 1)
    opt = build_optimizer(model, dict(type='SGD', lr=0.01, momentum=0.9,
                                      weight_decay=1e-4, nesterov=True),
                          sched, grad_clip=dict(max_norm=40))
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True, device=True)
    step = make_train_step(model, opt, sched, norm_cfg=norm)
    rng = np.random.RandomState(0)
    gen = torch.Generator(device='cuda').manual_seed(0)
    before = fb.bottleneck_eval_cuda.launches
    for _ in range(2):
        m = step(rng.randint(0, 256, (2, t, 64, 64, 3), dtype=np.uint8),
                 rng.randint(0, classes, 2), gen)
        assert torch.isfinite(m['loss']) and torch.isfinite(m['grad_norm'])
        assert m['loss'].dtype == torch.float32
    assert fb.bottleneck_eval_cuda.launches == before
    assert model.backbone.conv1.weight.dtype == torch.float32
    assert model.backbone.conv1.weight.grad.dtype == torch.float32

    scores = make_eval_step(model, norm_cfg=norm)(
        model, rng.randint(0, 256, (1, 2 * t, 64, 64, 3), dtype=np.uint8))
    torch.cuda.synchronize()
    assert scores.shape == (2, classes)
    assert bool(torch.isfinite(scores).all())
    # layer1.1-2 and layer2.1-3
    assert fb.bottleneck_eval_cuda.launches == before + 5


@pytest.mark.parametrize('option', ['gn', 'avd'])
def test_gn_and_avd_blocks_do_not_launch_the_kernel(cuda, option,
                                                   monkeypatch):
    """bf16 eval of two-stage R50s on the card: GroupNorm blocks take the
    plain path (no running statistics to fold), so the GN model launches
    nothing; the avd block (layer2.0, stride 2) is not fused either, so the
    avd model launches at layer1.1-2 and layer2.1-3 alone, as the plain
    model does. Scores finite and within 3e-2 of max|logit| of the plain
    path."""
    backbone = dict(type='ResNet', depth=50, num_stages=2, out_indices=(1,),
                    norm_eval=False)
    if option == 'gn':
        backbone['norm_cfg'] = dict(type='GN', num_groups=8)
    else:
        backbone.update(avd=True, avg_down=True)
    model = build_recognizer(dict(
        type='Recognizer2D', backbone=backbone,
        cls_head=dict(type='TSNClsHead', spatial_type='avg',
                      dropout_ratio=0.5, in_channels=512, init_std=0.01,
                      num_classes=10), dtype='bfloat16'),
        test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    step = make_eval_step(model)
    x = np.random.RandomState(0).randn(1, 4, 64, 64, 3).astype(np.float32)
    fb.bottleneck_eval_cuda.launches_by_shape.clear()
    got = step(model, x).float()
    torch.cuda.synchronize()
    launches = dict(fb.bottleneck_eval_cuda.launches_by_shape)
    monkeypatch.setattr(fb, 'bottleneck_eval', fb.bottleneck_eval_plain)
    want = step(model, x).float()
    assert bool(torch.isfinite(got).all())
    assert (got - want).abs().max().item() <= 3e-2 * want.abs().max().item()
    if option == 'gn':
        assert launches == {}
    else:
        assert launches == {('bfloat16', 4, 16, 16, 256, 64): 2,
                            ('bfloat16', 4, 8, 8, 512, 128): 3}


def test_train_loop_epoch_in_bf16_evaluates_through_the_kernel(cuda,
                                                               tmp_path):
    """One bf16 epoch of the train loop on 4 tiny rawframe videos (uint8
    frames normalized on the card), then its EvalHook pass: finite losses,
    a checkpoint, and 2 + 3 fused launches per val video, none while
    training."""
    import cv2
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset
    from mvfnet_tpu_torch.engine.train_loop import Hook, train_network
    rng = np.random.RandomState(0)
    for v in range(4):
        (tmp_path / f'v{v}').mkdir()
        for f in range(8):
            cv2.imwrite(str(tmp_path / f'v{v}' / f'img_{f + 1:05}.jpg'),
                        rng.randint(0, 255, (48, 48, 3), np.uint8))
    ann = tmp_path / 'ann.txt'
    ann.write_text(''.join(f'v{v} 8 {v % 2}\n' for v in range(4)))
    norm = dict(type='Normalize', mean=[123.675, 116.28, 103.53],
                std=[58.395, 57.12, 57.375], to_rgb=True, device=True)

    def split(crop, test_mode):
        return dict(type='RawFramesDataset', ann_file=str(ann),
                    data_root=str(tmp_path), test_mode=test_mode,
                    pipeline=[dict(type='SampleFrames', clip_len=2,
                                   frame_interval=2, num_clips=1),
                              dict(type='FrameSelector'), crop, norm,
                              dict(type='FormatShape', input_format='NHWC'),
                              dict(type='Collect', keys=['img_group',
                                                         'label'],
                                   meta_keys=[])])
    cfg = Config(dict(
        model=dict(type='Recognizer2D',
                   backbone=dict(type='ResNet', depth=50, out_indices=(3,),
                                 norm_eval=False),
                   cls_head=dict(type='TSNClsHead', spatial_type='avg',
                                 dropout_ratio=0.5, in_channels=2048,
                                 init_std=0.01, num_classes=2),
                   module_cfg=dict(type='MVF', n_segment=2, alpha=0.125,
                                   mvf_freq=(0, 0, 1, 1), mode='THW')),
        data=dict(videos_per_gpu=2, workers_per_gpu=2,
                  train=split(dict(type='RandomResizedCrop', input_size=64),
                              False),
                  val=split(dict(type='Resize', scale=(64, 64),
                                 keep_ratio=False), True)),
        optimizer=dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
                       nesterov=True),
        optimizer_config=dict(grad_clip=dict(max_norm=40)),
        lr_config=dict(policy='step', step=[10]), total_epochs=1,
        checkpoint_config=dict(interval=1), log_config=dict(interval=1),
        eval_interval=1, work_dir=str(tmp_path / 'work')))
    losses, train_launches = [], []

    class Watch(Hook):
        def after_iter(self, loop, metrics):
            losses.append(metrics['loss'].item())
            train_launches.append(fb.bottleneck_eval_cuda.launches)

    model = build_recognizer(dict(cfg.model, dtype='bfloat16'),
                             test_cfg=dict(average_clips='prob'))
    before = dict(fb.bottleneck_eval_cuda.launches_by_shape)
    start = fb.bottleneck_eval_cuda.launches
    loop = train_network(model, build_dataset(dict(cfg.data.train)), cfg,
                         validate=True, extra_hooks=[Watch()])
    torch.cuda.synchronize()
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert train_launches == [start, start]
    assert (tmp_path / 'work' / 'epoch_1.pth').exists()
    assert loop.stager.uploads == 2 and loop.stager._bufs[0].dtype == \
        torch.uint8
    grown = {k: v - before.get(k, 0) for k, v in
             fb.bottleneck_eval_cuda.launches_by_shape.items()
             if v != before.get(k, 0)}
    assert grown == {('bfloat16', 2, 16, 16, 256, 64): 2 * 4,
                     ('bfloat16', 2, 8, 8, 512, 128): 3 * 4}
    assert loop.eval_history[0]['scores'].shape == (4, 2)


def test_feature_pass_launches_the_kernel_and_matches_plain(cuda, tmp_path,
                                                           monkeypatch):
    """``evaluate_dataset(extract_feat=True)`` of a bf16 R50+MVF with
    ``fcn_testing`` on 3 tiny rawframe videos (uint8 frames normalized on
    the card): one row of 2 clip volumes x 2048 a video, 2 + 3 fused
    launches a video, and features within 3e-2 of the largest of the same
    pass with the kernel's plain version."""
    import cv2
    from mvfnet_tpu_torch.data import build_dataset
    from mvfnet_tpu_torch.engine.eval import evaluate_dataset
    rng = np.random.RandomState(1)
    for v in range(3):
        (tmp_path / f'v{v}').mkdir()
        for f in range(8):
            cv2.imwrite(str(tmp_path / f'v{v}' / f'img_{f + 1:05}.jpg'),
                        rng.randint(0, 255, (64, 80, 3), np.uint8))
    (tmp_path / 'ann.txt').write_text(
        ''.join(f'v{v} 8 {v}\n' for v in range(3)))
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True, device=True)
    dataset = build_dataset(dict(
        type='RawFramesDataset', ann_file=str(tmp_path / 'ann.txt'),
        data_root=str(tmp_path), test_mode=True, pipeline=[
            dict(type='SampleFrames', clip_len=2, frame_interval=2,
                 num_clips=2),
            dict(type='FrameSelector'),
            dict(type='Resize', scale=(64, 64), keep_ratio=False),
            dict(type='Normalize', **norm),
            dict(type='FormatShape', input_format='NHWC'),
            dict(type='Collect', keys=['img_group', 'label'],
                 meta_keys=[])]))
    model = build_recognizer(dict(
        type='Recognizer2D', fcn_testing=True,
        backbone=dict(type='ResNet', depth=50, out_indices=(3,),
                      norm_eval=False),
        cls_head=dict(type='TSNClsHead', spatial_type='avg',
                      dropout_ratio=0.5, in_channels=2048, init_std=0.01,
                      num_classes=3, extract_feat=True),
        module_cfg=dict(type='MVF', n_segment=2, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'),
        dtype='bfloat16'), test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    before = dict(fb.bottleneck_eval_cuda.launches_by_shape)
    feats = evaluate_dataset(model, dataset, extract_feat=True,
                             norm_cfg=norm)
    grown = {k: v - before.get(k, 0) for k, v in
             fb.bottleneck_eval_cuda.launches_by_shape.items()
             if v != before.get(k, 0)}
    assert grown == {('bfloat16', 4, 16, 16, 256, 64): 2 * 3,
                     ('bfloat16', 4, 8, 8, 512, 128): 3 * 3}
    assert feats.shape == (3, 2 * 2048) and np.isfinite(feats).all()
    monkeypatch.setattr(fb, 'bottleneck_eval', fb.bottleneck_eval_plain)
    plain = evaluate_dataset(model, dataset, extract_feat=True,
                             norm_cfg=norm)
    assert np.abs(feats - plain).max() <= 3e-2 * np.abs(plain).max()


def test_prefetch_stages_through_two_pinned_buffers(cuda):
    """Batches reach the card intact, through two pinned buffers reused in
    turn (a smaller last batch uses their leading rows; another frame
    shape reallocates them), and the counters add up."""
    from mvfnet_tpu_torch.engine.prefetch import (PinnedStager,
                                                  prefetch_to_device)
    rng = np.random.RandomState(0)
    arrays = [rng.randint(0, 256, (n, 5, 7, 3), dtype=np.uint8)
              for n in (3, 3, 3, 2)] + [rng.rand(2, 4).astype(np.float32)]
    stager = PinnedStager(torch.device('cuda'))
    got, bufs = [], []
    for t in prefetch_to_device(arrays, 'cuda', stager):
        assert t.device.type == 'cuda'
        bufs.append(tuple(b.data_ptr() for b in stager._bufs))
        got.append((t + 0).cpu().numpy())   # work on the current stream
    for g, a in zip(got, arrays):
        np.testing.assert_array_equal(g, a)
    assert all(b.is_pinned() for b in stager._bufs)
    assert len(set(bufs[:3])) == 1 and bufs[3] != bufs[0]
    assert stager.uploads == len(arrays)
    assert stager.bytes_uploaded == sum(a.nbytes for a in arrays)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_synced_batchnorm_on_nccl_matches_plain(cuda, dtype):
    """The port's synced BatchNorm in a one-rank NCCL group against the
    plain one on the same input: output, input, weight and bias gradients
    and running statistics (statistics in fp32 either way; bf16 output is
    rounded once, so bf16 is held to its resolution)."""
    _synced_batchnorm_case(dtype, (12, 64, 28, 28), torch.channels_last)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_synced_batchnorm_3d_on_nccl_matches_plain(cuda, dtype):
    """The same on the 3-D families' NCTHW volumes in
    ``channels_last_3d`` (the I3D config's ``BN3d``)."""
    _synced_batchnorm_case(dtype, (4, 64, 4, 14, 14),
                           torch.channels_last_3d)


def _synced_batchnorm_case(dtype, shape, memory_format):
    import torch.distributed as dist
    from mvfnet_tpu_torch.models.common import BatchNorm, set_sync_group
    from mvfnet_tpu_torch.parallel import free_port
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:'
                            f'{free_port()}', world_size=1, rank=0)
    try:
        dt = getattr(torch, dtype)
        gen = torch.Generator().manual_seed(0)
        x = (torch.randn(*shape, generator=gen) * 2 + 0.5).cuda()
        g = torch.randn(*shape, generator=gen).cuda().to(dt)
        weight = torch.rand(64, generator=gen) + 0.5
        bias = torch.rand(64, generator=gen) - 0.5
        out = []
        for sync in (False, True):
            bn = BatchNorm(64).cuda()
            with torch.no_grad():
                bn.weight.copy_(weight)
                bn.bias.copy_(bias)
            set_sync_group(bn, dist.group.WORLD if sync else None)
            xi = x.to(dt).contiguous(memory_format=memory_format)
            xi.requires_grad_()
            y = bn(xi)
            assert y.dtype == dt
            (y.float() * g.float()).sum().backward()
            out.append([t.float() for t in (
                y, xi.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
                bn.running_var)])
        # relative to each tensor's largest value: fp32 sums in another
        # order; bf16 results one rounding (2^-8) apart at most
        tol = dict(float32=1e-4, bfloat16=2e-2)[dtype]
        names = ('y', 'dx', 'dw', 'db', 'running_mean', 'running_var')
        for name, a, b in zip(names, *out):
            scale = a.abs().max().item()
            err = (a - b).abs().max().item()
            assert err <= tol * scale, (name, err, scale)
    finally:
        dist.destroy_process_group()


def test_i3d_on_the_card_matches_fp32_cpu_and_launches_no_kernel(cuda):
    """A small I3D (the I3D config's backbone, ResNet-18 on two stages) in
    bf16 on the card: eval logits within 3e-2 of max|logit| of the same
    weights' fp32 forward on the CPU, and a finite train step; the 2-D
    fused kernel launches in neither."""
    cfg = dict(type='Recognizer3D', backbone=dict(
        type='ResNet_I3D', depth=18, num_stages=2, out_indices=(1,),
        conv1_kernel=(5, 7, 7), conv1_stride_t=2, pool1_stride_t=2,
        norm_eval=False, norm_cfg=dict(type='BN3d')),
        cls_head=dict(type='I3DClsHead', in_channels=128, num_classes=7,
                      dropout_ratio=0.5))
    model = build_recognizer(dict(cfg, dtype='bfloat16'),
                             test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    cpu = build_recognizer(dict(cfg, dtype='float32'),
                           test_cfg=dict(average_clips=None))
    cpu.load_state_dict(model.state_dict())
    x = np.random.RandomState(1).randint(0, 256, (2, 3, 8, 64, 64, 3),
                                         dtype=np.uint8)
    norm = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
                to_rgb=True, device=True)
    want = make_eval_step(cpu, norm, device='cpu')(cpu, x)
    fb.bottleneck_eval_cuda.launches = 0
    got = make_eval_step(model, norm)(model, x).float().cpu()
    assert got.shape == want.shape == (6, 7)
    err = (got - want).abs().max().item()
    assert err <= 3e-2 * want.abs().max().item(), err
    sched = build_lr_schedule(dict(policy='cosine'), 0.01, 10, 1)
    opt = build_optimizer(model, dict(type='SGD', lr=0.01, momentum=0.9),
                          sched)
    step = make_train_step(model, opt, sched, norm_cfg=norm)
    m = step(x[:, :1], np.arange(2), torch.Generator(device='cuda'))
    assert np.isfinite(m['loss'].item()) and np.isfinite(
        m['grad_norm'].item())
    assert fb.bottleneck_eval_cuda.launches == 0


# (x (N, T, H, W, Cin), w (kt, kh, kw, Cout), stride, padding before and
# after each axis, dilation): 1x1s, a strided 3x3, a dilated one, the 7x7
# stem (Cin 3: the byte gather, K = 147), a ragged Cout and M, X3D's Cin of
# 54, and the 3-D kinds (temporal, spatial, full, strided pointwise)
INT8_SHAPES = [
    ((2, 1, 16, 16, 64), (1, 1, 1, 256), (1, 1, 1), ((0, 0),) * 3,
     (1, 1, 1)),
    ((3, 1, 9, 11, 256), (1, 3, 3, 64), (1, 2, 2),
     ((0, 0), (1, 1), (1, 1)), (1, 1, 1)),
    ((1, 1, 12, 12, 128), (1, 3, 3, 96), (1, 1, 1),
     ((0, 0), (2, 2), (2, 2)), (1, 2, 2)),
    ((2, 1, 33, 30, 3), (1, 7, 7, 64), (1, 2, 2),
     ((0, 0), (3, 3), (3, 3)), (1, 1, 1)),
    ((1, 1, 7, 5, 32), (1, 1, 1, 70), (1, 1, 1), ((0, 0),) * 3,
     (1, 1, 1)),
    ((2, 4, 8, 8, 54), (1, 1, 1, 24), (1, 1, 1), ((0, 0),) * 3,
     (1, 1, 1)),
    ((1, 6, 10, 10, 64), (3, 1, 1, 64), (2, 1, 1),
     ((1, 1), (0, 0), (0, 0)), (1, 1, 1)),
    ((1, 4, 10, 10, 64), (1, 3, 3, 128), (1, 2, 2),
     ((0, 0), (1, 1), (1, 1)), (1, 1, 1)),
    ((1, 4, 8, 8, 32), (3, 3, 3, 64), (1, 1, 1), ((1, 1),) * 3,
     (1, 1, 1)),
    ((2, 4, 8, 8, 128), (1, 1, 1, 256), (1, 2, 2), ((0, 0),) * 3,
     (1, 1, 1)),
]


@pytest.mark.parametrize('case', range(len(INT8_SHAPES)))
def test_int8_conv_equals_plain(cuda, case):
    """The kernel's int32 accumulators, and its bf16 and f32 epilogues,
    equal the plain version's bit for bit."""
    xs, ws, stride, padding, dilation = INT8_SHAPES[case]
    rng = np.random.RandomState(case)
    x = torch.from_numpy(rng.randint(-127, 128, xs).astype(np.int8)).cuda()
    w = torch.from_numpy(rng.randint(-127, 128, ws[:3] + (xs[-1], ws[3]))
                         .astype(np.int8)).cuda()
    scale = torch.from_numpy(rng.rand(ws[3]).astype(np.float32) * 1e-4 +
                             1e-6).cuda()
    bias = torch.from_numpy(rng.randn(ws[3]).astype(np.float32)).cuda()
    before = q8.int8_conv_cuda.launches
    got = q8.int8_conv(x, w, stride, padding, dilation)
    torch.cuda.synchronize()
    assert q8.int8_conv_cuda.launches == before + 1
    want = q8.int8_conv_plain(x, w, stride, padding, dilation)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    for dtype, b in ((torch.bfloat16, bias), (torch.float32, None)):
        got = q8.int8_conv(x, w, stride, padding, dilation, scale, b, dtype)
        want = q8.int8_conv_plain(x, w, stride, padding, dilation, scale, b,
                                  dtype)
        assert got.dtype == dtype and torch.equal(got, want)


def test_int8_conv_raises_on_what_it_does_not_take(cuda):
    x = torch.zeros(1, 1, 4, 4, 8, dtype=torch.int8, device='cuda')
    w = torch.zeros(1, 1, 1, 8, 8, dtype=torch.int8, device='cuda')
    one = ((0, 0),) * 3
    with pytest.raises(TypeError, match='int8 operands'):
        q8.int8_conv(x.float(), w, (1, 1, 1), one, (1, 1, 1))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        q8.int8_conv(x, w, (1, 1, 1), one, (1, 1, 1),
                     torch.ones(8, device='cuda'), None, torch.float16)
    big = torch.zeros(3, 3, 3, 5000, 8, dtype=torch.int8, device='cuda')
    with pytest.raises(ValueError, match='overflow'):
        q8.int8_conv(torch.zeros(1, 4, 4, 4, 5000, dtype=torch.int8,
                                 device='cuda'), big, (1, 1, 1),
                     ((1, 1),) * 3, (1, 1, 1))


def test_quantized_r50_on_the_card_launches_int8_and_matches_plain(
        cuda, monkeypatch):
    """A calibrated int8_static R50+MVF (two stages, MVF in the second) in
    bf16 on the card: its int8 convs launch the kernel and the fused
    kernel never runs; the logits equal those of the same model with the
    int8 kernel's plain version."""
    t = 4
    model = build_recognizer(dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=50, num_stages=2, out_indices=(1,),
                      quant='int8_static', quant_carry=True),
        cls_head=dict(type='TSNClsHead', spatial_type='avg',
                      dropout_ratio=0.0, in_channels=512, init_std=0.01,
                      num_classes=10),
        module_cfg=dict(type='MVF', n_segment=t, alpha=0.125,
                        mvf_freq=(0, 1, 0, 0), mode='THW'),
        dtype='bfloat16'), test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    model = model.cuda().eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 2 * t, 64, 64, 3)
                         .astype(np.float32)).cuda()
    with torch.inference_mode():
        with model.calibrate():
            model(x, None, return_loss=False)
        fused, before = fb.bottleneck_eval_cuda.launches, \
            q8.int8_conv_cuda.launches
        got = model(x, None, return_loss=False)
        torch.cuda.synchronize()
        launched = q8.int8_conv_cuda.launches - before
        monkeypatch.setattr(q8, 'int8_conv', q8.int8_conv_plain)
        want = model(x, None, return_loss=False)
    assert fb.bottleneck_eval_cuda.launches == fused
    # 3 convs a block (4 where a shortcut projects), 7 blocks, MVF's conv1
    # split in two (layer2's 4 blocks): 21 + 2 + 4
    assert launched == 27
    assert torch.equal(got, want)
