"""The port's CUDA kernels against their plain PyTorch versions on the card,
and a small train step that must not launch them, and the eval loop's
pinned-memory prefetch.

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

pytestmark = pytest.mark.cuda

# (N, H, W, Cin), Cm: the JAX suite's shapes (general kernel), and shapes
# that take the tiled bf16 kernel at the edges of its strip walk: H and W
# not multiples of its tile, H not a multiple of the strip or the step
# (a ragged last step), H = 1, and H below the step with W ragged
SHAPES = [((2, 8, 8, 32), 16), ((1, 6, 10, 24), 8), ((3, 13, 11, 128), 64),
          ((160, 37, 20, 128), 64), ((1, 1, 64, 256), 64),
          ((2, 3, 9, 192), 128)]


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
