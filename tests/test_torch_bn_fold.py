"""The eval BatchNorm fold of the port's 2-D ResNet (models/backbones/resnet.py).

In eval with no gradient every (plain conv, BatchNorm) pair that the fused
bottleneck does not take runs as one conv with the BN folded into its
weight and bias (``common.fold_conv_bn``, ``common.folded_conv``). Each
case is held in f64 against the same module's unfolded chain (eval under
``torch.enable_grad()``), the folded weights against in-place changes,
moves, loads and training, and the counter against the paths that must
not fold. The bf16 epilogue on the card is in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

from mvfnet_tpu_torch.models import build_recognizer, common
from mvfnet_tpu_torch.models.backbones.resnet import (BasicBlock, Bottleneck,
                                                      ResNet)

MVF = dict(type='MVF', n_segment=2, alpha=0.25, mode='THW')
COST = dict(type='CoST', n_segment=2)
COUNTS = common.folded_conv.counts


def _stem(module, x):
    return module._stem(x)


def _forward(module, x):
    return module(x)


# name: (module, input shape (N*T, C, H, W), what runs, folded pairs)
CASES = {
    'stem': (lambda: ResNet(50, num_stages=1, norm_eval=False),
             (2, 3, 16, 16), _stem, 1),
    'deep_stem': (lambda: ResNet(50, num_stages=1, norm_eval=False,
                                 deep_stem=True, stem_width=8),
                  (2, 3, 16, 16), _stem, 3),
    'downsample': (lambda: Bottleneck(16, 8, stride=2, with_downsample=True),
                   (2, 16, 8, 8), _forward, 4),
    'mvf': (lambda: Bottleneck(32, 8, temporal_cfg=MVF), (4, 32, 6, 6),
            _forward, 3),
    'avd': (lambda: Bottleneck(16, 8, stride=2, with_downsample=True,
                               avd=True, avg_down=True), (2, 16, 7, 7),
            _forward, 4),
    # conv2 is CoST, whose output bn2 normalizes unfolded
    'cost': (lambda: Bottleneck(32, 8, temporal_cfg=COST), (4, 32, 6, 6),
             _forward, 2),
    'basic': (lambda: BasicBlock(16, 32, stride=2, with_downsample=True),
              (2, 16, 8, 8), _forward, 3),
}


def _randomize(module, seed=0):
    """f64 parameters and BN statistics drawn from ``seed``, so that no
    BN is near the identity."""
    gen = torch.Generator().manual_seed(seed)
    module.double()
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, dtype=p.dtype) * 0.3)
        for m in module.modules():
            if isinstance(m, common.BatchNorm):
                m.weight.add_(1.0)
                m.running_mean.copy_(torch.randn(
                    m.num_features, generator=gen, dtype=torch.float64) * 0.3)
                m.running_var.copy_(torch.rand(
                    m.num_features, generator=gen, dtype=torch.float64) + 0.5)
    return module


def _case(name):
    make, shape, run, pairs = CASES[name]
    module = _randomize(make()).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape)).contiguous(
        memory_format=torch.channels_last)
    return module, x, run, pairs


def _counts():
    return COUNTS['calls'], COUNTS['folds']


def _assert_folded_matches_unfolded(module, x, run):
    with torch.no_grad():
        got = run(module, x)
    with torch.enable_grad():
        want = run(module, x).detach()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize('name', sorted(CASES))
def test_folded_forward_matches_unfolded_chain(name):
    """Each pair folds once and then reuses its weights; the folded
    forward equals the unfolded conv -> BN -> (add) -> relu chain."""
    module, x, run, pairs = _case(name)
    calls, folds = _counts()
    with torch.no_grad():
        got = run(module, x)
        assert _counts() == (calls + pairs, folds + pairs)
        again = run(module, x)
        assert _counts() == (calls + 2 * pairs, folds + pairs)
    with torch.enable_grad():
        want = run(module, x).detach()
    assert _counts() == (calls + 2 * pairs, folds + pairs)
    assert torch.equal(got, again)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-12)


def _inplace_param(module, x, run):
    with torch.no_grad():
        next(m for m in module.modules()
             if isinstance(m, common.Conv2d)).weight.mul_(1.5)


def _inplace_stats(module, x, run):
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, common.BatchNorm):
                m.running_var.mul_(2.0)
                m.bias.sub_(0.25)


def _train_step(module, x, run):
    # train-mode BN updates its running statistics without a version bump
    module.train()
    with torch.no_grad():
        run(module, x * 3 + 1)
    module.eval()


def _load(module, x, run):
    sd = module.state_dict()
    for k in sd:
        if k.endswith('running_mean'):
            sd[k] = sd[k] + 0.5
    module.load_state_dict(sd)


def _move(module, x, run):
    module.to('cpu')


CHANGES = {'inplace_param': _inplace_param, 'inplace_stats': _inplace_stats,
           'train_eval': _train_step, 'load_state_dict': _load, 'to': _move}


@pytest.mark.parametrize('change', sorted(CHANGES))
@pytest.mark.parametrize('name', ['deep_stem', 'downsample', 'mvf', 'basic'])
def test_folded_weights_follow_changes(name, change):
    """An in-place edit of a weight or a BN statistic, BN statistics
    updated in training, a load and a move each give fresh folded
    weights; without one the cached ones are reused."""
    module, x, run, pairs = _case(name)
    _assert_folded_matches_unfolded(module, x, run)
    _, folds = _counts()
    with torch.no_grad():
        before = run(module, x)
    assert _counts()[1] == folds
    CHANGES[change](module, x, run)
    with torch.no_grad():
        after = run(module, x)
    assert _counts()[1] > folds
    assert not torch.equal(before, after) or change == 'to'
    _assert_folded_matches_unfolded(module, x, run)


def _int8_static_block():
    blk = _randomize(Bottleneck(16, 8, stride=2, with_downsample=True,
                                quant='int8_static')).eval()
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 8, 8))
    with torch.no_grad(), common.quant_calibration(blk):
        blk(x)
    return blk, x


def _gn_block():
    blk = _randomize(Bottleneck(16, 8, stride=2, with_downsample=True,
                                norm_cfg=dict(type='GN', num_groups=4)))
    return blk.eval(), torch.from_numpy(
        np.random.RandomState(1).randn(2, 16, 8, 8))


@pytest.mark.parametrize('path', ['train', 'grad'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_counter_reads_zero_in_training_and_under_gradients(name, path):
    """Train mode (with or without gradients) and eval with gradients
    run no folded conv and fold nothing."""
    module, x, run, _ = _case(name)
    before = _counts()
    if path == 'train':
        module.train()
    with torch.set_grad_enabled(path == 'grad'):
        out = run(module, x)
    assert _counts() == before
    assert bool(torch.isfinite(out).all())


@pytest.mark.parametrize('make', [_gn_block, _int8_static_block],
                         ids=['gn', 'int8_static'])
def test_counter_reads_zero_for_gn_and_int8_blocks(make):
    """GroupNorm blocks and the int8 path's quantized convs keep their
    paths in eval with no gradient: no folded conv, nothing folded."""
    before = _counts()
    module, x = make()
    with torch.no_grad():
        out = module(x)
    assert _counts() == before
    assert bool(torch.isfinite(out).all())


def test_flagship_folds_38_pairs_a_forward():
    """MVFNet-R50 (MVF in stages 3-4) in eval: the stem, the three pairs
    and the shortcut of each stage's first block, and the three pairs of
    each other MVF block fold, 1 + 4 * 4 + 3 * (5 + 2) = 38 calls a
    forward; the other five blocks take the fused bottleneck."""
    t = 8
    model = build_recognizer(dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=50, out_indices=(3,)),
        cls_head=dict(type='TSNClsHead', spatial_type='avg',
                      dropout_ratio=0.5, in_channels=2048, init_std=0.01,
                      num_classes=10),
        module_cfg=dict(type='MVF', n_segment=t, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW')),
        test_cfg=dict(average_clips=None))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    model.eval()
    x = torch.from_numpy(np.random.RandomState(0).randn(1, t, 32, 32, 3)
                         .astype(np.float32))
    calls, folds = _counts()
    with torch.no_grad():
        got = model(x, None, return_loss=False)
        assert _counts() == (calls + 38, folds + 38)
        model(x, None, return_loss=False)
    assert _counts() == (calls + 76, folds + 38)
    with torch.enable_grad():
        want = model(x, None, return_loss=False).detach()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
