"""Port parity: the fused eval bottleneck (mvfnet_tpu_torch/ops/fused_block.py).

The port's plain version is held against the JAX package's Pallas kernel
(interpret mode) and its jnp composition on the same numpy-seeded inputs;
the folded path of the port's Bottleneck against its unfused conv/BN chain.
The CUDA kernel itself is held against the plain version on the card, in
tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax

from mvfnet_tpu.ops import fused_block as jfb
from mvfnet_tpu_torch.models.backbones.resnet import Bottleneck
from mvfnet_tpu_torch.ops import fused_block as fb

# the JAX suite's shapes (tests/test_fused_block.py): ragged W=10, H=6
SHAPES = [((2, 8, 8, 32), 16), ((1, 6, 10, 24), 8)]


def _np(seed, *shape):
    return np.random.RandomState(seed).randn(*shape) * 0.2


def _inputs(shape, cm, dtype):
    cin = shape[-1]
    arrs = [_np(0, *shape), _np(1, cin, cm), _np(4, 1, cm),
            _np(2, 3, 3, cm, cm), _np(5, 1, cm), _np(3, cm, cin),
            _np(6, 1, cin)]
    return [a.astype(dtype) for a in arrs]


def _port(arrs):
    return fb.bottleneck_eval(*(torch.from_numpy(a) for a in arrs)).numpy()


@pytest.fixture
def x64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


@pytest.mark.parametrize('shape,cm', SHAPES)
def test_plain_matches_pallas_interpret_f32(shape, cm):
    arrs = _inputs(shape, cm, np.float32)
    old = jfb.INTERPRET
    jfb.INTERPRET = True
    try:
        want = np.asarray(jfb.bottleneck_eval_pallas(*arrs))
    finally:
        jfb.INTERPRET = old
    np.testing.assert_allclose(_port(arrs), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape,cm', SHAPES)
def test_plain_matches_jnp_f32(shape, cm):
    arrs = _inputs(shape, cm, np.float32)
    want = np.asarray(jfb.bottleneck_eval_jnp(*arrs))
    np.testing.assert_allclose(_port(arrs), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('shape,cm', SHAPES)
def test_plain_matches_jnp_f64(shape, cm, x64):
    arrs = _inputs(shape, cm, np.float64)
    want = np.asarray(jfb.bottleneck_eval_jnp(*arrs))
    assert want.dtype == np.float64
    np.testing.assert_allclose(_port(arrs), want, rtol=1e-10, atol=1e-10)


def test_fold_bn_matches_jax(x64):
    k, s, b, m = (_np(i, 3, 3, 8, 16) if i == 0 else _np(i, 16)
                  for i in range(4))
    v = np.abs(_np(4, 16)) + 0.5
    want = jfb.fold_bn(k, s, b, m, v)
    got = fb.fold_bn(*(torch.from_numpy(a) for a in (k, s, b, m, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13,
                                   atol=0)


def _block(cin, cm):
    """Port Bottleneck with random f64 weights and BN statistics."""
    torch.manual_seed(0)
    blk = Bottleneck(cin, cm).double()
    with torch.no_grad():
        for i, p in enumerate(blk.parameters()):
            p.copy_(torch.from_numpy(_np(10 + i, *p.shape)))
        for i, bn in enumerate((blk.bn1, blk.bn2, blk.bn3)):
            bn.weight.add_(1.0)
            bn.running_mean.copy_(torch.from_numpy(_np(20 + i, bn.num_features)))
            bn.running_var.copy_(torch.from_numpy(
                np.abs(_np(30 + i, bn.num_features)) + 0.5))
    return blk


@pytest.fixture
def count_calls(monkeypatch):
    calls = []
    real = fb.bottleneck_eval

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(fb, 'bottleneck_eval', spy)
    return calls


def test_folded_path_matches_unfused_chain(count_calls):
    """eval + no grad: BN folded into the weights, one bottleneck_eval call;
    it equals the block's unfused conv->BN->relu chain."""
    blk = _block(32, 8).eval()
    x = torch.from_numpy(_np(7, 2, 32, 8, 8)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        fused = blk(x)
    assert len(count_calls) == 1
    with torch.enable_grad():
        unfused = blk(x).detach()
    assert len(count_calls) == 1
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_folded_weights_follow_changes():
    """The folded weights are made once and reused; an in-place edit, BN
    statistics updated in training, and a load each give fresh ones."""
    blk = _block(32, 8).eval()
    x = torch.from_numpy(_np(7, 2, 32, 8, 8)).contiguous(
        memory_format=torch.channels_last)

    def assert_fused_matches_unfused():
        with torch.no_grad():
            fused = blk(x)
        with torch.enable_grad():
            unfused = blk(x).detach()
        np.testing.assert_allclose(fused.numpy(), unfused.numpy(),
                                   rtol=1e-10, atol=1e-12)

    assert_fused_matches_unfused()
    with torch.no_grad():
        first = blk._fused_weights(x.dtype)
        assert blk._fused_weights(x.dtype) is first
        blk.conv2.weight.mul_(1.5)
    assert_fused_matches_unfused()
    blk.train()
    with torch.no_grad():
        blk(x * 3 + 1)
    blk.eval()
    assert_fused_matches_unfused()
    sd = blk.state_dict()
    sd['bn3.running_mean'] = sd['bn3.running_mean'] + 0.5
    blk.load_state_dict(sd)
    assert_fused_matches_unfused()


def test_train_mode_runs_unfused(count_calls):
    blk = _block(32, 8).train()
    with torch.no_grad():
        out = blk(torch.from_numpy(_np(7, 2, 32, 8, 8)))
    assert out.shape == (2, 32, 8, 8)
    assert count_calls == []


def test_fusable_blocks():
    assert Bottleneck(32, 8).fusable
    assert not Bottleneck(32, 8, stride=2, with_downsample=True).fusable
    assert not Bottleneck(32, 8, style='caffe').fusable
    assert not Bottleneck(32, 8, temporal_cfg=dict(
        type='MVF', n_segment=2, alpha=0.25)).fusable


def test_cpu_tensor_takes_plain_version_and_kernel_refuses_it():
    arrs = [torch.from_numpy(a) for a in _inputs(*SHAPES[0], np.float32)]
    before = fb.bottleneck_eval_cuda.launches
    fb.bottleneck_eval(*arrs)
    assert fb.bottleneck_eval_cuda.launches == before
    with pytest.raises(ValueError, match='CUDA tensor'):
        fb.bottleneck_eval_cuda(*arrs)
