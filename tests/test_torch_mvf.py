"""Port parity: the MVF op and module (mvfnet_tpu_torch/ops/mvf.py,
mvfnet_tpu_torch/models/modules/mvf.py) against the JAX package, in f64 on
the same numpy-seeded inputs and weights."""

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

from mvfnet_tpu.models.modules.mvf import MVF as JaxMVF
from mvfnet_tpu.ops import mvf as jmvf
from mvfnet_tpu_torch.models.modules.mvf import MVF
from mvfnet_tpu_torch.ops import mvf as tmvf

N, T, H, W, C = 2, 4, 6, 5, 16
RTOL, ATOL = 1e-9, 1e-10


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


@pytest.fixture
def x64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


@pytest.mark.parametrize('axis', [1, 2, 3])
def test_dw3_matches_jax(axis, x64):
    x, w = _rand(axis, N, T, H, W, C), _rand(10 + axis, 3, C)
    want = np.asarray(jmvf.dw3(jnp.asarray(x), jnp.asarray(w), axis=axis))
    got = tmvf.dw3(torch.from_numpy(x), torch.from_numpy(w), dim=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('mode', ['T', 'TH', 'THW', 'share'])
def test_mvf_conv_sum_matches_jax(mode, x64):
    x = _rand(0, N, T, H, W, C)
    ws = [_rand(i, 3, C) for i in (1, 2, 3)]
    if mode == 'share':
        ws, mode = [ws[0]] * 3, 'THW'
    want = np.asarray(jmvf.mvf_conv_sum(jnp.asarray(x),
                                        *map(jnp.asarray, ws), mode=mode))
    got = tmvf.mvf_conv_sum(torch.from_numpy(x),
                            *map(torch.from_numpy, ws), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_hard_swish_matches_jax(x64):
    x = np.linspace(-5, 5, 101)
    np.testing.assert_allclose(
        tmvf.hard_swish(torch.from_numpy(x)).numpy(),
        np.asarray(jmvf.hard_swish(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def _pair(use_hs, share, mode, alpha=0.25):
    """JAX MVF variables (random weights and BN statistics) and the port's
    MVF loaded with the same values, both f64."""
    jm = JaxMVF(n_segment=T, in_channels=C, alpha=alpha, use_hs=use_hs,
                share=share, mode=mode, concat=True)
    x = _rand(0, N * T, H, W, C)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    cs = int(C * alpha)
    params = {k: _rand(20 + i, *np.shape(v))
              for i, (k, v) in enumerate(sorted(variables['params'].items()))}
    if use_hs:
        params['bn_scale'] = params['bn_scale'] + 1.0
    stats = {}
    if 'batch_stats' in variables:
        stats = {'bn_mean': _rand(30, cs) * 0.1,
                 'bn_var': np.abs(_rand(31, cs)) + 0.5}
    jvars = {'params': params, 'batch_stats': stats} if stats \
        else {'params': params}

    tm = MVF(nn.Identity(), n_segment=T, in_channels=C, alpha=alpha,
             use_hs=use_hs, share=share, mode=mode).double()
    shapes = {'shift_conv': (3, 1, 1), 'h_conv': (1, 3, 1),
              'w_conv': (1, 1, 3)}
    with torch.no_grad():
        for name, shape in shapes.items():
            if name in params:
                getattr(tm, name).weight.copy_(torch.from_numpy(
                    params[name].T.reshape((cs, 1) + shape)))
        if use_hs:
            tm.bn.weight.copy_(torch.from_numpy(params['bn_scale']))
            tm.bn.bias.copy_(torch.from_numpy(params['bn_bias']))
            tm.bn.running_mean.copy_(torch.from_numpy(stats['bn_mean']))
            tm.bn.running_var.copy_(torch.from_numpy(stats['bn_var']))
    return jm, jvars, tm, x


CASES = [(True, False, 'THW'), (False, False, 'THW'), (True, True, 'THW'),
         (True, False, 'T'), (True, False, 'TH')]


@pytest.mark.parametrize('use_hs,share,mode', CASES)
def test_mvf_module_eval_matches_jax(use_hs, share, mode, x64):
    jm, jvars, tm, x = _pair(use_hs, share, mode)
    want = np.asarray(jm.apply(jvars, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm.eval().mvf(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('share', [False, True])
def test_mvf_module_train_matches_jax(share, x64):
    """Train-mode BN: output and the updated running statistics (the
    running variance stores the unbiased batch variance)."""
    jm, jvars, tm, x = _pair(True, share, 'THW')
    want, new_state = jm.apply(jvars, jnp.asarray(x), train=True,
                               mutable=['batch_stats'])
    tm.train()
    with torch.no_grad():
        got = tm.mvf(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    new = new_state['batch_stats']
    np.testing.assert_allclose(tm.bn.running_mean.numpy(),
                               np.asarray(new['bn_mean']), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tm.bn.running_var.numpy(),
                               np.asarray(new['bn_var']), rtol=RTOL,
                               atol=ATOL)
    assert int(tm.bn.num_batches_tracked) == 1


def test_mvf_forward_wraps_net():
    """forward: fusion on the NCHW (channels_last) block input, then net."""
    net = nn.Conv2d(C, 8, 1, bias=False).double()
    tm = MVF(net, n_segment=T, in_channels=C, alpha=0.25).double().eval()
    x = torch.from_numpy(_rand(1, N * T, C, H, W)).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        got = tm(x)
        want = net(tm.mvf(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)
