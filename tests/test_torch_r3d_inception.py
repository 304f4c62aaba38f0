"""Port parity: the last two 3-D backbones, ``ResNet_R3D`` (R3D and
R(2+1)D) and ``InceptionV1_I3D``, against the JAX package.

Each block type of ``ResNet_R3D`` ('2.5d' with the R(2+1)D stem, '3d'
with pool1, '0.3d' in bottlenecks, '3d-sep' without BatchNorm) and
InceptionV1-I3D on RGB and Flow, built by both packages in a
``Recognizer3D`` at 32x32 (T = 4 or 8) in f64 from the port's seeded
weights with randomized BN statistics, carried into the JAX layout with
``jax_variables_from_state_dict`` (whose tree must equal the JAX model's):
forward logits agree to rtol 1e-6 / atol 1e-8. The bridge goes both ways;
the reference-named keys (the port's names) load into the JAX package's
importer with an empty report, and with ``module.`` and without
``backbone.`` into the port's. One R(2+1)D-10 train step against JAX to
rtol 1e-9. The ceil-mode pool follows the JAX package's, which gives no
output on an axis smaller than its window where torch's ``ceil_mode``
gives one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from mvfnet_tpu.models.backbones import inception_v1_i3d as jax_inception
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu_torch.models import build_backbone, build_recognizer
from mvfnet_tpu_torch.models.backbones import inception_v1_i3d
from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                               jax_variables_from_state_dict,
                                               state_dict_from_jax)
from test_torch_i3d import (ATOL, RTOL, assert_step_matches_jax, jax_shapes,
                            one_thread, tree_shapes)
from torch_reference import jax_forward

B, HW, NUM_CLASSES = 2, 32, 5


def _cfg(backbone, in_channels):
    return dict(type='Recognizer3D', backbone=backbone,
                cls_head=dict(type='I3DClsHead', dropout_ratio=0.0,
                              in_channels=in_channels,
                              num_classes=NUM_CLASSES, init_std=0.01),
                dtype=None)


# name: (config, frames, input channels)
CASES = {
    'r2plus1d_10': (_cfg(dict(type='ResNet_R3D', depth=10,
                              block_type='2.5d', bn_eval=False), 512), 4, 3),
    'r3d_10_pool1': (_cfg(dict(type='ResNet_R3D', depth=10, block_type='3d',
                               use_pool1=True), 512), 4, 3),
    'r3d_26_0.3d': (_cfg(dict(type='ResNet_R3D', depth=26,
                              block_type='0.3d', channel_multiplier=0.5),
                         256), 4, 3),
    'r3d_26_sep_no_bn': (_cfg(dict(type='ResNet_R3D', depth=26,
                                   block_type='3d-sep', with_bn=False,
                                   conv1_kernel_t=1,
                                   channel_multiplier=0.5), 256), 4, 3),
    'inception_rgb': (_cfg(dict(type='InceptionV1_I3D', bn_eval=False),
                           1024), 8, 3),
    'inception_flow': (_cfg(dict(type='InceptionV1_I3D', modality='Flow'),
                            1024), 8, 2),
}
# the vocabularies the JAX importer has rules for
REFERENCE = ('r2plus1d_10', 'inception_rgb', 'inception_flow')


@pytest.fixture(scope='module', autouse=True)
def f64():
    jax.config.update('jax_enable_x64', True)
    with one_thread():
        yield
    jax.config.update('jax_enable_x64', False)


def _port(name):
    cfg, t, c = CASES[name]
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None)).double()
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    shape = (1, 1, t, HW, HW, c)
    variables = jax_variables_from_state_dict(port.state_dict())
    shapes = jax_shapes(cfg, shape)
    assert tree_shapes(variables) == tree_shapes(shapes)
    return port.eval(), variables, shape


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_and_bridge_match_jax(name):
    port, variables, shape = _port(name)
    cfg = CASES[name][0]
    x = np.random.RandomState(1).randn(B, *shape[1:]) * 0.5
    want = jax_forward(cfg, variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.shape == (B, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    sd = port.state_dict()
    back = state_dict_from_jax(variables)
    assert set(back) == set(sd)
    assert all(torch.equal(back[k].to(v.dtype), v) for k, v in sd.items())
    if name in REFERENCE:
        zero = jax.tree_util.tree_map(np.zeros_like, variables)
        imported, report = import_torch_weights(
            {k: v.numpy() for k, v in sd.items()}, zero, return_report=True)
        assert (report['missing'], report['unexpected'],
                report['mismatched']) == ([], [], [])
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(imported),
            jax.tree_util.tree_leaves(variables)))


@pytest.mark.parametrize('name', REFERENCE[:2])
def test_reference_named_pth_imports(name):
    """The reference's keys, with ``module.`` and without ``backbone.``
    (a backbone checkpoint), load into the port with an empty report."""
    port, _, _ = _port(name)
    sd = {('module.' + k[len('backbone.'):]): v.clone()
          for k, v in port.state_dict().items() if k.startswith('backbone.')}
    fresh = build_recognizer(CASES[name][0]).double()
    report = import_torch_state_dict(fresh, sd)
    assert report['unexpected'] == report['mismatched'] == []
    assert report['missing'] == ['cls_head.fc_cls.weight',
                                 'cls_head.fc_cls.bias']
    names = [k for k in sd if not k.endswith('num_batches_tracked')]
    assert len(report['applied']) == len(names)
    stem = ('module.conv1_s.weight' if name.startswith('r2')
            else 'module.conv1_7x7_s2.weight')
    assert stem in sd
    for k in names:
        assert torch.equal(fresh.state_dict()['backbone.' + k[7:]], sd[k])
    if name.startswith('r2'):
        assert 'module.layer2.a.conv1.conv_s.weight' in sd


def test_ceil_pool_follows_jax():
    """Above the window the pool is torch's ``ceil_mode``; at the window
    one output; below it none in JAX, where torch's ``ceil_mode`` gives
    one, and the port refuses."""
    x = np.random.RandomState(2).randn(1, 5, 7, 6, 3)
    for dims, kernel, stride in (((5, 7, 6), (3, 3, 3), (2, 2, 2)),
                                 ((2, 3, 3), (2, 3, 3), (2, 2, 2))):
        xt = torch.from_numpy(x[:, :dims[0], :dims[1], :dims[2]])
        got = inception_v1_i3d._ceil_max_pool3d(
            xt.permute(0, 4, 1, 2, 3), kernel, stride)
        want = jax_inception._ceil_max_pool3d(
            jnp.asarray(xt.numpy()), kernel, stride)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                      np.asarray(want))
        torch_ceil = F.max_pool3d(xt.permute(0, 4, 1, 2, 3), kernel, stride,
                                  ceil_mode=True)
        assert torch.equal(got, torch_ceil)
    small = jnp.asarray(x[:, :1])
    assert jax_inception._ceil_max_pool3d(
        small, (2, 2, 2), (2, 2, 2)).shape[1] == 0
    assert F.max_pool3d(torch.from_numpy(x[:, :1]).permute(0, 4, 1, 2, 3),
                        2, 2, ceil_mode=True).shape[2] == 1
    with pytest.raises(RuntimeError):
        inception_v1_i3d._ceil_max_pool3d(
            torch.from_numpy(x[:, :1]).permute(0, 4, 1, 2, 3), (2, 2, 2),
            (2, 2, 2))


def test_r2plus1d_train_step_matches_jax():
    assert_step_matches_jax(CASES['r2plus1d_10'][0], t=4)


def test_backbones_build_with_their_defaults():
    r2p1d = build_backbone(dict(type='ResNet_R3D'))
    assert r2p1d.conv1_s.weight.shape == (45, 3, 1, 7, 7)
    assert r2p1d.layer1.a.conv1.conv_s.weight.shape[0] == 144
    assert sorted(dict(r2p1d.layer3.named_children())) == list('abcdef')
    inception = build_backbone(dict(type='InceptionV1_I3D'))
    x = torch.zeros(1, 3, 16, 64, 64)
    with torch.no_grad():
        assert inception.eval()(x).shape == (1, 1024, 2, 2, 2)
