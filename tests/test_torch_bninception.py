"""Port parity: BN-Inception (``BNInception``) and the shipped
``configs/tsn/tsn_bninception_k400.py``.

The forward of the config's model (5 classes) is held against the JAX
package in f64 over a sweep of input sizes, with the port's seeded weights
and randomized BatchNorm statistics carried through the bridge (the
carried tree equals the JAX model's ``eval_shape`` tree): rtol 1e-6 / atol
1e-8. At 32 and 33 both packages refuse: the 4e reduction block meets a
2x2 map, which the JAX ``_ceil_max_pool`` pools to nothing (a ragged
concat) where torch's ``MaxPool2d(ceil_mode=True)`` would give 1x1; the
port follows JAX (ROADMAP.md, section C). One train step through
``make_train_step`` on the config's head (dropout 0.8, one scripted mask
on both sides; BatchNorm's torch momentum 0.9) agrees to rtol 1e-9 on the
loss and gradient norm and 1e-7 / atol 1e-9 on the parameters and
statistics. The config's ``state_dict()`` is ``release_vocab.json``'s
``tsn_bninception`` (485 keys) and imports with empty reports both ways.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.models.backbones import bninception as jax_bni
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.engine.optim import param_label
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.models.backbones.bninception import _ceil_max_pool
from mvfnet_tpu_torch.utils.checkpoint import import_torch_state_dict
from test_torch_i3d import (ATOL, RTOL, f64, jax_forward, jax_shapes,
                            jax_variables, port_model, template)
from test_torch_temporal_modules import (assert_train_step_matches_jax,
                                         scripted_dropout)

assert f64  # the module-scoped x64 fixture, autouse

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
CONFIG = os.path.join(REPO, 'configs', 'tsn', 'tsn_bninception_k400.py')
NUM_CLASSES = 5


def config_model(**head):
    """The shipped config's model with 5 classes, in the params' dtype."""
    model = dict(Config.fromfile(CONFIG).model)
    model['cls_head'] = dict(model['cls_head'], num_classes=NUM_CLASSES,
                             **head)
    return dict(model, dtype=None)


@pytest.mark.parametrize('size', [9, 10, 11, 12, 13, 16, 17])
def test_ceil_max_pool_matches_jax(size):
    x = np.random.RandomState(size).randn(2, size, size + 1, 3)
    want = np.asarray(jax_bni._ceil_max_pool(jnp.asarray(x), 3, 2))
    got = _ceil_max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('size', [64, 65, 96, 224])
def test_forward_matches_jax(size):
    cfg = config_model(dropout_ratio=0.0)
    port = port_model(cfg).eval()
    x = np.random.RandomState(size).randn(1, 1, size, size, 3) * 0.5
    want = jax_forward(cfg, jax_variables(port, cfg, (1, 1, 64, 64, 3)), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.shape == (1, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('size', [32, 33])
def test_small_inputs_refused_by_both_packages(size):
    cfg = config_model(dropout_ratio=0.0)
    port = port_model(cfg).eval()
    x = np.zeros((1, 1, size, size, 3))
    with pytest.raises(TypeError, match='concatenate'):
        jax_forward(cfg, template(cfg, (1, 1, 64, 64, 3)), x)
    with pytest.raises(RuntimeError), torch.no_grad():
        port(torch.from_numpy(x), None, return_loss=False)


def test_train_step_matches_jax(monkeypatch):
    """The config's 3 segments, dropout 0.8, ``bn_eval=False`` (BatchNorm
    trains, momentum 0.9), 64x64 frames, 2 videos."""
    cfg = config_model()
    assert cfg['cls_head']['dropout_ratio'] == 0.8
    assert cfg['backbone'] == dict(type='BNInception', bn_eval=False)
    mask = np.random.RandomState(5).rand(2 * 3, 1024) >= 0.8
    scripted_dropout(monkeypatch, mask)
    port = port_model(cfg)
    imgs = np.random.RandomState(7).randn(2, 3, 64, 64, 3) * 0.5
    assert_train_step_matches_jax(cfg, port, imgs, np.array([1, 4]))
    bn = port.backbone.conv1_7x7_s2_bn
    assert bn.momentum == 0.9 and int(bn.num_batches_tracked) == 1


def test_config_state_dict_is_release_vocabulary_and_imports_both_ways():
    with open(os.path.join(REPO, 'tests', 'golden',
                           'release_vocab.json')) as f:
        vocab = json.load(f)['tsn_bninception']
    cfg = Config.fromfile(CONFIG)
    port = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    sd = port.state_dict()
    assert {k: list(v.shape) for k, v in sd.items()} == vocab
    assert len(sd) == 485
    report = import_torch_state_dict(port, sd)
    assert report['missing'] == report['unexpected'] == \
        report['mismatched'] == []
    jcfg = dict(cfg.model, dtype=None)
    tree, jreport = import_torch_weights(
        {k: v.numpy() for k, v in sd.items()},
        template(jcfg, (1, 1, 64, 64, 3)), return_report=True)
    assert jreport['missing'] == jreport['unexpected'] == \
        jreport['mismatched'] == []
    carried = jax_variables(port, jcfg, (1, 1, 64, 64, 3))
    for path, v in jax.tree_util.tree_leaves_with_path(carried):
        got = tree
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, v)
    assert jax_shapes(jcfg, (1, 1, 64, 64, 3))
    # the optimizer's labels: conv biases 'bias', BatchNorm 'norm'
    assert param_label('backbone.inception_3a_1x1.bias') == 'bias'
    assert param_label('backbone.inception_3a_1x1_bn.bias') == 'norm'
    assert param_label('backbone.conv1_7x7_s2_bn.weight') == 'norm'
    assert param_label('backbone.conv1_7x7_s2.weight') == 'default'
