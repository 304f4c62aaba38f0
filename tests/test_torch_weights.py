"""Port weight carry: the port's state-dict vocabulary is the reference's
release vocabulary, and JAX variables survive JAX -> port -> JAX exactly."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.config import Config as JaxConfig
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                               load_torch_state_dict,
                                               state_dict_from_jax)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
CONFIG = os.path.join(REPO, 'configs', 'mvf', 'k400',
                      'mvf_kinetics400_r50_8x8_dense.py')

with open(os.path.join(REPO, 'tests', 'golden', 'release_vocab.json')) as f:
    VOCAB = json.load(f)


def _port_model():
    cfg = Config.fromfile(CONFIG)
    return build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)


# release vocabulary -> (shipped config, its key count)
RELEASES = {
    'mvf_r50_8x8': ('mvf/k400/mvf_kinetics400_r50_8x8_dense.py', 392),
    'mvf_r101_8x8': ('mvf/k400/mvf_kinetics400_r101_8x8_dense.py', 834),
    'i3d_r50': ('i3d/i3d_r50_32x2_k400.py', 320),
    'slowfast_r50': ('slowfast/slowfast_r50_k400.py', 643),
    'slowfast_r50_unpacked': ('slowfast/slowfast_r50_k400_unpacked.py', 643),
    'tsn_bninception': ('tsn/tsn_bninception_k400.py', 485),
}


@pytest.mark.parametrize('release', sorted(RELEASES))
def test_state_dict_is_release_vocabulary(release):
    """The port's ``state_dict()`` of each shipped config is the release's
    names and shapes (SlowFast, packed or not, all but the reference's
    unused ``slow_path.layer4_lateral.weight``), and imports through
    ``import_torch_state_dict`` with an empty report."""
    config, count = RELEASES[release]
    cfg = Config.fromfile(os.path.join(REPO, 'configs', config))
    port = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    sd = port.state_dict()
    got = {k: list(v.shape) for k, v in sd.items()}
    want = dict(VOCAB[release.replace('_unpacked', '')])
    if release.startswith('slowfast'):
        assert want.pop('backbone.slow_path.layer4_lateral.weight')
        count -= 1
    assert len(got) == count
    assert got == want
    report = import_torch_state_dict(port, sd)
    assert report['missing'] == report['unexpected'] == \
        report['mismatched'] == []
    if release == 'mvf_r50_8x8':
        assert list(sd['backbone.layer3.0.conv1.shift_conv.weight']
                    .shape) == [64, 1, 3, 1, 1]


@pytest.fixture(scope='module')
def jax_variables():
    """The JAX recognizer's variables (``eval_shape``'s tree) holding seeded
    numbers, BN variances positive, so a swapped mean/var would show."""
    cfg = JaxConfig.fromfile(CONFIG)
    model = jax_build(dict(cfg.model), test_cfg=dict(cfg.test_cfg))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3), jnp.float32),
        None, return_loss=False))
    rng = np.random.RandomState(0)
    variables = jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), dict(shapes))
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda v: np.abs(v) + np.float32(0.1), variables['batch_stats'])
    return variables


def test_jax_port_jax_round_trip_is_exact(jax_variables):
    port = _port_model()
    port.load_state_dict(state_dict_from_jax(jax_variables), strict=True)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, report = import_torch_weights(sd, jax_variables,
                                        return_report=True)
    assert report['missing'] == []
    assert report['unexpected'] == []
    assert report['mismatched'] == []
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(jax_variables))
    assert len(flat_back) == len(flat_want)
    for path, v in flat_back:
        np.testing.assert_array_equal(v, flat_want[path],
                                      err_msg=jax.tree_util.keystr(path))


def test_load_torch_state_dict_strips_module_prefix(tmp_path):
    port = _port_model()
    sd = {'module.' + k: v for k, v in port.state_dict().items()}
    path = str(tmp_path / 'ckpt.pth')
    torch.save({'state_dict': sd, 'meta': {'epoch': 1}}, path)
    loaded = load_torch_state_dict(path)
    assert set(loaded) == set(port.state_dict())
    fresh = _port_model()
    fresh.load_state_dict(loaded, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, port.state_dict()[k]), k
