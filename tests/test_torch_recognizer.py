"""Port parity: the dense-test slice end to end.

JAX MVFNet-R50 (fcn_testing, T=4, 64x64, 2 clips) initialised from
``PRNGKey(0)`` with randomized BN statistics goes through
``state_dict_from_jax`` into the port; the same uint8 frames go through the
JAX package's ``make_eval_step`` and the port's, in f64 on both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.engine.train_step import make_eval_step as jax_eval_step
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.ops.normalize import device_normalize as jax_normalize
from mvfnet_tpu_torch.engine.train_step import make_eval_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.ops import fused_block as fb
from mvfnet_tpu_torch.ops.normalize import device_normalize
from mvfnet_tpu_torch.utils.checkpoint import state_dict_from_jax

T, CLIPS, SIZE, NUM_CLASSES = 4, 2, 64, 11
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True, device=True)


def model_cfg(average_clips):
    return dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=50, out_indices=(3,),
                      norm_eval=False,
                      norm_cfg=dict(type='BN', requires_grad=True)),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.5, in_channels=2048, init_std=0.01,
                      num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'),
        fcn_testing=True,
        # dtype=None: compute follows the params (f64 here)
        dtype=None,
    ), dict(average_clips=average_clips)


@pytest.fixture(scope='module')
def slice_setup():
    jax.config.update('jax_enable_x64', True)
    cfg, test_cfg = model_cfg('prob')
    jmodel = jax_build(cfg, test_cfg=test_cfg)
    init = jax.jit(lambda key, x: jmodel.init(key, x, None,
                                              return_loss=False))
    variables = init(jax.random.PRNGKey(0),
                     jnp.zeros((1, T, SIZE, SIZE, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                       variables)
    rng = np.random.RandomState(1)
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda v: (rng.uniform(0.8, 1.2, v.shape) if v.min() == 1.0
                   else rng.normal(0, 0.05, v.shape)),
        variables['batch_stats'])
    port = build_recognizer(cfg, test_cfg=test_cfg).double()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    frames = np.random.RandomState(3).randint(
        0, 256, (1, CLIPS * T, SIZE, SIZE, 3), dtype=np.uint8)
    yield variables, port, frames
    jax.config.update('jax_enable_x64', False)


@pytest.mark.parametrize('average_clips', ['prob', None])
def test_dense_test_scores_match_jax(slice_setup, average_clips,
                                     monkeypatch):
    variables, port, frames = slice_setup
    cfg, test_cfg = model_cfg(average_clips)
    jstep = jax_eval_step(jax_build(cfg, test_cfg=test_cfg), norm_cfg=NORM)
    want = np.asarray(jstep(variables, jnp.asarray(frames)))

    calls = []
    real = fb.bottleneck_eval
    monkeypatch.setattr(fb, 'bottleneck_eval',
                        lambda *a: calls.append(a[0].shape) or real(*a))
    port.test_cfg = test_cfg
    step = make_eval_step(port, norm_cfg=NORM, device='cpu')
    got = step(port, frames)
    assert got.dtype == torch.float64
    assert got.shape == want.shape == ((1, NUM_CLASSES) if average_clips
                                       else (CLIPS, NUM_CLASSES))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-8)
    # layer1.1-2 and layer2.1-3 went through the fused bottleneck
    assert len(calls) == 5
    assert [tuple(s) for s in calls] == (
        [(CLIPS * T, 16, 16, 256)] * 2 + [(CLIPS * T, 8, 8, 512)] * 3)
    if average_clips == 'prob':
        np.testing.assert_allclose(got.sum().item(), 1.0, rtol=1e-12)


def test_device_normalize_matches_jax():
    imgs = np.random.RandomState(0).randint(0, 256, (2, 5, 7, 3), np.uint8)
    want = np.asarray(jax_normalize(jnp.asarray(imgs), NORM))
    got = device_normalize(torch.from_numpy(imgs), NORM)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    div = dict(NORM, div_255=True, mean=[0.5] * 3, std=[0.25] * 3)
    np.testing.assert_array_equal(
        device_normalize(torch.from_numpy(imgs), div).numpy(),
        np.asarray(jax_normalize(jnp.asarray(imgs), div)))
    bf16 = device_normalize(torch.from_numpy(imgs), NORM, torch.bfloat16)
    assert bf16.dtype == torch.bfloat16
