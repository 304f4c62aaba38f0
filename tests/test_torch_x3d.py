"""Port parity: X3D (``ResNet_X3D``), forward and train step.

The cases and the helpers are ``test_torch_slowfast_x3d.py``'s, split out
so that the two files run on separate workers.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.models import build_backbone as jax_build_backbone
from mvfnet_tpu_torch.models import build_backbone
from test_torch_i3d import (ATOL, B, RECIPE, RTOL, assert_step_matches_jax,
                            jax_variables, model_cfg, one_thread, port_model)
from test_torch_slowfast_x3d import HW, X3D, clips, nthwc, x3d_backbone


@pytest.fixture(scope='module', autouse=True)
def f64():
    jax.config.update('jax_enable_x64', True)
    with one_thread():         # X3D's depthwise convolutions in f64
        yield
    jax.config.update('jax_enable_x64', False)


@pytest.mark.parametrize('name', sorted(X3D))
def test_x3d_matches_jax(name):
    """The backbone's outputs: the (N, 2048, 1, 1, 1) features, after the
    maps of the earlier ``out_indices``."""
    backbone, t = X3D[name]
    port = build_backbone(dict(backbone)).double()
    # the weights of a recognizer on the last map: the same modules
    cfg = model_cfg(dict(backbone, out_indices=(
        backbone.get('num_stages', 4) - 1,)), 2048)
    recognizer = port_model(cfg)
    port.load_state_dict({k[len('backbone.'):]: v for k, v in
                          recognizer.state_dict().items()
                          if k.startswith('backbone.')})
    variables = jax_variables(recognizer, cfg, (1, 1, t, HW, HW, 3))
    x = clips(1, t)[:, 0]
    jbackbone = jax_build_backbone(dict(backbone, dtype=None))
    want = jax.jit(lambda v, x: jbackbone.apply(v, x, train=False))(
        {c: v['backbone_mod'] for c, v in variables.items()},
        jnp.asarray(x))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(backbone.get('out_indices', (3,)))
    assert tuple(got[-1].shape) == (B, 2048, 1, 1, 1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(nthwc(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


def test_x3d_train_step_matches_jax():
    """With the recipe's weight decay off for norms and biases: X3D's
    temporal stem norm (``conv1_3x1.1``) is a norm parameter, as the JAX
    package labels its ``conv1_3x1_bn``."""
    recipe = dict(RECIPE, paramwise_options=dict(norm_decay_mult=0.0,
                                                 bias_decay_mult=0.0))
    cfg = model_cfg(x3d_backbone(depth=1, ratio_width=0.5, num_stages=1),
                    2048)
    assert_step_matches_jax(cfg, recipe=recipe)
