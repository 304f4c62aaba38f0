"""Port parity: the JAX package's golden R50+MVF logits.

``tests/test_golden_regression.py`` pins the JAX package's R50+MVF (T=4,
``average_clips=None``) initialised from ``PRNGKey(0)`` on a fixed 32x32
input to ``tests/golden/r50_mvf_logits.npz``. The port's model with those
weights (carried by ``state_dict_from_jax``), in float32, gives the same
logits at that test's tolerance, rtol 1e-4 / atol 1e-5.
"""

import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_models import r50_mvf_cfg

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden',
                      'r50_mvf_logits.npz')


def test_port_forward_matches_golden():
    data = np.load(GOLDEN)
    jmodel = jax_build(r50_mvf_cfg(), test_cfg=dict(average_clips=None))
    init = jax.jit(lambda key, x, y: jmodel.init(key, x, y, return_loss=True,
                                                 train=False))
    variables = init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4, 32, 32, 3), jnp.float32),
                     jnp.zeros((1,), jnp.int32))
    port = build_recognizer(r50_mvf_cfg(), test_cfg=dict(average_clips=None))
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    port.eval()
    rng = np.random.RandomState(int(data['x_seed']))
    x = rng.randn(2, 4, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        logits = port(torch.from_numpy(x), None, return_loss=False)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), data['logits'], rtol=1e-4,
                               atol=1e-5)
