"""What the port's tests (``tests/test_torch_*.py``) share: torch's threads
under pytest-xdist, and the JAX references they build.

Threads. torch runs each operation on every core by default, and an
OpenMP region waits for its slowest thread. Under ``pytest -n N`` the N
workers then run N times as many busy threads as there are cores, and a
small f64 convolution takes many times its time alone. A worker takes its
share of the cores instead (at least one thread) when this module is
imported, and sets ``OMP_NUM_THREADS`` to it, so that a CLI a test runs as
a subprocess computes with the threads of the test's own process (float32
results depend on the thread count in their last bits). Every worker
collects every test file, so the share holds for the whole worker. Outside
xdist nothing changes.

References. ``jax_shapes`` traces a JAX model's variables once a process
for one configuration and input shape; ``jax_forward`` runs its eval
forward under ``jit``. JAX is imported inside them, so that the card's
tests, which run without JAX (``--noconftest -m cuda``), may import this
module.
"""

import os

import numpy as np
import torch


def _share_the_cores():
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT') or 0)
    if workers > 1:
        threads = max(1, len(os.sched_getaffinity(0)) // workers)
        torch.set_num_threads(threads)
        os.environ['OMP_NUM_THREADS'] = str(threads)


_share_the_cores()

_SHAPES = {}


def jax_shapes(cfg, shape):
    """The JAX model's variable shapes at input ``shape``, traced with
    ``jax.eval_shape`` in float32 (its init casts to the float32 params'
    dtype in places, where f64 operands meet them); one trace a
    configuration and shape."""
    import jax
    import jax.numpy as jnp
    from mvfnet_tpu.models import build_recognizer
    key = (repr(cfg), tuple(shape))
    if key not in _SHAPES:
        model = build_recognizer(cfg, test_cfg=dict(average_clips=None))
        x64 = jax.config.jax_enable_x64
        jax.config.update('jax_enable_x64', False)
        try:
            _SHAPES[key] = jax.eval_shape(lambda: model.init(
                jax.random.PRNGKey(0), jnp.zeros(shape), None,
                return_loss=False))
        finally:
            jax.config.update('jax_enable_x64', x64)
    return _SHAPES[key]


def jax_forward(cfg, variables, x):
    """The JAX model's eval logits of ``x``, under ``jit`` as its CLIs run
    it."""
    import jax
    import jax.numpy as jnp
    from mvfnet_tpu.models import build_recognizer
    model = build_recognizer(cfg, test_cfg=dict(average_clips=None))
    return np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, None, return_loss=False))(variables, jnp.asarray(x)))
