"""Port parity: the train step's trajectory in f64 against the JAX package.

R50+MVF (T=2, B=2, 64x64, 8 classes, dropout 0, compute in the params'
dtype), initialised by the JAX package with its BN statistics as made,
carried into the port with ``state_dict_from_jax``. Up to six steps of
the JAX package's ``make_train_step`` and as many of the port's on the
same frames:
per-step ``loss`` and ``grad_norm`` to rtol 1e-9, the final parameters and
BN running statistics to rtol 1e-7 / atol 1e-9 (the tolerances of
``tests/test_train_trajectory_parity.py``). Dropout is off because the two
frameworks' random bits cannot match; ``tests/test_torch_optim.py`` tests
the port's dropout on its own.

Cases: the K400 recipe (SGD nesterov, wd 1e-4, warmup of 3 iterations, a
milestone at step 5), a paramwise case (``bias_lr_mult=2``,
``norm_decay_mult=0``, ``frozen_stages=1``), both clipping at every step,
and the recipe's own clip of 40 over four steps, the last of which the clip
leaves alone (its gradient norm is 26). The six-step recipe case clips at
2, as the JAX trajectory test does: at 40 the steps are 20 times larger and f64
rounding grows 10 to 100 times per step from step 2, to 3e-8 (loss) and
6e-7 (grad norm) relative by step 5, and the JAX package's own step and
the hand-written reference loop of ``tests/torch_oracle.py`` part by as
much (6e-8 and 7e-7). At four steps the gap is 3e-11, well inside rtol
1e-9. Run as a script, this file prints those per-step gaps.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine.train_loop import _frozen_prefixes_from_backbone
from mvfnet_tpu.engine.train_step import TrainState
from mvfnet_tpu.engine.train_step import make_train_step as jax_train_step
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                           build_optimizer,
                                           frozen_prefixes_from_backbone)
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.utils.checkpoint import state_dict_from_jax

T, B, HW, NUM_CLASSES, N_STEPS = 2, 2, 64, 8, 6
LR_CONFIG = dict(policy='step', step=[5], warmup='linear', warmup_iters=3,
                 warmup_ratio=0.1)
RECIPE = dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4,
              nesterov=True)
# ``clipped``: whether the clip engages at each step (grad norm > max_norm)
CASES = {
    'k400_recipe': dict(optimizer=RECIPE, max_norm=2.0, backbone={},
                        clipped=(True,) * N_STEPS),
    'k400_recipe_clip40': dict(optimizer=RECIPE, max_norm=40.0, backbone={},
                               clipped=(True, True, True, False)),
    'paramwise_frozen': dict(
        optimizer=dict(RECIPE, paramwise_options=dict(bias_lr_mult=2.0,
                                                      norm_decay_mult=0.0)),
        max_norm=0.5, backbone=dict(frozen_stages=1),
        clipped=(True,) * N_STEPS),
}


def model_cfg(backbone):
    return dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=50, out_indices=(3,),
                      norm_eval=False,
                      norm_cfg=dict(type='BN', requires_grad=True),
                      **backbone),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.0, in_channels=2048, init_std=0.01,
                      num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'),
        dtype=None,
    )


@pytest.fixture(scope='module')
def f64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


def _data():
    rng = np.random.RandomState(7)
    imgs = rng.randn(N_STEPS, B, T, HW, HW, 3) * 0.5
    labels = rng.randint(0, NUM_CLASSES, size=(N_STEPS, B))
    return imgs, labels


@pytest.fixture(scope='module')
def data():
    return _data()


def _jax_variables(model):
    init = jax.jit(lambda key, x, y: model.init(
        {'params': key, 'dropout': key}, x, y, return_loss=True, train=True))
    variables = init(jax.random.PRNGKey(0),
                     jnp.zeros((1, T, HW, HW, 3), jnp.float64),
                     jnp.zeros((1,), jnp.int32))
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                  variables)


def _both_steps(cfg, variables, optimizer_cfg, max_norm):
    """The JAX package's step with its state and schedule, and the port's
    model and step, from the same variables."""
    grad_clip = dict(max_norm=max_norm, norm_type=2)
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    jsched = jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1,
                                         N_STEPS)
    tx = jax_optim.build_optimizer(
        variables['params'], optimizer_cfg, jsched, grad_clip=grad_clip,
        frozen_prefixes=_frozen_prefixes_from_backbone(cfg['backbone']))
    jstep = jax_train_step(jmodel, tx, mesh=None, donate=False)
    jstate = TrainState.create(variables, tx)

    port = build_recognizer(cfg, test_cfg=dict(average_clips=None)).double()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, N_STEPS)
    opt = build_optimizer(
        port, optimizer_cfg, sched, grad_clip=grad_clip,
        frozen_prefixes=frozen_prefixes_from_backbone(cfg['backbone']))
    step = make_train_step(port, opt, sched, device='cpu')
    return jstep, jstate, jsched, port, step


@pytest.fixture(scope='module')
def variables(f64):
    """The JAX package's initial variables, one init for every case:
    ``frozen_stages`` changes the optimizer, not the variables."""
    return _jax_variables(jax_build(model_cfg({})))


@pytest.mark.parametrize('case', sorted(CASES))
def test_train_trajectory_matches_jax(f64, data, variables, case):
    imgs, labels = data
    spec = CASES[case]
    cfg = model_cfg(spec['backbone'])
    jstep, jstate, jsched, port, step = _both_steps(
        cfg, variables, spec['optimizer'], spec['max_norm'])
    before = {k: v.clone() for k, v in port.state_dict().items()}

    steps = len(spec['clipped'])
    want, got = [], []
    for t in range(steps):
        jstate, m = jstep(jstate, jnp.asarray(imgs[t]),
                          jnp.asarray(labels[t]), jax.random.PRNGKey(t))
        want.append((float(m['loss']), float(m['grad_norm'])))
        m = step(imgs[t], labels[t])
        assert m['loss'].dtype == torch.float64
        assert m['lr'] == pytest.approx(float(jsched(t)), rel=1e-15)
        got.append((m['loss'].item(), m['grad_norm'].item()))
    assert step.state.step == steps
    np.testing.assert_allclose(got, want, rtol=1e-9)
    assert want[0][0] != want[-1][0]            # the trajectory moved
    assert tuple(g > spec['max_norm'] for _, g in want) == spec['clipped']

    ref = state_dict_from_jax(jstate.variables())
    ours = port.state_dict()
    assert set(ref) == set(ours)
    for k, v in ref.items():
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-7,
                                   atol=1e-9, err_msg=k)
        frozen = case == 'paramwise_frozen' and k.startswith(
            ('backbone.conv1.', 'backbone.bn1.weight', 'backbone.bn1.bias',
             'backbone.layer1.')) and 'running' not in k
        assert torch.equal(ours[k], before[k]) == frozen, k


def print_trajectory_gaps(max_norm, init):
    """Print, for each of the six steps of the recipe at clip ``max_norm``,
    the JAX step's loss and grad norm and the relative gaps of the port's
    step to them; from ``init='oracle'`` (the hand-written reference model
    of ``tests/torch_oracle.py``, imported as
    ``tests/test_train_trajectory_parity.py`` does) also the gaps of that
    reference's own loop. ``init='jax'`` starts from this file's weights."""
    import torch.nn.functional as F

    import test_train_trajectory_parity as tp

    jax.config.update('jax_enable_x64', True)
    imgs, labels = _data()
    cfg = model_cfg({})
    oracle = tp._fresh_oracle(0) if init == 'oracle' else None
    variables = jax.tree_util.tree_map(
        np.asarray, tp._import_into_flax(oracle) if oracle is not None
        else _jax_variables(jax_build(cfg)))
    jstep, jstate, _, _, step = _both_steps(cfg, variables, RECIPE, max_norm)
    if oracle is not None:
        opt = tp.build_torch_optimizer(oracle, RECIPE['lr'], 0.9, 1e-4, True)
        base = [g['lr'] for g in opt.param_groups]
        oracle.train()
    print(f'init={init} max_norm={max_norm}: step, JAX loss, JAX grad norm, '
          'relative gaps to JAX in loss and grad norm of the port'
          + (' and of the reference loop' if oracle is not None else ''))
    for t in range(N_STEPS):
        jstate, m = jstep(jstate, jnp.asarray(imgs[t]),
                          jnp.asarray(labels[t]), jax.random.PRNGKey(t))
        loss, norm = float(m['loss']), float(m['grad_norm'])
        pm = step(imgs[t], labels[t])
        row = [loss, norm, abs(pm['loss'].item() - loss) / loss,
               abs(pm['grad_norm'].item() - norm) / norm]
        if oracle is not None:
            for g, lr0 in zip(opt.param_groups, base):
                g['lr'] = lr0 * tp.lr_factor(t)
            x = torch.from_numpy(imgs[t].reshape(B * T, HW, HW, 3)
                                 .transpose(0, 3, 1, 2))
            opt.zero_grad()
            oloss = F.cross_entropy(oracle(x), torch.from_numpy(labels[t]))
            oloss.backward()
            onorm = torch.nn.utils.clip_grad_norm_(oracle.parameters(),
                                                   max_norm).item()
            opt.step()
            row += [abs(oloss.item() - loss) / loss, abs(onorm - norm) / norm]
        print(t, ' '.join(f'{v:.3e}' for v in row), flush=True)


if __name__ == '__main__':
    # python tests/test_torch_train_step.py [max_norm] [oracle|jax]
    import sys
    print_trajectory_gaps(float(sys.argv[1]) if len(sys.argv) > 1 else 40.0,
                          sys.argv[2] if len(sys.argv) > 2 else 'oracle')
