"""The port's train-step pieces, each on its own (CPU).

- LR schedules against the JAX package's ``build_lr_schedule`` (f64)
- parameter labels of the R50+MVF port model against the JAX
  ``masked_labels`` of each counterpart, frozen stages and ``norm_frozen``
  included
- five SGD steps on a small parameter tree against the JAX
  ``build_optimizer`` (f64), clipped at every step or at none
- the head's dropout with an explicit generator
- the fused eval path's fold cache after training, in either order, and
  after an update made in eval mode
- bf16 compute with fp32 parameters gives fp32 gradients
- ``make_train_step`` without a device raises where CUDA is absent
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine.train_loop import _frozen_prefixes_from_backbone
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                           build_optimizer,
                                           frozen_prefixes_from_backbone,
                                           param_label)
from mvfnet_tpu_torch.engine.train_step import (make_eval_step,
                                                make_train_step)
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.models.heads.tsn_head import TSNClsHead
from mvfnet_tpu_torch.utils.checkpoint import jax_entries

T, HW, NUM_CLASSES = 2, 32, 8


@pytest.fixture(scope='module')
def f64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


def model_cfg(**backbone):
    return dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=50, out_indices=(3,),
                      norm_eval=False, norm_cfg=dict(type='BN'), **backbone),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.0, in_channels=2048, init_std=0.01,
                      num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'),
        dtype=None,
    )


# -- LR schedules -----------------------------------------------------------

SCHEDULES = {
    # milestones at steps 4 and 12; the first lies inside the warmup
    'step_warmup': dict(policy='step', step=[1, 3], warmup='linear',
                        warmup_iters=10, warmup_ratio=0.01),
    'step': dict(policy='step', step=[2, 5], gamma=0.5),
    'cosine_warmup': dict(policy='cosine', warmup='linear', warmup_iters=7,
                          warmup_ratio=0.1),
    'cosine': dict(policy='cosine', min_lr_ratio=0.05),
}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_lr_schedule_matches_jax(f64, name):
    cfg = SCHEDULES[name]
    want = jax_optim.build_lr_schedule(cfg, 0.015, 4, 7)
    got = build_lr_schedule(cfg, 0.015, 4, 7)
    steps = range(41)                     # past the cosine's 28 steps
    w = [float(want(jnp.asarray(t))) for t in steps]
    g = [got(t) for t in steps]
    assert all(isinstance(v, float) for v in g)
    np.testing.assert_allclose(g, w, rtol=1e-13, atol=0)
    assert len(set(g)) >= 3


def test_milestone_inside_warmup_decays_first():
    sched = build_lr_schedule(SCHEDULES['step_warmup'], 1.0, 4, 7)
    # step 5: decayed once (0.1), warmup factor 1 - (1 - 5/10) * 0.99
    assert sched(5) == pytest.approx(0.1 * (1 - 0.5 * 0.99), rel=1e-15)
    assert sched(10) == pytest.approx(0.1, rel=1e-15)
    assert sched(12) == pytest.approx(0.01, rel=1e-15)


# -- parameter labels -------------------------------------------------------

def _jax_params_shapes(model):
    """The JAX recognizer's params as zero arrays (no compile)."""
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, T, HW, HW, 3)),
                           jnp.zeros((1,), jnp.int32), return_loss=True))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize('backbone', [
    {}, dict(frozen_stages=1), dict(norm_frozen=True),
    dict(frozen_stages=2, norm_frozen=True)],
    ids=['none', 'frozen_stages_1', 'norm_frozen', 'both'])
def test_param_labels_match_jax(backbone):
    cfg = model_cfg(**backbone)
    variables = _jax_params_shapes(jax_build(cfg))
    want_tree = jax_optim.masked_labels(
        variables['params'],
        _frozen_prefixes_from_backbone(cfg['backbone']))
    want_flat = {'/'.join(k.key for k in path): label for path, label in
                 jax.tree_util.tree_leaves_with_path(want_tree)}
    names = {path: name for coll, path, name, _ in jax_entries(variables)
             if coll == 'params'}
    want = {names[path]: label for path, label in want_flat.items()}

    port = build_recognizer(cfg)
    prefixes = frozen_prefixes_from_backbone(cfg['backbone'])
    got = {name: param_label(name, prefixes)
           for name, _ in port.named_parameters()}
    assert got == want
    # the reference's regex misses a downsample's BN
    assert got['backbone.layer3.0.downsample.1.weight'] == 'default'
    assert got['backbone.layer3.0.downsample.1.bias'] == 'bias'
    assert got['backbone.layer3.0.conv1.bn.weight'] in ('norm', 'frozen')
    # norm_frozen leaves no 'norm' label: every BN is in the backbone
    assert set(got.values()) == (
        {'default', 'bias'} | ({'frozen'} if backbone else set())
        | (set() if backbone.get('norm_frozen') else {'norm'}))


# -- clipped SGD on a small tree --------------------------------------------

SMALL_TREE = {
    'backbone_mod': {
        'conv1': {'kernel': (3, 3, 2, 4)},
        'bn1': {'scale': (4,), 'bias': (4,)},
        'layer1_0': {'conv1': {'kernel': (1, 1, 4, 4)},
                     'bn1': {'scale': (4,), 'bias': (4,)},
                     'downsample_bn': {'scale': (4,), 'bias': (4,)}},
        'layer2_0': {'conv2': {'kernel': (3, 3, 4, 4)},
                     'bn2': {'scale': (4,), 'bias': (4,)}},
    },
    'head_mod': {'fc': {'kernel': (4, 5), 'bias': (5,)}},
}


def _module_with(named):
    """An nn.Module whose parameters carry the given dotted names."""
    root = torch.nn.Module()
    for name, value in named.items():
        *path, leaf = name.split('.')
        mod = root
        for p in path:
            if not hasattr(mod, p):
                mod.add_module(p, torch.nn.Module())
            mod = getattr(mod, p)
        mod.register_parameter(leaf, torch.nn.Parameter(
            torch.tensor(value)))
    return root


def _torch_layout(tree):
    return {name: v for _, _, name, v in jax_entries({'params': tree})}


@pytest.mark.parametrize('case', ['recipe', 'paramwise_frozen',
                                  'recipe_unclipped'])
def test_clipped_sgd_matches_jax(f64, case):
    rng = np.random.RandomState(3)
    params = jax.tree_util.tree_map(lambda s: rng.randn(*s),
                                    SMALL_TREE,
                                    is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree_util.tree_map(lambda p: rng.randn(*p.shape) * 2,
                                    params) for _ in range(5)]
    opt_cfg = dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-2,
                   nesterov=True)
    prefixes = (), ()
    if case == 'paramwise_frozen':
        opt_cfg['paramwise_options'] = dict(bias_lr_mult=2.0,
                                            bias_decay_mult=0.5,
                                            norm_decay_mult=0.0)
        prefixes = (('backbone_mod/conv1', 'backbone_mod/layer1_'),
                    ('backbone.conv1.', 'backbone.layer1.'))
    lr_cfg = dict(policy='step', step=[3], warmup='linear', warmup_iters=2)
    # the gradients' norms are 34 to 35: 6 clips every step, 40 none
    clip = dict(max_norm=40.0 if case == 'recipe_unclipped' else 6.0,
                norm_type=2)

    tx = jax_optim.build_optimizer(
        params, opt_cfg, jax_optim.build_lr_schedule(lr_cfg, 0.1, 1, 5),
        grad_clip=clip, frozen_prefixes=prefixes[0])
    state = tx.init(params)
    jparams = params

    module = _module_with(_torch_layout(params))
    sched = build_lr_schedule(lr_cfg, 0.1, 1, 5)
    opt = build_optimizer(module, opt_cfg, sched, grad_clip=clip,
                          frozen_prefixes=prefixes[1])
    norms = []
    for t, g in enumerate(grads):
        updates, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tg = _torch_layout(g)
        for name, p in module.named_parameters():
            p.grad = torch.tensor(tg[name])
        norms.append((opt.clip_grads().item(), float(optax.global_norm(g))))
        opt.set_lr(sched(t))
        opt.step()
    got, want = np.array(norms).T
    np.testing.assert_allclose(got, want, rtol=1e-13)
    clipped = want > clip['max_norm']
    assert not clipped.any() if case == 'recipe_unclipped' else clipped.all()
    final = _torch_layout(jparams)
    start = _torch_layout(params)
    for name, p in module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), final[name],
                                   rtol=1e-12, atol=1e-14, err_msg=name)
        assert np.array_equal(p.detach().numpy(), start[name]) == \
            name.startswith(prefixes[1] or ('-',))


# -- dropout -----------------------------------------------------------------

def test_dropout_takes_an_explicit_generator():
    head = TSNClsHead(dropout_ratio=0.25, in_channels=64, num_classes=5)
    feat = torch.rand(400, 64) + 0.5

    def draw(seed):
        return head.dropout(feat, torch.Generator().manual_seed(seed))

    head.train()
    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    kept = a != 0
    torch.testing.assert_close(a[kept], feat[kept] / 0.75, rtol=0, atol=0)
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    # the same mask through the forward: the features' spatial mean first
    x = feat[:, None, None, :].expand(400, 2, 3, 64)
    score = head(x, 1, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(score, head.fc(a), rtol=1e-6, atol=1e-6)
    head.eval()
    assert draw(0) is feat
    head.dropout_ratio = 0.0
    head.train()
    assert draw(0) is feat


# -- the fold cache after training ------------------------------------------

def _trainable_port(seed):
    """R50's first two stages: ``layer1.1-2`` and ``layer2.1-3`` fuse in
    eval."""
    cfg = model_cfg(num_stages=2)
    cfg['backbone'] = dict(cfg['backbone'], out_indices=(1,))
    cfg['cls_head'] = dict(cfg['cls_head'], in_channels=512)
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None))
    port.init_weights(torch.Generator().manual_seed(seed), randomize_bn=True)
    return port.double()


@pytest.mark.parametrize('order', ['train_eval', 'eval_train_eval',
                                   'eval_sgd_eval'])
def test_fold_cache_follows_training(order):
    """Eval scores after training equal a fresh model's loaded from the
    trained state: train() drops the folded weights, and an update made in
    eval mode (no train() call) moves the version counters they are keyed
    on."""
    port = _trainable_port(0)
    rng = np.random.RandomState(5)
    frames = rng.randn(1, 2 * T, HW, HW, 3)
    eval_step = make_eval_step(port, device='cpu')
    first = eval_step(port, frames)
    if order == 'train_eval':
        port = _trainable_port(0)
    cfg = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-4)
    sched = build_lr_schedule(dict(policy='step', step=[10]), 0.05, 1, 1)
    opt = build_optimizer(port, cfg, sched)
    if order == 'eval_sgd_eval':
        gen = torch.Generator().manual_seed(0)
        for p in port.parameters():
            p.grad = torch.randn(p.shape, generator=gen,
                                 dtype=p.dtype) * 0.1
        opt.step()
    else:
        step = make_train_step(port, opt, sched, device='cpu')
        for _ in range(2):
            m = step(rng.randn(2, T, HW, HW, 3),
                     rng.randint(0, NUM_CLASSES, 2))
            assert torch.isfinite(m['loss']) and torch.isfinite(
                m['grad_norm'])
        port.eval()
    assert not port.training
    got = eval_step(port, frames)
    fresh = _trainable_port(1)
    fresh.load_state_dict(copy.deepcopy(port.state_dict()))
    want = make_eval_step(fresh, device='cpu')(fresh, frames)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert not torch.allclose(got, first)


def test_bf16_compute_gives_fp32_grads():
    """R50's first two stages with MVF in the first: every parameter, MVF's
    too, gets an fp32 gradient from bf16 compute."""
    cfg = model_cfg(num_stages=2)
    cfg['backbone'] = dict(cfg['backbone'], out_indices=(1,))
    cfg['module_cfg'] = dict(cfg['module_cfg'], mvf_freq=(1, 0))
    cfg['cls_head'] = dict(cfg['cls_head'], in_channels=512)
    port = build_recognizer(dict(cfg, dtype='bfloat16'))
    port.init_weights(torch.Generator().manual_seed(0))
    sched = build_lr_schedule(dict(policy='step', step=[10]), 0.01, 1, 1)
    opt = build_optimizer(port, dict(type='SGD', lr=0.01, momentum=0.9),
                          sched, grad_clip=dict(max_norm=40))
    step = make_train_step(port, opt, sched, device='cpu')
    rng = np.random.RandomState(0)
    m = step(rng.randint(0, 256, (1, T, HW, HW, 3), dtype=np.uint8),
             np.array([3]))
    assert m['loss'].dtype == torch.float32     # promoted from bf16 logits
    assert torch.isfinite(m['loss']) and torch.isfinite(m['grad_norm'])
    for name, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p.grad).all()), name


def test_make_train_step_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    port = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_train_step(port, None, lambda t: 0.1)
