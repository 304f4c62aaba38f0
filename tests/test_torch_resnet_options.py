"""Port parity: the 2-D ResNet's remaining options against the JAX package.

ResNet-18/34 (``BasicBlock``, with and without MVF), ``avg_down``, ``avd``,
``avd_first``, ``deep_stem`` (``stem_width=32``), ``style='caffe'`` with
``avg_down``, dilation with ``avg_down``, GroupNorm (``num_groups=8``) and
``with_cp``, each built by both packages at 32x32 (T=2, B=2, 5 classes) in
f64. The weights are the port's seeded init with randomized BN statistics,
carried into the JAX layout with ``jax_variables_from_state_dict``, whose
tree must equal the JAX model's own. Forward logits agree to rtol 1e-6 /
atol 1e-8; one train step per option group, on two stages (two steps for
``with_cp``), to rtol
1e-9 on loss and gradient norm and rtol 1e-7 / atol 1e-9 on the updated
parameters and BatchNorm statistics, the tolerances of ROADMAP's weight
bridge. The Bottleneck options use two stages (layer1-2), which is where
they act, to keep the JAX compiles short.

The JAX package's ResNet cannot run three of these as it stands; the tests
pin each fault and then hold the port against the JAX code with the fault
worked around inside the test, the JAX package unedited:

- ``make_norm`` builds ``flax.linen.GroupNorm``, which every block calls
  with ``use_running_average`` and which raises ``TypeError``: the test
  wraps it in a GroupNorm that takes the argument and ignores it.
- ``make_train_step(remat=True)`` hands ``model.apply`` to
  ``jax.checkpoint`` with its keyword arguments (``mutable=['batch_stats']``
  among them), which raises ``TypeError``: the test binds the keywords
  first, so that ``jax.checkpoint`` sees the variables and inputs alone.
- ``import_torch_weights`` has no rule for ``stem_conv*``/``stem_bn*``:
  a deep-stem state dict's stem lands in ``unexpected``/``missing``.

And one where the port follows torch (the reference) and not JAX: at a map
smaller than avg_down's pool window (1x1 with window 2, layer4 of a 16x16
input) the JAX ``avg_pool_torch`` returns an empty map, torch's ceil-mode
pool one value. The parity cases run at 32x32, where every map is 2x2 or
more.
"""

import functools

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
from flax import serialization

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine import train_step as jax_train_step_mod
from mvfnet_tpu.engine.train_loop import _frozen_prefixes_from_backbone
from mvfnet_tpu.engine.train_step import TrainState
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.models import common as jax_common
from mvfnet_tpu.models.backbones import resnet as jax_resnet
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu.utils.checkpoint import load_checkpoint as jax_load
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                           build_optimizer,
                                           frozen_prefixes_from_backbone,
                                           param_label)
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.models import common
from mvfnet_tpu_torch.models.backbones import resnet
from mvfnet_tpu_torch.ops import fused_block as fb
from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                               jax_entries,
                                               jax_variables_from_state_dict,
                                               load_checkpoint,
                                               save_msgpack_checkpoint,
                                               state_dict_from_jax)
from torch_reference import jax_forward

T, B, HW, NUM_CLASSES = 2, 2, 32, 5
RTOL, ATOL = 1e-6, 1e-8                 # forward logits
STEP_RTOL = 1e-9                        # loss, gradient norm
STATE_RTOL, STATE_ATOL = 1e-7, 1e-9     # updated parameters and statistics
GN = dict(type='GN', num_groups=8)
TWO_STAGES = dict(num_stages=2, out_indices=(1,))
# name: (depth, MVF in layer2 (a stride-2 block and stride-1 ones), backbone
# options)
OPTIONS = {
    'r18': (18, False, {}),
    'r18_mvf': (18, True, {}),
    'r34': (34, False, {}),
    'r34_mvf': (34, True, {}),
    'avg_down': (50, False, dict(TWO_STAGES, avg_down=True)),
    'avd': (50, True, dict(TWO_STAGES, avd=True)),
    'avd_first': (50, False, dict(TWO_STAGES, avd=True, avd_first=True)),
    'deep_stem': (50, False, dict(TWO_STAGES, deep_stem=True,
                                  stem_width=32)),
    'caffe_avg_down': (50, False, dict(TWO_STAGES, style='caffe',
                                       avg_down=True)),
    'dilation_avg_down': (18, False, dict(avg_down=True,
                                          strides=(1, 2, 1, 1),
                                          dilations=(1, 1, 2, 4))),
    'gn': (18, True, dict(norm_cfg=GN)),
}
# one JAX train-step compile each: the option group's model and steps
STEP_GROUPS = {
    'basic_block_with_cp': ('r18_mvf', dict(TWO_STAGES, with_cp=True), 2),
    'bottleneck_options': (50, dict(TWO_STAGES, avg_down=True, avd=True,
                                    deep_stem=True, stem_width=32), 1),
    'gn': ('gn', TWO_STAGES, 1),
}
LR_CONFIG = dict(policy='step', step=[5], warmup='linear', warmup_iters=3,
                 warmup_ratio=0.1)
RECIPE = dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4,
              nesterov=True)
MAX_NORM = 2.0


class _GroupNorm(fnn.GroupNorm):
    """flax GroupNorm that takes the ``use_running_average`` the JAX ResNet
    passes every norm, and ignores it (GroupNorm has no statistics)."""

    def __call__(self, x, use_running_average=None):
        return super().__call__(x)


def _jax_make_norm(norm_cfg, *, name, dtype=jnp.float32):
    cfg = dict(norm_cfg or {'type': 'BN'})
    if cfg.get('type') == 'GN':
        return _GroupNorm(num_groups=cfg['num_groups'],
                          epsilon=jax_common.BN_EPS, dtype=dtype,
                          param_dtype=jnp.float32, name=name)
    return jax_common.make_norm(norm_cfg, name=name, dtype=dtype)


def _jax_avg_pool(x, window, stride, padding=0, count_include_pad=True,
                  ceil_mode=False):
    """The JAX package's ``avg_pool_torch`` with ``lax.add`` for its
    ``jnp.add``: ``lax.reduce_window`` differentiates a sum window only
    when it is given ``lax.add``, so the JAX package cannot train
    ``avg_down`` or ``avd`` as it stands."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_common.jnp, 'add', jax.lax.add)
        return jax_common.avg_pool_torch(x, window, stride, padding,
                                         count_include_pad, ceil_mode)


@pytest.fixture(scope='module', autouse=True)
def f64_and_jax_repairs():
    jax.config.update('jax_enable_x64', True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, 'make_norm', _jax_make_norm)
        mp.setattr(jax_resnet, 'avg_pool_torch', _jax_avg_pool)
        yield
    jax.config.update('jax_enable_x64', False)


def model_cfg(depth, mvf, backbone, dropout=0.0):
    backbone = dict(backbone)
    stages = backbone.get('num_stages', 4)
    backbone.setdefault('out_indices', (stages - 1,))
    expansion = 1 if depth < 50 else 4
    cfg = dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=depth, norm_eval=False,
                      **backbone),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=dropout,
                      in_channels=64 * 2 ** (stages - 1) * expansion,
                      init_std=0.01, num_classes=NUM_CLASSES),
        dtype=None)
    if mvf:
        cfg['module_cfg'] = dict(type='MVF', n_segment=T, alpha=0.125,
                                 mvf_freq=(1, 1, 1, 1), mode='THW')
    return cfg


def option_cfg(name, **extra):
    depth, mvf, backbone = OPTIONS[name]
    return model_cfg(depth, mvf, dict(backbone, **extra))


def port_model(cfg, seed=0):
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None)).double()
    port.init_weights(torch.Generator().manual_seed(seed), randomize_bn=True)
    return port


_SHAPES = {}


def jax_shapes(cfg):
    """The JAX model's variable shapes, traced in float32: its init casts
    activations to the float32 params' dtype in places, where the f64
    pools then refuse a float32 operand. One trace per configuration and
    norm factory."""
    key = (repr(cfg), jax_resnet.make_norm)
    if key not in _SHAPES:
        _SHAPES[key] = _trace_shapes(cfg)
    return _SHAPES[key]


def _trace_shapes(cfg):
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    jax.config.update('jax_enable_x64', False)
    try:
        return jax.eval_shape(lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 3)), None,
            return_loss=False))
    finally:
        jax.config.update('jax_enable_x64', True)


def jax_variables(port, cfg):
    """The port's weights in the JAX layout; their tree is the JAX
    model's."""
    variables = jax_variables_from_state_dict(port.state_dict())
    shapes = jax_shapes(cfg)
    want = {jax.tree_util.keystr(p): s.shape for p, s in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): v.shape for p, v in
           jax.tree_util.tree_leaves_with_path(
               {k: variables[k] for k in shapes})}
    assert got == want
    return {k: variables[k] for k in shapes}


def frames(seed, steps=None):
    rng = np.random.RandomState(seed)
    lead = (B,) if steps is None else (steps, B)
    return rng.randn(*lead, T, HW, HW, 3) * 0.5


@pytest.mark.parametrize('name', sorted(OPTIONS))
def test_forward_matches_jax(name):
    cfg = option_cfg(name)
    port = port_model(cfg).eval()
    variables = jax_variables(port, cfg)
    x = frames(1)
    want = jax_forward(cfg, variables, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.shape == (B, NUM_CLASSES) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


_JAX_CHECKPOINT = jax.checkpoint


def _jax_remat_repaired(fun, **kwargs):
    """``jax.checkpoint`` as ``make_train_step(remat=True)`` needs it: the
    keyword arguments of ``model.apply`` (``mutable`` and ``rngs`` among
    them) bound before the remat, the variables and inputs traced."""
    def call(*args, **kw):
        return _JAX_CHECKPOINT(functools.partial(fun, **kw), **kwargs)(*args)
    return call


def _step_group(group):
    key, extra, steps = STEP_GROUPS[group]
    if isinstance(key, str):
        cfg = option_cfg(key, **extra)
    else:
        cfg = model_cfg(key, False, extra)
    return cfg, steps


def _jax_trajectory(cfg, variables, steps, remat):
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    sched = jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    tx = jax_optim.build_optimizer(
        variables['params'], RECIPE, sched,
        grad_clip=dict(max_norm=MAX_NORM, norm_type=2),
        frozen_prefixes=_frozen_prefixes_from_backbone(cfg['backbone']))
    step = jax_train_step_mod.make_train_step(jmodel, tx, mesh=None,
                                              donate=False, remat=remat)
    state = TrainState.create(variables, tx)
    imgs = frames(7, steps)
    labels = np.random.RandomState(8).randint(0, NUM_CLASSES, (steps, B))
    metrics = []
    for i in range(steps):
        state, m = step(state, jnp.asarray(imgs[i]), jnp.asarray(labels[i]),
                        jax.random.PRNGKey(0))
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics, state.variables()


def _port_trajectory(cfg, port, steps, remat):
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    opt = build_optimizer(
        port, RECIPE, sched, grad_clip=dict(max_norm=MAX_NORM, norm_type=2),
        frozen_prefixes=frozen_prefixes_from_backbone(cfg['backbone']))
    step = make_train_step(port, opt, sched, device='cpu', remat=remat)
    imgs = frames(7, steps)
    labels = np.random.RandomState(8).randint(0, NUM_CLASSES, (steps, B))
    metrics = []
    for i in range(steps):
        m = step(imgs[i], labels[i])
        metrics.append((m['loss'].item(), m['grad_norm'].item()))
    return metrics, {k: v.detach().clone() for k, v in
                     port.state_dict().items()}


@pytest.mark.parametrize('group', sorted(STEP_GROUPS))
def test_train_step_matches_jax(group, monkeypatch):
    cfg, steps = _step_group(group)
    remat = bool(cfg['backbone'].get('with_cp'))
    port = port_model(cfg)
    variables = jax_variables(port, cfg)
    if remat:
        monkeypatch.setattr(jax, 'checkpoint', _jax_remat_repaired)
    want, jvars = _jax_trajectory(cfg, variables, steps, remat)
    got, state = _port_trajectory(cfg, port, steps, remat)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    stats = 0
    for coll, path, name, value in jax_entries(
            jax.tree_util.tree_map(np.asarray, jvars)):
        np.testing.assert_allclose(state[name].numpy(), value,
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=path)
        stats += coll == 'batch_stats'
    assert stats > 0 if group != 'gn' else True


def test_with_cp_equals_the_step_without_it():
    """Two steps with and without ``with_cp`` from one state: the same
    losses, gradient norms, parameters and BatchNorm statistics (MVF's
    included), and each BatchNorm counted two batches, not four."""
    cfg = option_cfg('r18_mvf')
    runs = []
    for remat in (False, True):
        port = port_model(cfg)
        runs.append(_port_trajectory(cfg, port, 2, remat))
        assert port.backbone.with_cp is remat
    (plain, plain_state), (cp, cp_state) = runs
    np.testing.assert_allclose(cp, plain, rtol=1e-12)
    assert set(cp_state) == set(plain_state)
    for k, v in plain_state.items():
        np.testing.assert_allclose(cp_state[k].numpy(), v.numpy(),
                                   rtol=1e-12, atol=0, err_msg=k)
    counts = {k: int(v) for k, v in cp_state.items()
              if k.endswith('num_batches_tracked')}
    assert any('conv1.bn.' in k for k in counts)       # MVF's BatchNorm
    assert set(counts.values()) == {2}


def test_jax_package_faults_pinned():
    """What the JAX package does with these options as it stands (the
    faults the parity tests work around; ROADMAP.md, section C)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, 'make_norm', jax_common.make_norm)
        with pytest.raises(TypeError, match='use_running_average'):
            jax_shapes(option_cfg('gn'))

    cfg = option_cfg('r18_mvf')
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    variables = jax_variables(port_model(cfg), cfg)
    tx = jax_optim.build_optimizer(
        variables['params'], RECIPE,
        jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8))
    step = jax_train_step_mod.make_train_step(jmodel, tx, mesh=None,
                                              donate=False, remat=True)
    with pytest.raises(TypeError, match='not a valid JAX type'):
        step(TrainState.create(variables, tx), jnp.asarray(frames(7)),
             jnp.zeros((B,), jnp.int32), jax.random.PRNGKey(0))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_resnet, 'avg_pool_torch', jax_common.avg_pool_torch)
        with pytest.raises(ValueError, match='Linearization failed'):
            jax.grad(lambda x: jax_common.avg_pool_torch(
                x, 2, 2, ceil_mode=True, count_include_pad=False).sum())(
                jnp.ones((1, 4, 4, 2)))


@pytest.mark.parametrize('window,stride,padding,include,ceil', [
    (3, 2, 1, True, False),             # avd
    (2, 2, 0, False, True),             # avg_down
], ids=['avd', 'avg_down'])
def test_avg_pool_matches_jax_down_to_2x2(window, stride, padding, include,
                                          ceil):
    rng = np.random.RandomState(0)
    for size in (2, 3, 5, 7, 14):
        x = rng.randn(2, size, size + 1, 3)
        want = np.asarray(jax_common.avg_pool_torch(
            jnp.asarray(x), window, stride, padding, include, ceil))
        got = common.avg_pool_torch(torch.from_numpy(x).permute(0, 3, 1, 2),
                                    window, stride, padding, include, ceil)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                   rtol=1e-12, atol=0, err_msg=str(size))
    # below the window the port follows torch: one value, not none
    one = np.arange(4.0).reshape(1, 1, 1, 4)
    got = common.avg_pool_torch(torch.from_numpy(one).permute(0, 3, 1, 2),
                                window, stride, padding, include, ceil)
    jax_out = jax_common.avg_pool_torch(jnp.asarray(one), window, stride,
                                        padding, include, ceil)
    assert tuple(got.shape) == (1, 4, 1, 1)
    if ceil:
        assert jax_out.shape == (1, 0, 0, 4)
        np.testing.assert_array_equal(got.flatten().numpy(), one.flatten())
    else:
        assert jax_out.shape == (1, 1, 1, 4)


def test_avg_down_at_16x16_pins_the_jax_empty_map():
    """ResNet-18 with avg_down at 16x16: layer4's shortcut pools a 1x1 map.
    The JAX package's pool gives an empty map, so its logits are NaN (a
    mean over nothing); the port's one value, so its logits are finite."""
    cfg = option_cfg('dilation_avg_down', strides=(1, 2, 2, 2),
                     dilations=(1, 1, 1, 1))
    port = port_model(cfg).eval()
    x = np.random.RandomState(1).randn(B, T, 16, 16, 3)
    want = jax_forward(cfg, jax_variables(port, cfg), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.shape == want.shape == (B, NUM_CLASSES)
    assert np.isfinite(got).all() and np.isnan(want).all()


def _template(cfg):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float64),
                                  jax_shapes(cfg))


@pytest.mark.parametrize('name', sorted(OPTIONS))
def test_state_dict_imports_into_jax(name):
    """Every option's ``state_dict()`` through the JAX importer: an empty
    report and the bridge's values, but for the deep stem, whose keys the
    JAX importer has no rule for."""
    cfg = option_cfg(name)
    port = port_model(cfg)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back, report = import_torch_weights(sd, _template(cfg),
                                        return_report=True)
    stem = sorted(k for k in sd if '.stem_' in k
                  and not k.endswith('num_batches_tracked'))
    assert bool(stem) == (name == 'deep_stem')
    assert report['mismatched'] == []
    assert sorted(report['unexpected']) == stem
    assert len(report['missing']) == len(stem)
    assert all('/stem_' in k for k in report['missing'])
    want = state_dict_from_jax(jax_variables_from_state_dict(
        port.state_dict()))
    for coll, path, torch_name, value in jax_entries(back):
        if '/stem_' not in path:
            np.testing.assert_array_equal(value, want[torch_name].numpy(),
                                          err_msg=path)


@pytest.mark.parametrize('name', ['r18_mvf', 'avg_down', 'deep_stem', 'gn'])
def test_msgpack_round_trip(name, tmp_path):
    """Port -> ``.msgpack`` -> the JAX package's loader, and the JAX
    package's writer -> the port, bit-equal; GroupNorm has no
    ``batch_stats`` entries."""
    cfg = option_cfg(name)
    port = port_model(cfg)
    state = port.state_dict()
    path = str(tmp_path / 'port.msgpack')
    save_msgpack_checkpoint(path, port, meta={'epoch': 1, 'iter': 0})
    variables_sd, _, _ = jax_load(path)
    template = _template(cfg)
    restored = {k: serialization.from_state_dict(template[k], variables_sd[k])
                for k in template}
    for _, jpath, torch_name, value in jax_entries(restored):
        np.testing.assert_array_equal(value, state[torch_name].numpy(),
                                      err_msg=jpath)
    if name == 'gn':
        assert not any('bn1' in p for p in jax.tree_util.keystr(
            restored.get('batch_stats', {})).split('/'))
    jpath = str(tmp_path / 'jax.msgpack')
    jax_save(jpath, restored, meta={'epoch': 2, 'iter': 8})
    loaded, _, meta = load_checkpoint(jpath)
    assert meta == {'epoch': 2, 'iter': 8}
    fresh = build_recognizer(cfg).double()
    fresh.load_state_dict(loaded, strict=True)
    for k, v in state.items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(fresh.state_dict()[k], v), k


def test_reference_avg_down_layout():
    """The reference's avg_down shortcut is ``Sequential(pool, conv,
    norm)``: its conv at ``downsample.1``, its norm at ``downsample.2``.
    The port loads such a dict into its ``downsample.{0,1}``; the JAX
    importer takes the conv for the norm and leaves its conv missing."""
    cfg = option_cfg('avg_down')
    port = port_model(cfg)
    ref = {}
    for k, v in port.state_dict().items():
        for i in ('1', '0'):
            k = k.replace(f'.downsample.{i}.', f'.downsample.{int(i) + 1}.')
        ref[k] = v
    assert 'backbone.layer2.0.downsample.2.running_var' in ref
    fresh = port_model(cfg, seed=1)
    report = import_torch_state_dict(fresh, ref)
    assert report['missing'] == report['unexpected'] == \
        report['mismatched'] == []
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k

    _, jreport = import_torch_weights(
        {k: v.numpy() for k, v in ref.items()}, _template(cfg),
        return_report=True)
    convs = sorted(k for k in ref if k.endswith('downsample.1.weight'))
    assert len(convs) == 2
    assert sorted(jreport['unexpected']) == convs
    assert len(jreport['mismatched']) == 2
    assert sorted(k for k in jreport['missing']) == [
        f'params:backbone_mod/layer{i}_0/downsample_conv/kernel'
        for i in (1, 2)]


@pytest.mark.parametrize('name,backbone', [
    ('deep_stem', dict(frozen_stages=1)), ('avg_down', {}), ('gn', {}),
    ('gn', dict(norm_frozen=True))],
    ids=['deep_stem_frozen', 'avg_down', 'gn', 'gn_norm_frozen'])
def test_param_labels_match_jax(name, backbone):
    """The JAX optimizer's labels on the new names: the deep stem's and a
    GroupNorm's affines are norm parameters (frozen with the stem), the
    avg_down shortcut's norm is labelled as the plain one (the reference's
    regex misses it)."""
    cfg = option_cfg(name, **backbone)
    shapes = jax_shapes(cfg)
    labels = jax_optim.masked_labels(
        shapes['params'], _frozen_prefixes_from_backbone(cfg['backbone']))
    names = {path: torch_name for coll, path, torch_name, _ in jax_entries(
        _template(cfg)) if coll == 'params'}
    want = {names['/'.join(k.key for k in p)]: label for p, label in
            jax.tree_util.tree_leaves_with_path(labels)}
    port = build_recognizer(cfg)
    prefixes = frozen_prefixes_from_backbone(cfg['backbone'])
    got = {n: param_label(n, prefixes) for n, _ in port.named_parameters()}
    assert got == want
    if name == 'deep_stem':
        assert got['backbone.stem_bn1.weight'] == 'frozen'
    if name == 'avg_down':
        assert got['backbone.layer2.0.downsample.1.weight'] == 'default'
    if name == 'gn' and not backbone:
        assert got['backbone.layer1.0.bn1.weight'] == 'norm'


def test_fused_kernel_skips_gn_avd_and_basic_blocks(monkeypatch):
    """In eval with no gradient the fused kernel takes each stride-1
    Bottleneck with BatchNorm and no downsample or MVF: layer1.1-2 and
    layer2.1-3 of two stages, the avd block (stride 2) excluded; none of a
    GroupNorm model or a BasicBlock model."""
    calls = []
    real = fb.bottleneck_eval
    monkeypatch.setattr(fb, 'bottleneck_eval',
                        lambda *a: calls.append(1) or real(*a))
    for name, want in (('avd_first', 5), ('r18', 0)):
        calls.clear()
        port = port_model(option_cfg(name)).eval()
        with torch.no_grad():
            port(torch.from_numpy(frames(1)), None, return_loss=False)
        assert len(calls) == want, name
    gn = port_model(model_cfg(50, False, dict(TWO_STAGES, norm_cfg=GN)))
    assert not any(getattr(m, 'fusable', False)
                   for m in gn.modules()), 'a GroupNorm block is fusable'
    calls.clear()
    with torch.no_grad():
        gn.eval()(torch.from_numpy(frames(1)), None, return_loss=False)
    assert calls == []


def test_group_norm_computes_in_fp32_and_returns_the_input_dtype():
    norm = common.make_norm(GN, 32)
    assert isinstance(norm, common.GroupNorm) and norm.eps == common.BN_EPS
    assert norm.weight.dtype == torch.float32
    x = torch.randn(2, 32, 3, 3).to(torch.bfloat16)
    got = norm(x)
    want = torch.nn.functional.group_norm(x.float(), 8, norm.weight,
                                          norm.bias, common.BN_EPS)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(KeyError, match='LN'):
        common.make_norm(dict(type='LN'), 4)
    with pytest.raises(KeyError, match='depth 26'):
        resnet.ResNet(depth=26)
