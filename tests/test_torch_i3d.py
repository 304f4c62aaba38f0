"""Port parity: I3D (``ResNet_I3D``, ``I3DClsHead``, ``Recognizer3D``).

Each case builds the model in both packages at (B=2, 1 clip, T=8, 32x32,
5 classes) in f64. The weights are the port's seeded init with randomized
BatchNorm statistics, carried into the JAX layout with
``jax_variables_from_state_dict``, whose tree must equal the JAX model's
own (traced with ``jax.eval_shape``). Forward logits agree to rtol 1e-6 /
atol 1e-8; a train step to rtol 1e-9 on the loss and gradient norm and
rtol 1e-7 / atol 1e-9 on the updated parameters and BatchNorm statistics.
The cases: the I3D config's backbone (R50, '3x1x1'), ResNet-18
(``BasicBlock3D``) with per-block inflation and the head's max pool, and
two R50s with the other options on fewer stages. The port in float32 with
the JAX init the golden used gives ``tests/golden/i3d_r50_logits.npz``.

The helpers here (configs, the weight carry, the JAX and port train
trajectories) serve ``test_torch_slowfast_x3d.py`` and
``test_torch_3d_entry.py`` too.
"""

import contextlib
import functools
import logging
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine import train_step as jax_train_step_mod
from mvfnet_tpu.engine.train_loop import _frozen_prefixes_from_backbone
from mvfnet_tpu.engine.train_step import TrainState
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                           build_optimizer,
                                           frozen_prefixes_from_backbone,
                                           param_label)
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import build_backbone, build_recognizer
from mvfnet_tpu_torch.models.backbones import resnet_i3d
from mvfnet_tpu_torch.models.heads.i3d_head import I3DClsHead
from mvfnet_tpu_torch.models.recognizers import recognizer3d
from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                               jax_entries,
                                               jax_variables_from_state_dict,
                                               state_dict_from_jax)

T, B, HW, NUM_CLASSES = 8, 2, 32, 5
RTOL, ATOL = 1e-6, 1e-8                 # forward logits and features
STEP_RTOL = 1e-9                        # loss, gradient norm
STATE_RTOL, STATE_ATOL = 1e-7, 1e-9     # updated parameters and statistics
BN3D = dict(type='BN3d', requires_grad=True)
# the step policy: the JAX package's cosine schedule computes in float32
# (optax) even under x64, up to 1.7e-6 relative off the f64 one at step 0
LR_CONFIG = dict(policy='step', step=[5], warmup='linear', warmup_iters=3,
                 warmup_ratio=0.1)
RECIPE = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
              nesterov=True)
MAX_NORM = 2.0
GOLDEN = os.path.join(os.path.dirname(__file__), 'golden',
                      'i3d_r50_logits.npz')


def i3d_backbone(**overrides):
    """The I3D config's backbone (``configs/i3d/i3d_r50_32x2_k400.py``)."""
    return dict(dict(type='ResNet_I3D', depth=50, out_indices=(3,),
                     inflate_freq=(1, 1, 1, 1), inflate_style='3x1x1',
                     conv1_kernel=(5, 7, 7), conv1_stride_t=2,
                     pool1_stride_t=2, norm_eval=False, norm_cfg=BN3D),
                **overrides)


def model_cfg(backbone, in_channels, head='I3DClsHead', **head_opts):
    return dict(type='Recognizer3D', backbone=backbone,
                cls_head=dict(type=head, dropout_ratio=0.0,
                              in_channels=in_channels,
                              num_classes=NUM_CLASSES, init_std=0.01,
                              **head_opts),
                dtype=None)


CASES = {
    'r50_config': model_cfg(i3d_backbone(), 2048),
    'r18_basic': model_cfg(i3d_backbone(
        depth=18, inflate_freq=((1, 0), 0, (0, 1), 1)), 512,
        spatial_type='max'),
    'r50_caffe_3x3x3_avg_down_deep_stem': model_cfg(i3d_backbone(
        num_stages=2, out_indices=(1,), inflate_style='3x3x3',
        inflate_freq=((1, 0, 1), 1), style='caffe', avg_down=True,
        deep_stem=True, stem_width=32, temporal_strides=(1, 2)), 512),
    'r50_avd_pool1_dilation': model_cfg(i3d_backbone(
        num_stages=2, out_indices=(1,), avd=True, avd_first=True,
        conv1_kernel=(3, 7, 7), conv1_stride_t=1, pool1_kernel_t=3,
        pool1_stride_s=1, no_pool2=True, dilations=(1, 2)), 512),
}


def port_model(cfg, seed=0):
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None)).double()
    port.init_weights(torch.Generator().manual_seed(seed), randomize_bn=True)
    return port


_SHAPES = {}


def jax_shapes(cfg, shape=(1, 1, T, HW, HW, 3)):
    """The JAX model's variable shapes, traced in float32 (its init casts
    to the float32 params' dtype in places); one trace per config."""
    key = (repr(cfg), shape)
    if key not in _SHAPES:
        jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
        x64 = jax.config.jax_enable_x64
        jax.config.update('jax_enable_x64', False)
        try:
            _SHAPES[key] = jax.eval_shape(lambda: jmodel.init(
                jax.random.PRNGKey(0), jnp.zeros(shape), None,
                return_loss=False))
        finally:
            jax.config.update('jax_enable_x64', x64)
    return _SHAPES[key]


def tree_shapes(tree):
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_variables(port, cfg, shape=(1, 1, T, HW, HW, 3)):
    """The port's weights in the JAX layout; their tree is the JAX
    model's."""
    shapes = jax_shapes(cfg, shape)
    variables = jax_variables_from_state_dict(port.state_dict())
    variables = {k: variables[k] for k in shapes}
    assert tree_shapes(variables) == tree_shapes(shapes)
    return variables


def template(cfg, shape=(1, 1, T, HW, HW, 3)):
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float64),
                                  jax_shapes(cfg, shape))


def clips(seed, lead=(B,), t=T):
    return np.random.RandomState(seed).randn(*lead, 1, t, HW, HW, 3) * 0.5


def jax_forward(cfg, variables, x):
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    return np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, None, return_loss=False))(variables, jnp.asarray(x)))


def jax_trajectory(cfg, variables, imgs, labels, recipe=RECIPE):
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    sched = jax_optim.build_lr_schedule(LR_CONFIG, recipe['lr'], 1, 8)
    tx = jax_optim.build_optimizer(
        variables['params'], recipe, sched,
        grad_clip=dict(max_norm=MAX_NORM, norm_type=2),
        frozen_prefixes=_frozen_prefixes_from_backbone(cfg['backbone']))
    step = jax_train_step_mod.make_train_step(jmodel, tx, mesh=None,
                                              donate=False)
    state = TrainState.create(variables, tx)
    metrics = []
    for x, y in zip(imgs, labels):
        state, m = step(state, jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(0))
        metrics.append((float(m['loss']), float(m['grad_norm'])))
    return metrics, jax.tree_util.tree_map(np.asarray, state.variables())


def port_trajectory(cfg, port, imgs, labels, recipe=RECIPE, remat=False):
    sched = build_lr_schedule(LR_CONFIG, recipe['lr'], 1, 8)
    opt = build_optimizer(
        port, recipe, sched, grad_clip=dict(max_norm=MAX_NORM, norm_type=2),
        frozen_prefixes=frozen_prefixes_from_backbone(cfg['backbone']))
    step = make_train_step(port, opt, sched, device='cpu', remat=remat)
    metrics = []
    for x, y in zip(imgs, labels):
        m = step(x, y)
        metrics.append((m['loss'].item(), m['grad_norm'].item()))
    return metrics, {k: v.detach().clone() for k, v in
                     port.state_dict().items()}


def assert_step_matches_jax(cfg, steps=1, recipe=RECIPE, t=T):
    """``steps`` train steps of the port and of JAX from one state: the
    losses, gradient norms, parameters and BatchNorm statistics."""
    port = port_model(cfg)
    variables = jax_variables(port, cfg, (1, 1, t, HW, HW, 3))
    imgs = clips(7, (steps, B), t)
    labels = np.random.RandomState(8).randint(0, NUM_CLASSES, (steps, B))
    want, jvars = jax_trajectory(cfg, variables, imgs, labels, recipe)
    got, state = port_trajectory(cfg, port, imgs, labels, recipe)
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    stats = 0
    for coll, path, name, value in jax_entries(jvars):
        np.testing.assert_allclose(state[name].numpy(), value,
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=path)
        stats += coll == 'batch_stats'
    assert stats > 0
    return port


@contextlib.contextmanager
def one_thread():
    """torch on one intra-op thread. On the CPU an f64 grouped convolution
    (MobileNetV2's and X3D's depthwise ones) runs as one small convolution
    per group, each a parallel region that costs more than its work: many
    times slower on 8 threads than on one, and far worse when other
    processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope='module', autouse=True)
def f64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


@pytest.mark.parametrize('name', sorted(CASES))
def test_forward_matches_jax(name):
    cfg = CASES[name]
    port = port_model(cfg).eval()
    x = clips(1)
    want = jax_forward(cfg, jax_variables(port, cfg), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.shape == (B, NUM_CLASSES) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_port_matches_golden_logits():
    """The JAX package's golden I3D-R50 (7 classes, ``PRNGKey(0)`` init at
    (1, 1, 8, 32, 32, 3)) in float32, carried into the port."""
    from test_models_3d import i3d_cfg
    data = np.load(GOLDEN)
    jax.config.update('jax_enable_x64', False)
    try:
        jmodel = jax_build(i3d_cfg(), test_cfg=dict(average_clips=None))
        init = jax.jit(lambda key, x, y: jmodel.init(
            key, x, y, return_loss=True, train=False))
        variables = init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 1, 8, 32, 32, 3), jnp.float32),
                         jnp.zeros((1,), jnp.int32))
    finally:
        jax.config.update('jax_enable_x64', True)
    port = build_recognizer(i3d_cfg(), test_cfg=dict(average_clips=None))
    port.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, variables)), strict=True)
    rng = np.random.RandomState(int(data['x_seed']))
    x = rng.randn(2, 1, 8, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        logits = port.eval()(torch.from_numpy(x), None, return_loss=False)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), data['logits'], rtol=1e-4,
                               atol=1e-5)


def test_train_step_matches_jax():
    """Two steps of the config's R50 on its first stage with
    ``frozen_stages=0`` (the stem frozen, its BatchNorm still training)."""
    cfg = model_cfg(i3d_backbone(num_stages=1, out_indices=(0,),
                                 frozen_stages=0), 256)
    port = assert_step_matches_jax(cfg, steps=2)
    frozen = port_model(cfg).state_dict()
    for name, p in port.named_parameters():
        moved = not torch.equal(p, frozen[name])
        assert moved == (not name.startswith(('backbone.conv1.',
                                              'backbone.bn1.'))), name


def test_with_cp_equals_the_step_without_it():
    """``with_cp`` per res-stage: the same two steps, BatchNorm statistics
    included, each BatchNorm counting two batches."""
    cfg = model_cfg(i3d_backbone(depth=18, num_stages=2, out_indices=(1,)),
                    128)
    imgs = clips(7, (2, B))
    labels = np.random.RandomState(8).randint(0, NUM_CLASSES, (2, B))
    runs = [port_trajectory(cfg, port_model(cfg), imgs, labels, remat=r)
            for r in (False, True)]
    (plain, plain_state), (cp, cp_state) = runs
    np.testing.assert_allclose(cp, plain, rtol=1e-12)
    for k, v in plain_state.items():
        np.testing.assert_allclose(cp_state[k].numpy(), v.numpy(),
                                   rtol=1e-12, atol=0, err_msg=k)
    assert {int(v) for k, v in cp_state.items()
            if k.endswith('num_batches_tracked')} == {2}


@functools.lru_cache(maxsize=1)
def _six_views():
    """``r18_basic`` in eval, six views of one video, and their scores at
    once; one model and one reference for every chunk size."""
    port = port_model(CASES['r18_basic']).eval()
    x = torch.from_numpy(clips(2, (1,))).repeat(1, 6, 1, 1, 1, 1) \
        + torch.arange(6.0).reshape(1, 6, 1, 1, 1, 1) * 0.1
    with torch.no_grad():
        whole = port(x, None, return_loss=False)
    return port, x, whole


@pytest.mark.parametrize('chunk', [2, 3, 4])
def test_view_chunk_scores_equal_unchunked(chunk):
    """Six views of one video scored ``chunk`` at a time equal the views
    scored at once; a chunk that does not divide them (4) logs the warning
    and runs them at once."""
    port, x, whole = _six_views()
    with torch.no_grad():
        port.test_cfg = dict(average_clips=None, view_chunk=chunk)
        calls = []
        real = port.backbone.forward
        port.backbone.forward = lambda v: calls.append(v.shape[0]) or real(v)
        # the package's logger stops propagation once it is set up
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logger = logging.getLogger(recognizer3d.__name__)
        logger.addHandler(handler)
        try:
            got = port(x, None, return_loss=False)
        finally:
            logger.removeHandler(handler)
            del port.backbone.forward      # the class's forward again
    divides = 6 % chunk == 0
    assert [r.getMessage() for r in records] == (
        [] if divides else ['test_cfg.view_chunk=4 ignored: 6 views not '
                            'divisible'])
    assert calls == ([chunk] * (6 // chunk) if divides else [6])
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-12,
                               atol=1e-15)


def test_head_pools_dropout_and_features():
    """The head's max pool, its features, and dropout drawn as
    ``TSNClsHead`` draws it: the same generator gives the same mask, a
    shard keeps its rows of the whole batch's mask, and ``fcn_testing``
    turns it off."""
    head = I3DClsHead(spatial_type='max', dropout_ratio=0.5, in_channels=8,
                      num_classes=3).double()
    head.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(4, 8, 2, 3, 3, dtype=torch.float64)
    feat = x.amax(dim=(2, 3, 4))
    head.eval()
    torch.testing.assert_close(head(x), feat @ head.fc_cls.weight.T
                               + head.fc_cls.bias)
    head.train()
    keep = torch.rand((4, 8), generator=torch.Generator().manual_seed(5)) \
        >= 0.5
    drop = torch.where(keep, feat / 0.5, torch.zeros_like(feat))
    head.extract_feat = True
    torch.testing.assert_close(
        head(x, generator=torch.Generator().manual_seed(5)), drop)
    head.dropout_shard = (2, 1)
    keep2 = torch.rand((8, 8), generator=torch.Generator().manual_seed(5))[
        4:] >= 0.5
    torch.testing.assert_close(
        head(x, generator=torch.Generator().manual_seed(5)),
        torch.where(keep2, feat / 0.5, torch.zeros_like(feat)))
    head.fcn_testing = True
    torch.testing.assert_close(head(x), x.mean(dim=(2, 3, 4)))


def test_unported_options_raise():
    """The options once refused are ported: the int8 path (A14) puts
    ``QuantConv3d`` at the conv types ``quant_ops`` names, and the 3-D
    backbones once queued (A13b) build. Non-local blocks are ported
    (``test_torch_temporal_modules.py``): none outside
    ``nonlocal_stages``. An unknown depth still raises."""
    bb = resnet_i3d.ResNet_I3D(depth=50, nonlocal_cfg=dict(type='NL'))
    assert not any(n.endswith('nonlocal_block')
                   for n, _ in bb.named_modules())
    for name in ('ResNet_R3D', 'InceptionV1_I3D'):
        assert type(build_backbone(dict(type=name))).__name__ == name
    quant = resnet_i3d.ResNet_I3D(depth=50, quant='int8')
    block = quant.layer1[0]
    # '3x1x1': the temporal conv1 and the pointwise conv3 stay plain
    assert [type(c).__name__ for c in (block.conv1, block.conv2,
                                       block.conv3)] == [
        'Conv3d', 'QuantConv3d', 'Conv3d']
    assert list(quant.state_dict()) == list(
        resnet_i3d.ResNet_I3D(depth=50).state_dict())
    with pytest.raises(KeyError, match='depth 26'):
        resnet_i3d.ResNet_I3D(depth=26)


def test_state_dict_imports_into_jax():
    cfg = CASES['r50_config']
    sd = {k: v.numpy() for k, v in port_model(cfg).state_dict().items()}
    back, report = import_torch_weights(sd, template(cfg),
                                        return_report=True)
    assert report['missing'] == report['unexpected'] == \
        report['mismatched'] == []
    for _, path, name, value in jax_entries(back):
        np.testing.assert_array_equal(value, sd[name], err_msg=path)


@functools.lru_cache(maxsize=None)
def _r50_2d_state_dict():
    """A seeded ResNet-50 in torchvision's vocabulary, its classifier
    included (skipped by both importers)."""
    from mvfnet_tpu_torch.models.backbones.resnet import ResNet
    net = ResNet(depth=50)
    net.init_weights(torch.Generator().manual_seed(3))
    sd = {k: v.numpy().astype(np.float64) for k, v in
          net.state_dict().items()}
    sd['fc.weight'] = np.ones((7, 2048))
    sd['fc.bias'] = np.zeros(7)
    return sd


@pytest.mark.parametrize('in_channels', [3, 10], ids=['rgb', 'flow'])
def test_2d_checkpoint_inflates_as_in_jax(in_channels):
    """A 2-D R50 into the I3D config's model: every kernel inflated over
    time (``w3d[t] = w2d / kT``), the same weights and report in both
    importers; with 10 input channels (Flow) the stem is first averaged
    over RGB and broadcast."""
    cfg = model_cfg(i3d_backbone(in_channels=in_channels), 2048)
    sd = dict(_r50_2d_state_dict())
    inflate = in_channels if in_channels != 3 else None
    port = port_model(cfg, seed=1)
    report = import_torch_state_dict(port, {k: torch.from_numpy(v) for k, v
                                            in sd.items()},
                                     inflate_in_channels=inflate)
    back, jreport = import_torch_weights(sd, template(
        cfg, (1, 1, T, HW, HW, in_channels)),
                                         inflate_in_channels=inflate,
                                         return_report=True)
    assert report['unexpected'] == jreport['unexpected'] == []
    assert report['mismatched'] == jreport['mismatched'] == []
    assert sorted(report['missing']) == ['cls_head.fc_cls.bias',
                                         'cls_head.fc_cls.weight']
    assert sorted(jreport['missing']) == ['params:head_mod/fc/bias',
                                          'params:head_mod/fc/kernel']
    state = port.state_dict()
    stem = state['backbone.conv1.weight']
    assert stem.shape == (64, in_channels, 5, 7, 7)
    want = torch.from_numpy(sd['conv1.weight']).mean(1, keepdim=True) \
        if inflate else torch.from_numpy(sd['conv1.weight'])
    torch.testing.assert_close(stem[:, :, 2], (want / 5).expand(
        64, in_channels, 7, 7), rtol=0, atol=0)
    for _, path, name, value in jax_entries(back):
        if '/head_mod/' not in '/' + path:
            np.testing.assert_array_equal(state[name].numpy(), value,
                                          err_msg=path)


def test_param_labels_match_jax():
    cfg = CASES['r50_caffe_3x3x3_avg_down_deep_stem']
    cfg = dict(cfg, backbone=dict(cfg['backbone'], frozen_stages=1,
                                  norm_frozen=True))
    shapes = jax_shapes(cfg)
    labels = jax_optim.masked_labels(
        shapes['params'], _frozen_prefixes_from_backbone(cfg['backbone']))
    names = {path: name for coll, path, name, _ in jax_entries(
        template(cfg)) if coll == 'params'}
    want = {names['/'.join(k.key for k in p)]: label for p, label in
            jax.tree_util.tree_leaves_with_path(labels)}
    prefixes = frozen_prefixes_from_backbone(cfg['backbone'])
    got = {n: param_label(n, prefixes)
           for n, _ in build_recognizer(cfg).named_parameters()}
    assert got == want
    assert got['backbone.layer2.0.bn1.weight'] == 'frozen'


def test_jax_cosine_schedule_computes_in_float32():
    """The 3-D configs' cosine policy with its linear warmup: the JAX
    package's schedule (optax) gives float32 values even under x64, off
    the port's f64 ones by up to 1.7e-6 relative at step 0 (ROADMAP.md,
    section C); the f64 trajectories above use the step policy."""
    lr_config = dict(policy='cosine', warmup='linear', warmup_ratio=0.01,
                     warmup_iters=3)
    want = jax_optim.build_lr_schedule(lr_config, 0.01, 1, 8)
    got = build_lr_schedule(lr_config, 0.01, 1, 8)
    rel = []
    for step in range(6):
        lr = want(jnp.asarray(step, jnp.int32))
        assert lr.dtype == jnp.float32
        rel.append(abs(float(lr) - got(step)) / got(step))
    assert 1e-6 < max(rel) < 2e-6 and rel[0] == max(rel)
