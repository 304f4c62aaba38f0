"""Port parity: SlowFast (``ResNet_I3D_SlowFast``, ``I3DSlowFastClsHead``)
and X3D (``ResNet_X3D``).

As in ``test_torch_i3d.py`` (its helpers and tolerances): each case is
built by both packages at 32x32 in f64 with the port's seeded weights
carried into the JAX layout. SlowFast: the SlowFast config's backbone
(R50, tau 16, alpha 8, beta_inv 8, at T=16), with the shipped
``fast_pack=8`` and ``stem_s2d='train'``, so the JAX side runs its packed
fast pathway where the port runs the plain one; a ResNet-18 with the other
pathway options; and the one-pathway modes. Each gives the two pathways'
maps and the head's logits. X3D: the X3D config's backbone at the
reference's smallest depth factor (1: 1, 2, 5, 3 blocks; the config's own
depth is held by ``test_torch_3d_entry.py``) and a thin variant with the
other options, its maps at two ``out_indices``. One train step of each family. Then what the port alone
must show (``fast_pack``, ``stem_s2d`` and ``s2d_stages`` change neither
names nor bits), the reference's SlowFast and X3D vocabularies through both
importers, and a ``.msgpack`` with its optax state both ways. The X3D
forward and train step are in ``test_torch_x3d.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine.train_loop import _frozen_prefixes_from_backbone
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu.utils.checkpoint import load_checkpoint as jax_load
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                           build_optimizer,
                                           frozen_prefixes_from_backbone)
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                               jax_entries,
                                               load_checkpoint,
                                               load_optax_state,
                                               save_msgpack_checkpoint)
from test_torch_i3d import (ATOL, B, BN3D, HW, LR_CONFIG, MAX_NORM,
                            NUM_CLASSES, RECIPE, RTOL, assert_step_matches_jax,
                            jax_variables, model_cfg, one_thread,
                            port_model, template)

SF_T = 16


def sf_backbone(**overrides):
    """The SlowFast config's backbone (``configs/slowfast/
    slowfast_r50_k400.py``), shipped TPU forms included."""
    return dict(dict(type='ResNet_I3D_SlowFast', depth=50, tau=16, alpha=8,
                     beta_inv=8, fast_pack=8, out_indices=(3,),
                     slow_inflate_freq=(0, 0, 1, 1),
                     fast_inflate_freq=(1, 1, 1, 1), norm_eval=False,
                     norm_cfg=BN3D), **overrides)


def x3d_backbone(**overrides):
    """The X3D config's backbone (``configs/x3d/x3d_k400.py``)."""
    return dict(dict(type='ResNet_X3D', depth=50, ratio_width=1,
                     ratio_bottleneck=2.25, inflate_style='mobile',
                     norm_eval=False, norm_cfg=BN3D), **overrides)


SF18 = dict(depth=18, tau=4, alpha=2, beta_inv=4, fast_pack=0,
            num_stages=3, out_indices=(2,), spatial_strides=(1, 2, 2),
            slow_conv1_kernel_t=3, fast_conv1_kernel_t=3,
            fast_pool1_kernel_t=3, slow_inflate_freq=(0, (1, 0), 1),
            fast_inflate_freq=((0, 1), 1, 1), inflate_style='3x3x3')
# name: (config, frames)
SLOWFAST = {
    'sf50_config_packed': (model_cfg(sf_backbone(), 2048 + 256,
                                     'I3DSlowFastClsHead'), SF_T),
    'sf18_options': (model_cfg(sf_backbone(**SF18), 256 + 64,
                               'I3DSlowFastClsHead'), 8),
    'sf18_slow_only': (model_cfg(sf_backbone(**dict(
        SF18, slow_only=True, num_stages=2, out_indices=(1,),
        spatial_strides=(1, 2))), 128), 8),
    'sf18_fast_only': (model_cfg(sf_backbone(**dict(
        SF18, fast_only=True, num_stages=2, out_indices=(1,),
        spatial_strides=(1, 2))), 32), 8),
}
X3D = {
    'x3d_config_depth1': (x3d_backbone(depth=1), 8),
    'x3d_options': (x3d_backbone(
        depth=1, ratio_width=0.5, num_stages=3, inflate_style='3x3x3',
        inflate_freq=(1, (1, 0), 1), style='caffe',
        temporal_strides=(1, 1, 2), out_indices=(1, 2), no_pool2=True), 8),
}


def clips(seed, t, lead=(B,), hw=HW):
    return np.random.RandomState(seed).randn(*lead, 1, t, hw, hw, 3) * 0.5


def nthwc(x):
    return x.permute(0, 2, 3, 4, 1).numpy()


@pytest.fixture(scope='module', autouse=True)
def f64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


@pytest.mark.parametrize('name', sorted(SLOWFAST))
def test_slowfast_matches_jax(name):
    """The pathways' maps (the backbone through ``extract_feat``) and the
    head's logits on them."""
    cfg, t = SLOWFAST[name]
    shape = (1, 1, t, HW, HW, 3)
    port = port_model(cfg).eval()
    variables = jax_variables(port, cfg, shape)
    x = clips(1, t)
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    want_maps = jax.jit(lambda v, x: jmodel.apply(
        v, x, method=lambda m, x: m.extract_feat(x, False)))(
        variables, jnp.asarray(x[:, 0]))
    want = np.asarray(jax.jit(lambda v, f: jmodel.apply(
        v, f, method=lambda m, f: m.head_mod(f)))(variables, want_maps))
    with torch.no_grad():
        maps = port.extract_feat(torch.from_numpy(x[:, 0]))
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    if not isinstance(maps, tuple):
        maps, want_maps = (maps,), (want_maps,)
    assert len(maps) == (2 if 'only' not in name else 1)
    for m, w in zip(maps, want_maps):
        np.testing.assert_allclose(nthwc(m), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    assert got.shape == (B, NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_slowfast_train_step_matches_jax():
    cfg = model_cfg(sf_backbone(**dict(SF18, num_stages=1,
                                       out_indices=(0,))),
                    64 + 16, 'I3DSlowFastClsHead')
    assert_step_matches_jax(cfg, t=8)


def _step_once(cfg, x, y):
    port = port_model(cfg)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    opt = build_optimizer(port, RECIPE, sched,
                          grad_clip=dict(max_norm=MAX_NORM, norm_type=2))
    metrics = make_train_step(port, opt, sched, device='cpu')(x, y)
    return port, opt, metrics


def _layout_run(backbone, slowfast, x, y):
    """The state-dict shapes, eval logits, one train step's loss and the
    state after it, in float32."""
    cfg = (model_cfg(backbone, 256 + 64, 'I3DSlowFastClsHead')
           if slowfast else model_cfg(backbone, 2048))
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None))
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    with torch.no_grad():
        logits = port.eval()(torch.from_numpy(x).float(), None,
                             return_loss=False)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    opt = build_optimizer(port, RECIPE, sched,
                          grad_clip=dict(max_norm=MAX_NORM, norm_type=2))
    m = make_train_step(port, opt, sched, device='cpu')(
        x.astype(np.float32), y)
    return shapes, logits, m['loss'], port.state_dict()


@pytest.mark.parametrize('packed,plain', [
    (sf_backbone(**dict(SF18, fast_pack=2, stem_s2d=True)),
     sf_backbone(**dict(SF18, stem_s2d=False))),
    (x3d_backbone(depth=1, s2d_stages=(1,)), x3d_backbone(depth=1)),
], ids=['slowfast_fast_pack_stem_s2d', 'x3d_s2d_stages'])
def test_tpu_layouts_change_neither_names_nor_bits(packed, plain):
    """The JAX package's TPU re-layouts: the same ``state_dict`` keys and
    shapes, bit-equal eval logits and one bit-equal train step (float32).
    SlowFast's on the ResNet-18 pathways of ``sf18_options``: the port
    computes both forms plainly at any depth."""
    slowfast = 'tau' in packed
    x = clips(3, 8)
    y = np.random.RandomState(4).randint(0, NUM_CLASSES, B)
    runs = []
    with one_thread():                  # X3D's depthwise convolutions
        for backbone in (packed, plain):
            runs.append(_layout_run(backbone, slowfast, x, y))
    (sa, la, lossa, sda), (sb, lb, lossb, sdb) = runs
    assert sa == sb
    assert torch.equal(la, lb) and torch.equal(lossa, lossb)
    assert all(torch.equal(sda[k], sdb[k]) for k in sda)


@pytest.mark.parametrize('name', ['slowfast', 'x3d'])
def test_state_dict_imports_into_jax(name):
    cfg, shape = ((SLOWFAST['sf50_config_packed'][0], (1, 1, SF_T, HW, HW,
                                                         3))
                  if name == 'slowfast' else
                  (model_cfg(x3d_backbone(), 2048),
                   (1, 1, 8, HW, HW, 3)))
    sd = {k: v.numpy() for k, v in port_model(cfg).state_dict().items()}
    back, report = import_torch_weights(sd, template(cfg, shape),
                                        return_report=True)
    assert report['missing'] == report['unexpected'] == \
        report['mismatched'] == []
    for _, path, torch_name, value in jax_entries(back):
        np.testing.assert_array_equal(value, sd[torch_name], err_msg=path)


@pytest.mark.parametrize('name', ['slowfast', 'x3d'])
def test_reference_vocabulary_loads_as_in_jax(name):
    """The reference's keys beyond the port's modules: SlowFast's unused
    ``layer4_lateral`` (skipped silently by both) and a lateral on the fast
    pathway (unexpected in both); X3D's unused stem ``bn1`` and a bias on
    ``conv1_3x1``'s conv (unexpected in both). The rest loads into the same
    weights; the head's ``fc_cls`` comes as the reference's ``new_cls``
    alias."""
    if name == 'slowfast':
        cfg, _ = SLOWFAST['sf18_options']
        shape = (1, 1, 8, HW, HW, 3)
        extra = {'backbone.slow_path.layer4_lateral.weight':
                 np.ones((64, 32, 5, 1, 1)),
                 'backbone.fast_path.conv1_lateral.weight':
                 np.ones((32, 16, 5, 1, 1))}
        silent = ['backbone.slow_path.layer4_lateral.weight']
    else:
        cfg = model_cfg(X3D['x3d_options'][0], 2048)
        cfg['backbone'] = dict(cfg['backbone'], out_indices=(2,))
        shape = (1, 1, 8, HW, HW, 3)
        extra = {'backbone.bn1.weight': np.ones(12),
                 'backbone.bn1.running_mean': np.zeros(12),
                 'backbone.conv1_3x1.0.bias': np.zeros(12)}
        silent = []
    source = port_model(cfg, seed=2)
    sd = {k: v.numpy() for k, v in source.state_dict().items()}
    sd['cls_head.new_cls.weight'] = sd.pop('cls_head.fc_cls.weight')
    sd.update(extra)
    port = port_model(cfg, seed=3)
    report = import_torch_state_dict(
        port, {k: torch.from_numpy(v) for k, v in sd.items()})
    back, jreport = import_torch_weights(sd, template(cfg, shape),
                                         return_report=True)
    want_unexpected = sorted(set(extra) - set(silent))
    assert sorted(report['unexpected']) == sorted(jreport['unexpected']) \
        == want_unexpected
    assert report['missing'] == jreport['missing'] == []
    assert report['mismatched'] == jreport['mismatched'] == []
    state = port.state_dict()
    for _, path, torch_name, value in jax_entries(back):
        np.testing.assert_array_equal(state[torch_name].numpy(), value,
                                      err_msg=path)
        assert torch.equal(state[torch_name],
                           source.state_dict()[torch_name]), torch_name


def test_msgpack_with_optax_state_both_ways(tmp_path):
    """SlowFast after one port step: the port's ``.msgpack`` restores into
    the JAX model's variables and its optimizer chain's state; the JAX
    package writes them back, and the port loads weights and momentum
    bit-equal."""
    cfg, t = SLOWFAST['sf18_options']
    shape = (1, 1, t, HW, HW, 3)
    x = clips(5, t)
    port, opt, _ = _step_once(cfg, x, np.arange(B) % NUM_CLASSES)
    path = str(tmp_path / 'port.msgpack')
    save_msgpack_checkpoint(path, port, opt, meta={'epoch': 1, 'iter': 1})
    variables_sd, opt_sd, meta = jax_load(path)
    tmpl = template(cfg, shape)
    restored = {k: serialization.from_state_dict(tmpl[k], variables_sd[k])
                for k in tmpl}
    state = port.state_dict()
    for _, jpath, torch_name, value in jax_entries(restored):
        np.testing.assert_array_equal(value, state[torch_name].numpy(),
                                      err_msg=jpath)
    tx = jax_optim.build_optimizer(
        tmpl['params'], RECIPE,
        jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8),
        grad_clip=dict(max_norm=MAX_NORM, norm_type=2),
        frozen_prefixes=_frozen_prefixes_from_backbone(cfg['backbone']))
    jopt = serialization.from_state_dict(tx.init(tmpl['params']), opt_sd)
    jpath = str(tmp_path / 'jax.msgpack')
    jax_save(jpath, restored, opt_state=jopt, meta=meta)

    loaded, opt_state, meta = load_checkpoint(jpath)
    fresh = build_recognizer(cfg).double()
    fresh.load_state_dict(loaded, strict=True)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    fresh_opt = build_optimizer(
        fresh, RECIPE, sched, grad_clip=dict(max_norm=MAX_NORM, norm_type=2),
        frozen_prefixes=frozen_prefixes_from_backbone(cfg['backbone']))
    load_optax_state(fresh, fresh_opt, opt_state, meta['iter'])
    buffers = {n: opt.state[p]['momentum_buffer']
               for n, p in port.named_parameters()}
    assert len(buffers) == len(fresh_opt.state) > 0
    for n, p in fresh.named_parameters():
        assert torch.equal(fresh_opt.state[p]['momentum_buffer'],
                           buffers[n]), n
        assert torch.equal(p, state[n]), n


def test_frozen_stages_freeze_no_slowfast_parameter_in_either_package():
    """``frozen_stages`` names the stem and ``layer{i}`` prefixes, which
    SlowFast's pathway modules do not start with: the JAX package's labels
    freeze nothing of it, and the port's follow (ROADMAP.md, section C)."""
    from mvfnet_tpu_torch.engine.optim import param_label
    cfg, _ = SLOWFAST['sf18_options']
    cfg = dict(cfg, backbone=dict(cfg['backbone'], frozen_stages=2))
    shapes = template(cfg, (1, 1, 8, HW, HW, 3))
    labels = jax_optim.masked_labels(
        shapes['params'], _frozen_prefixes_from_backbone(cfg['backbone']))
    assert 'frozen' not in jax.tree_util.tree_leaves(labels)
    prefixes = frozen_prefixes_from_backbone(cfg['backbone'])
    assert not any(param_label(n, prefixes) == 'frozen'
                   for n, _ in build_recognizer(cfg).named_parameters())
