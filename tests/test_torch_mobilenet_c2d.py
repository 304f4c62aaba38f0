"""Port parity: MobileNetV2 (plain, with MVF, with TSM), ``RecognizerC2D``,
and the optimizer labels and importer rules of this slice's families.

Forwards are held against the JAX package in f64 at ``width_mult=0.5``
(2 segments of 32x32) with the port's seeded weights carried through the
bridge (the carried tree equals the JAX model's ``eval_shape`` tree): rtol
1e-6 / atol 1e-8. The port's names are d-li14's MobileNetV2 vocabulary;
its ``state_dict()`` imports into JAX with an empty report, and a
checkpoint of another wrapping (a plain one into an MVF model, an MVF one
into a TSM model) loads as the JAX importer loads it.
"""

import numpy as np
import pytest
import torch

import jax

from mvfnet_tpu.engine.optim import masked_labels
from mvfnet_tpu.engine.train_loop import _frozen_prefixes_from_backbone
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu_torch.engine.optim import (frozen_prefixes_from_backbone,
                                           param_label)
from mvfnet_tpu_torch.models.modules.tsm import ShiftConv2d
from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                               jax_entries)
from test_torch_i3d import (f64, jax_variables, one_thread, port_model,
                            template)
from test_torch_temporal_modules import (R50, assert_forward_matches,
                                         frames, tsn_cfg)

assert f64  # the module-scoped x64 fixture, autouse


@pytest.fixture(scope='module', autouse=True)
def single_thread():
    """MobileNetV2's depthwise convolutions in f64 (``one_thread``)."""
    with one_thread():
        yield

MVF = dict(type='MVF', n_segment=2, alpha=0.125, mode='THW')
TSM = dict(type='tsm', n_segment=2, n_div=8, shift_place='blockres',
           temporal_pool=False)
MBV2 = dict(type='MobileNetV2', width_mult=0.5)
CASES = {
    'plain': tsn_cfg(MBV2, 1280),
    'mvf': tsn_cfg(MBV2, 1280, module_cfg=dict(MVF, mvf_freq=(0, 0, 1, 1))),
    'tsm': tsn_cfg(MBV2, 1280, module_cfg=TSM),
}
SHAPE = (1, 2, 32, 32, 3)


@pytest.mark.parametrize('name', sorted(CASES))
def test_mobilenet_v2_forward_matches_jax(name):
    cfg = CASES[name]
    port = port_model(cfg)
    wrapped = [n for n, m in port.named_modules()
               if n.endswith('conv.0') and type(m).__name__ in
               ('MVF', 'ShiftConv2d')]
    # the expanding identity blocks of 0.5x: 2, 4, 5, 7-9, 11, 12, 14, 15
    want = ([] if name == 'plain' else
            [f'backbone.features.{k}.conv.0'
             for k in (3, 5, 6, 8, 9, 10, 12, 13, 15, 16)])
    assert wrapped == want
    if name == 'tsm':
        assert isinstance(port.backbone.features[3].conv[0], ShiftConv2d)
    assert_forward_matches(cfg, frames(0, 2, 2, 32), port)


def test_mobilenet_v2_imports_both_ways():
    """The port's names import into JAX with an empty report, and the
    port's importer maps the other wrappings as JAX does: a plain
    checkpoint's ``conv.0.weight`` into MVF's ``conv.0.net.weight``, an MVF
    checkpoint into a TSM model (its MVF taps unexpected)."""
    ports = {n: port_model(c, seed=i) for i, (n, c) in
             enumerate(sorted(CASES.items()))}
    for name, port in ports.items():
        sd = port.state_dict()
        report = import_torch_state_dict(port, sd)
        assert report['missing'] == report['unexpected'] == \
            report['mismatched'] == [], name
        _, jrep = import_torch_weights({k: v.numpy() for k, v in sd.items()},
                                       template(CASES[name], SHAPE),
                                       return_report=True)
        assert jrep['missing'] == jrep['unexpected'] == \
            jrep['mismatched'] == [], name
    for src, dst in (('plain', 'mvf'), ('mvf', 'tsm')):
        sd = ports[src].state_dict()
        port = ports[dst]
        got = import_torch_state_dict(port, sd)
        _, want = import_torch_weights({k: v.numpy() for k, v in sd.items()},
                                       template(CASES[dst], SHAPE),
                                       return_report=True)
        names = {p: n for c, p, n, _ in jax_entries(
            jax_variables(port, CASES[dst], SHAPE))}
        assert sorted(got['applied']) == sorted(names[p]
                                                for p in want['applied'])
        assert sorted(got['unexpected']) == sorted(want['unexpected'])
        assert len(got['missing']) == len(want['missing'])
        state = port.state_dict()
        for k, v in sd.items():
            if k.endswith('conv.0.weight') or k.endswith('conv.0.net.weight'):
                other = (k.replace('.conv.0.net.', '.conv.0.')
                         if '.net.' in k else
                         k.replace('.conv.0.', '.conv.0.net.'))
                assert torch.equal(state.get(k, state.get(other)), v), k


def test_recognizer_c2d_forward_matches_jax():
    cfg = dict(type='RecognizerC2D', modality='RGB', dtype=None,
               backbone=dict(type='ResNet_I3D', depth=18, out_indices=(3,),
                             norm_eval=False, conv1_stride_t=1),
               cls_head=dict(type='I3DClsHead', in_channels=512,
                             num_classes=5, dropout_ratio=0.0))
    port = port_model(cfg)
    assert port.modality == 'RGB'
    x = np.random.RandomState(3).randn(2, 1, 4, 32, 32, 3) * 0.5
    assert_forward_matches(cfg, x, port)


LABEL_CASES = {
    'bninception': (tsn_cfg(dict(type='BNInception', bn_eval=False), 1024),
                    (1, 1, 64, 64, 3)),
    'mobilenet_mvf': (CASES['mvf'], SHAPE),
    'cost_nonlocal_trn_frozen': (tsn_cfg(
        dict(R50, frozen_stages=2), 2048, nonlocal_cfg=dict(n_segment=3),
        module_cfg=dict(type='CoST', n_segment=3, shift_freq=(0, 1, 1, 0)),
        consensus=dict(type='TRNmultiscale', num_frames=3)),
        (1, 3, 32, 32, 3)),
}


@pytest.mark.parametrize('name', sorted(LABEL_CASES))
def test_optimizer_labels_match_jax(name):
    """Each parameter's label ('frozen', 'norm', 'bias', 'default') is the
    JAX package's for its path; ``frozen_stages=2`` freezes the stem and
    stages 1-2 but not the non-local blocks beside layer2's blocks."""
    cfg, shape = LABEL_CASES[name]
    variables = jax_variables(port_model(cfg), cfg, shape)
    labels = dict(jax.tree_util.tree_leaves_with_path(masked_labels(
        variables['params'],
        _frozen_prefixes_from_backbone(cfg['backbone']))))
    by_path = {'/'.join(k.key for k in p): v for p, v in labels.items()}
    frozen = frozen_prefixes_from_backbone(cfg['backbone'])
    kinds = set()
    for coll, path, name_, _ in jax_entries(variables):
        if coll == 'params':
            assert param_label(name_, frozen) == by_path[path], (name_, path)
            kinds.add(by_path[path])
    assert kinds == {'norm', 'bias', 'default'} | (
        {'frozen'} if frozen else set())
    if frozen:
        assert param_label('backbone.layer2.1.nl.conv_in.weight',
                           frozen) == 'default'
        assert param_label('backbone.layer2.1.block.conv1.weight',
                           frozen) == 'frozen'
