"""The 3-D path's spans and the BatchNorm counter on the CPU.

The I3D-R50 32x2 config (``configs/i3d/i3d_r50_32x2_k400.py``, float32,
one clip of 8 frames at 32^2) through ``make_eval_step``: with tracing on,
one ``model.stem`` span a forward (conv1, bn1, ReLU, pool1) and one
``model.norm`` span for each of its 53 BatchNorms (the stem's, three in
each of the 16 bottlenecks, four shortcuts), none with tracing off,
``common.BatchNorm.counts['forward']`` up by 53 either way, and the scores
bit-equal. The flagship's eval forward folds every BatchNorm it has
(``common.fold_conv_bn``, the fused bottleneck) and applies MVF's inline,
so no ``BatchNorm.forward`` runs there; its train forward runs all 53 of
its ResNet's.
"""

import os

import numpy as np
import pytest
import torch

from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.engine.train_step import make_eval_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.models.common import BatchNorm
from mvfnet_tpu_torch.utils import tracing

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
I3D = os.path.join(REPO, 'configs', 'i3d', 'i3d_r50_32x2_k400.py')
FLAGSHIP = os.path.join(REPO, 'configs', 'mvf', 'k400',
                        'mvf_kinetics400_r50_8x8_dense.py')
# the stem's BN, bn1-bn3 of 3 + 4 + 6 + 3 bottlenecks, 4 shortcuts
I3D_NORMS = 1 + 3 * 16 + 4


@pytest.fixture(autouse=True)
def fresh():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def eval_model(path):
    """The config's recognizer in float32 with ``fcn_testing``, seeded,
    and its eval step on the CPU."""
    cfg = Config.fromfile(path)
    torch.manual_seed(0)
    model = build_recognizer(dict(cfg.model, fcn_testing=True,
                                  dtype='float32'),
                             train_cfg=None, test_cfg=cfg.test_cfg)
    norm = dict(cfg.img_norm_cfg, device=True)
    return model, make_eval_step(model, norm_cfg=norm, device='cpu')


@pytest.fixture(scope='module')
def i3d():
    # at most 4 threads, and no more than a pytest-xdist worker's share
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    model, step = eval_model(I3D)
    clip = np.random.default_rng(5).integers(0, 256, (1, 1, 8, 32, 32, 3),
                                             dtype=np.uint8)
    yield model, step, clip
    torch.set_num_threads(threads)


def forwards():
    return BatchNorm.counts['forward']


def test_i3d_spans_its_stem_and_each_norm(i3d):
    model, step, clip = i3d
    want = step(model, clip)
    before = forwards()
    tracing.enable()
    got = step(model, clip)
    tracing.disable()
    assert forwards() - before == I3D_NORMS
    assert torch.equal(got, want)
    spans = tracing.collect()
    by = {s['id']: s for s in spans}
    names = [s['name'] for s in spans]
    assert names.count('model.stem') == 1
    assert names.count('model.norm') == I3D_NORMS
    stem = next(s for s in spans if s['name'] == 'model.stem')
    assert by[stem['parent']]['name'] == 'step.forward'
    # the stem's bn1 is the first norm and lies inside the stem
    norms = [s for s in spans if s['name'] == 'model.norm']
    assert norms[0]['parent'] == stem['id']
    assert all(s['parent'] != stem['id'] for s in norms[1:])
    assert all(stem['end_ns'] <= s['start_ns'] for s in norms[1:])


def test_i3d_records_nothing_with_tracing_off_and_still_counts(i3d):
    model, step, clip = i3d
    before = forwards()
    step(model, clip)
    assert forwards() - before == I3D_NORMS
    assert tracing.collect() == []


def test_flagship_eval_runs_no_batchnorm_forward_and_training_all():
    model, step = eval_model(FLAGSHIP)
    frames = np.random.default_rng(6).integers(0, 256, (1, 8, 32, 32, 3),
                                               dtype=np.uint8)
    before = forwards()
    tracing.enable()
    step(model, frames)
    tracing.disable()
    assert forwards() == before
    assert 'model.norm' not in {s['name'] for s in tracing.collect()}
    model.train()
    x = torch.randn(8, 32, 32, 3)
    model(x[None], torch.tensor([1]), return_loss=True)
    assert forwards() - before == 53
