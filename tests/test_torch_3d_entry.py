"""Port parity: the shipped 3-D configs through the port's entry points.

- Each of the four shipped 3-D configs (I3D, packed and unpacked SlowFast,
  X3D) builds in both packages with the same parameter names and shapes,
  the JAX side traced with ``jax.eval_shape``; ``count_flops`` counts the
  same parameters at the root CLI's default shape with the clip axis.
- ``evaluate_dataset`` with the I3D config's own test pipeline (sizes cut:
  8 frames, 2 clips x 3 crops of 32^2; ``FormatShape('NTHWC')``, device
  normalization) on three rawframe videos: the pipeline's output is
  bit-equal to the JAX package's, the scores and the features of a small
  I3D in f64 match JAX's (rtol 1e-6 / atol 1e-8; the JAX features keep
  the first rows of the whole run, the fault of ROADMAP.md section C).
- The test, train and feature CLIs run in-process on the CPU with a config
  that inherits the I3D config and shrinks its model and pipelines: two
  epochs with evaluations and checkpoints, a resume from epoch 1 that
  repeats epoch 2 exactly, and the logs name the recognizer and backbone.
"""

import json
import logging
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

import jax

import mvfnet_tpu.data as jdata
from mvfnet_tpu.config import Config as JaxConfig
from mvfnet_tpu.engine.eval import evaluate_dataset as jax_evaluate
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.parallel import make_mesh
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.engine.eval import evaluate_dataset
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.tools import count_flops
from mvfnet_tpu_torch.tools import feature_extractor as feature_cli
from mvfnet_tpu_torch.tools import test_recognizer as test_cli
from mvfnet_tpu_torch.tools import train_recognizer as train_cli
from mvfnet_tpu_torch.utils.checkpoint import (jax_variables_from_state_dict,
                                               load_checkpoint)
from test_torch_i3d import (ATOL, RTOL, i3d_backbone, jax_shapes,
                            jax_variables, model_cfg, port_model,
                            tree_shapes)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
CONFIGS = {name: os.path.join(REPO, 'configs', path) for name, path in (
    ('i3d', 'i3d/i3d_r50_32x2_k400.py'),
    ('slowfast', 'slowfast/slowfast_r50_k400.py'),
    ('slowfast_unpacked', 'slowfast/slowfast_r50_k400_unpacked.py'),
    ('x3d', 'x3d/x3d_k400.py'))}
VIDEOS = [('v0', 20, 3), ('v1', 24, 1), ('v2', 18, 4)]
SIZE, CLIPS, CLIP_LEN = 32, 2, 8
SMALL = i3d_backbone(depth=18, num_stages=2, out_indices=(1,))


def small_pipeline(pipeline, crop=None):
    """The config's pipeline with its sizes cut: clips of CLIP_LEN frames,
    CLIPS of them to test, SIZE^2 crops; the ops and their order
    unchanged."""
    out = []
    for op in pipeline:
        op = dict(op)
        if op['type'] == 'SampleFrames':
            op['clip_len'] = CLIP_LEN
            op['num_clips'] = min(op['num_clips'], CLIPS)
        elif op['type'] == 'Resize':
            op['scale'] = (float('inf'), SIZE)
        elif op['type'] in ('ThreeCrop', 'CenterCrop'):
            op['crop_size'] = SIZE
        elif op['type'] in ('RandomResizedCrop', 'RandomRescaledCrop'):
            op['input_size'] = SIZE
        out.append(op)
    return out


@pytest.fixture(scope='module')
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp('i3d_frames')
    rng = np.random.RandomState(0)
    for name, total, _ in VIDEOS:
        os.makedirs(root / name)
        for i in range(total):
            img = cv2.GaussianBlur(rng.randint(0, 256, (SIZE, 40, 3)).astype(
                np.uint8), (5, 5), 0)
            cv2.imwrite(str(root / name / f'img_{i + 1:05}.jpg'), img)
    (root / 'ann.txt').write_text(
        ''.join(f'{n} {t} {lab}\n' for n, t, lab in VIDEOS))
    return root


@pytest.mark.parametrize('name', sorted(CONFIGS))
def test_shipped_config_builds_in_both_packages(name):
    """The config unchanged: the port's parameters, in the JAX layout, have
    the JAX model's names and shapes."""
    cfg = Config.fromfile(CONFIGS[name])
    with torch.device('meta'):
        port = build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype),
                                test_cfg=dict(cfg.test_cfg))
    jcfg = JaxConfig.fromfile(CONFIGS[name])
    shapes = jax_shapes(dict(jcfg.model), (1, 1, 16, SIZE, SIZE, 3))
    variables = jax_variables_from_state_dict(
        {k: torch.empty(v.shape) for k, v in port.state_dict().items()})
    assert tree_shapes({k: variables[k] for k in shapes}) == \
        tree_shapes(shapes)
    assert set(variables) == set(shapes)
    stats = count_flops.main([CONFIGS[name]]) if name == 'i3d' else None
    if stats is not None:
        assert stats['shape'] == (1, 1, 8, 224, 224, 3)
        assert stats['params'] == sum(
            int(np.prod(s.shape)) for s in
            jax.tree_util.tree_leaves(shapes['params']))
        assert stats['gmacs'] > 0


def _pipeline_cfg(root):
    cfg = Config.fromfile(CONFIGS['i3d'])
    return dict(type='RawFramesDataset', ann_file=str(root / 'ann.txt'),
                data_root=str(root), test_mode=True,
                filename_tmpl='img_{:05}.jpg',
                pipeline=small_pipeline(cfg.data['test']['pipeline']))


def test_evaluate_dataset_matches_jax(frames):
    jax.config.update('jax_enable_x64', True)
    try:
        dataset_cfg = _pipeline_cfg(frames)
        dataset = build_dataset(dict(dataset_cfg))
        jdataset = jdata.build_dataset(dict(dataset_cfg))
        for i in range(len(VIDEOS)):
            got, want = dataset[i]['img_group'], jdataset[i]['img_group']
            assert got.shape == (3 * CLIPS, CLIP_LEN, SIZE, SIZE, 3)
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, want)
        norm = [op for op in dataset_cfg['pipeline']
                if op['type'] == 'Normalize'][0]
        norm = {k: v for k, v in norm.items() if k != 'type'}
        test_cfg = dict(average_clips='prob')
        cfg = model_cfg(SMALL, 128)
        port = port_model(cfg)
        port.test_cfg = test_cfg
        variables = jax_variables(port, cfg)
        jmodel = jax_build(cfg, test_cfg=test_cfg)
        for feats in (False, True):
            want = jax_evaluate(jmodel, variables, jdataset,
                                mesh=make_mesh(jax.devices()[:1]),
                                videos_per_gpu=2, workers_per_gpu=2,
                                norm_cfg=norm, extract_feat=feats)
            got = evaluate_dataset(port, dataset, videos_per_gpu=2,
                                   workers_per_gpu=2, norm_cfg=norm,
                                   device='cpu', extract_feat=feats)
            if feats:
                # one row of 6 views x 128 features a video; JAX keeps the
                # first three rows of the run
                assert got.shape == (len(VIDEOS), 3 * CLIPS * 128)
                got = got.reshape(-1, 128)[:len(VIDEOS)]
            else:
                assert got.shape == (len(VIDEOS), 5)
                np.testing.assert_allclose(got.sum(1), 1, rtol=1e-12)
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    finally:
        jax.config.update('jax_enable_x64', False)


def _config(tmp_path, frames):
    """A config inheriting the I3D config: its model shrunk to two stages of
    ResNet-18 and 5 classes, its pipelines' sizes cut, float32, two epochs
    of two iterations with checkpoints and evaluations."""
    base = Config.fromfile(CONFIGS['i3d'])
    train = dict(_pipeline_cfg(frames), test_mode=False,
                 pipeline=small_pipeline(base.data['train']['pipeline']))
    test = _pipeline_cfg(frames)
    lines = [
        f'_base_ = {CONFIGS["i3d"]!r}',
        'model = dict(backbone=dict(depth=18, num_stages=2, '
        'out_indices=(1,)), cls_head=dict(in_channels=128, num_classes=5))',
        "compute_dtype = 'float32'",
        f'data = dict(videos_per_gpu=2, workers_per_gpu=1, train={train!r},'
        f' val={test!r}, test={test!r})',
        'lr_config = dict(warmup_iters=2)',
        'total_epochs = 2', 'checkpoint_config = dict(interval=1)',
        'log_config = dict(interval=1)', 'eval_interval = 1',
        f'work_dir = {str(tmp_path / "work")!r}', '']
    path = tmp_path / 'i3d_small.py'
    path.write_text('\n'.join(lines).replace('inf', "float('inf')"))
    return str(path)


def _losses(work):
    with open(os.path.join(work, 'train.log')) as f:
        text = f.read()
    return text, [float(line.split('loss: ')[1].split(',')[0])
                  for line in text.splitlines() if 'loss: ' in line]


def test_clis_run_the_i3d_config(tmp_path, frames):
    config = _config(tmp_path, frames)
    work = str(tmp_path / 'work')
    loop = train_cli.main([config, '--work_dir', work, '--validate',
                           '--device', 'cpu'])
    text, losses = _losses(work)
    assert 'model: Recognizer3D(ResNet_I3D, I3DClsHead)' in text
    assert loop.iters_per_epoch == 1 and len(losses) == 2
    assert np.isfinite(losses).all()
    assert len(loop.eval_history) == 2
    for name in ('epoch_1.pth', 'epoch_2.pth', 'latest.pth'):
        assert os.path.exists(os.path.join(work, name)), name

    again = str(tmp_path / 'resumed')
    train_cli.main([config, '--work_dir', again, '--device', 'cpu',
                    '--resume_from', os.path.join(work, 'epoch_1.pth')])
    _, resumed = _losses(again)
    assert resumed == losses[1:]
    assert all(torch.equal(v, load_checkpoint(
        os.path.join(work, 'latest.pth'))[0][k]) for k, v in
        load_checkpoint(os.path.join(again, 'latest.pth'))[0].items())

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger('mvfnet_tpu_torch')
    logger.addHandler(handler)
    try:
        ckpt = os.path.join(work, 'latest.pth')
        out = str(tmp_path / 'scores.pkl')
        result = test_cli.main([config, ckpt, '--device', 'cpu', '--out',
                                out])
        feats = str(tmp_path / 'features.json')
        rows = feature_cli.main([config, ckpt, '--device', 'cpu', '--out',
                                 feats])
    finally:
        logger.removeHandler(handler)
    messages = [r.getMessage() for r in records]
    assert sum('model: Recognizer3D(ResNet_I3D, I3DClsHead)' in m
               for m in messages) == 2
    with open(out, 'rb') as f:
        scores = np.stack(pickle.load(f))
    assert scores.shape == (len(VIDEOS), 5)
    np.testing.assert_allclose(scores, result['scores'], rtol=0, atol=0)
    np.testing.assert_allclose(scores.sum(1), 1, rtol=1e-5)
    with open(feats) as f:
        assert json.load(f) == rows
    assert sorted(rows) == sorted(n for n, _, _ in VIDEOS)
    assert {len(v) for v in rows.values()} == {3 * CLIPS * 128}
