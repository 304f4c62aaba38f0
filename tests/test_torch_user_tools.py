"""The port's user tools against the JAX package's: ``convert_checkpoint``
(``.pth`` -> ``.msgpack``, with Flow stem inflation) and ``validate_k400``
(the accuracy runbook, without ``--quant``).

The converter's file must load through the JAX package's
``load_checkpoint`` with the same leaves, bit for bit, as the JAX tool's
file of the same seeded ``.pth`` (the route of
``tests/test_cli_torch_ckpt.py``), and the same sidecar. The runbook runs
on synthetic frames (as ``tests/test_validate_k400.py``): its JSON has the
JAX tool's keys, and its Top-1 is what ``report_accuracy`` gives on the
port's own test-CLI scores of the same videos, so no JAX run is needed for
the number.
"""

import ast
import importlib.util
import json
import os
import sys
import textwrap

import cv2
import numpy as np
import pytest
import torch

import jax

from mvfnet_tpu.utils.checkpoint import load_checkpoint as jax_load
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.tools import (convert_checkpoint, report_accuracy,
                                    test_recognizer, validate_k400)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
NUM_CLASSES = 3


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_tool_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_config(path, modality='RGB', data=None):
    path.write_text(textwrap.dedent(f'''
        import numpy as np
        clip_len = 2
        model = dict(
            type='Recognizer2D', modality={modality!r},
            backbone=dict(type='ResNet', depth=18, num_stages=2,
                          out_indices=(1,), norm_eval=False),
            cls_head=dict(type='TSNClsHead', spatial_size=-1,
                          spatial_type='avg', dropout_ratio=0.5,
                          in_channels=128, init_std=0.01,
                          num_classes={NUM_CLASSES}))
        test_cfg = dict(average_clips='prob')
        compute_dtype = 'float32'
        norm = dict(mean=[123.675, 116.28, 103.53],
                    std=[58.395, 57.12, 57.375], to_rgb=True, device=True)
        data = dict(
            videos_per_gpu=1, workers_per_gpu=2,
            test=dict(type='RawFramesDataset',
                      ann_file='{data}/ann.txt', data_root='{data}',
                      pipeline=[
                          dict(type='SampleFrames', clip_len=2,
                               frame_interval=2, num_clips=2),
                          dict(type='FrameSelector'),
                          dict(type='Resize', scale=(np.inf, 36),
                               keep_ratio=True),
                          dict(type='CenterCrop', crop_size=32),
                          dict(type='Normalize', div_255=False, **norm),
                          dict(type='FormatShape', input_format='NHWC'),
                          dict(type='Collect',
                               keys=['img_group', 'label'], meta_keys=[]),
                      ], test_mode=True, modality='RGB',
                      filename_tmpl='img_{{:05}}.jpg'))
        log_level = 'INFO'
    '''))
    return str(path)


def _seeded_pth(config, path, seed):
    cfg = Config.fromfile(config)
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    model.init_weights(torch.Generator().manual_seed(seed),
                       randomize_bn=True)
    torch.save({'state_dict': model.state_dict()}, str(path))
    return str(path)


@pytest.mark.parametrize('modality', ['RGB', 'Flow'])
def test_convert_checkpoint_matches_the_jax_tool(tmp_path, monkeypatch,
                                                 modality):
    """A seeded RGB ``.pth``; for Flow, a Flow config and ``--modality
    Flow``: the stem's mean over RGB broadcast to 10 channels. The JAX tool
    initializes every model from 3-channel frames, so for Flow its file
    keeps a 3-channel stem of init values (the inflated one reported
    mismatched; ROADMAP.md, section C): there the port's stem is held to
    the JAX importer's inflation instead, every other leaf to the file."""
    rgb = _write_config(tmp_path / 'rgb.py', data=tmp_path)
    config = _write_config(tmp_path / 'cfg.py', modality, data=tmp_path)
    src = _seeded_pth(rgb, tmp_path / 'src.pth', 3)
    extra = ['--modality', modality] if modality != 'RGB' else []
    ours, theirs = str(tmp_path / 'port.msgpack'), str(
        tmp_path / 'jax.msgpack')
    report = convert_checkpoint.main([config, src, ours] + extra)
    assert report['missing'] == report['unexpected'] == \
        report['mismatched'] == []
    monkeypatch.setattr(sys, 'argv', ['convert_checkpoint.py', config, src,
                                      theirs] + extra)
    _jax_tool('convert_checkpoint').main()
    got, got_opt, got_meta = jax_load(ours)
    want, want_opt, want_meta = jax_load(theirs)
    stem = ('params', 'backbone_mod', 'conv1', 'kernel')
    if modality == 'Flow':
        assert want['params']['backbone_mod']['conv1']['kernel'].shape == \
            (7, 7, 3, 64)
        rgb_stem = torch.load(src)['state_dict']['backbone.conv1.weight']
        hwio = rgb_stem.numpy().transpose(2, 3, 1, 0)
        inflated = np.broadcast_to(hwio.mean(axis=2, keepdims=True),
                                   (7, 7, 10, 64))
        np.testing.assert_allclose(got['params']['backbone_mod']['conv1'][
            'kernel'], inflated, rtol=1e-6)
        for tree in (got, want):
            del tree['params']['backbone_mod']['conv1']
    got_leaves = dict(jax.tree_util.tree_leaves_with_path(got))
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    assert sorted(map(str, got_leaves)) == sorted(map(str, want_leaves))
    for path, v in want_leaves.items():
        assert got_leaves[path].dtype == v.dtype
        np.testing.assert_array_equal(got_leaves[path], v,
                                      err_msg=jax.tree_util.keystr(path))
    assert got_opt is want_opt is None and got_meta == want_meta
    assert len(got_leaves) > 40 and (modality == 'Flow') != any(
        tuple(k.key for k in p) == stem for p in got_leaves)


@pytest.fixture(scope='module')
def frames_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('validate')
    rng = np.random.RandomState(0)
    lines = []
    for v in range(4):
        d = root / f'v{v}'
        d.mkdir()
        for f in range(10):
            cv2.imwrite(str(d / f'img_{f + 1:05d}.jpg'),
                        rng.randint(0, 255, (48, 64, 3), np.uint8))
        lines.append(f'v{v} 10 {v % NUM_CLASSES}')
    (root / 'ann.txt').write_text('\n'.join(lines) + '\n')
    return root


def _jax_result_keys():
    """The keys of the JAX tool's verdict (its ``result`` literal)."""
    tree = ast.parse(open(os.path.join(REPO, 'tools',
                                       'validate_k400.py')).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], 'id', None) == 'result':
            return [k.value for k in node.value.keys]
    raise AssertionError('no result dict in tools/validate_k400.py')


def test_validate_k400_verdict(frames_root, tmp_path, capsys):
    config = _write_config(tmp_path / 'cfg.py', data=frames_root)
    ckpt = _seeded_pth(config, tmp_path / 'model.pth', 5)
    ann = str(frames_root / 'ann.txt')
    common = ['--checkpoint', ckpt, '--ann', ann, '--data-root',
              str(frames_root), '--config', config, '--device', 'cpu',
              '--max-videos', '4']
    out = tmp_path / 'verdict.json'
    assert validate_k400.main(common + ['--expected-top1', '0.0',
                                        '--out', str(out)]) == 0
    verdict = json.loads(out.read_text())
    printed = [ln for ln in capsys.readouterr().out.splitlines()
               if ln.startswith('{')][-1]
    assert json.loads(printed) == verdict
    assert list(verdict) == _jax_result_keys()
    assert verdict['n_videos'] == 4 and verdict['pass'] is True
    assert verdict['quant'] is None and verdict['config'] == 'cfg'

    scores = str(tmp_path / 'scores.pkl')
    test_recognizer.main([config, ckpt, '--fcn_testing', '--out', scores,
                          '--device', 'cpu'])
    fused = report_accuracy.main(['--scores', scores, '--coefficients', '1',
                                  '--datalist', ann])
    assert verdict['top1'] == round(fused['top1'] * 100, 2)
    assert verdict['top5'] == round(fused['top5'] * 100, 2)
    assert verdict['mean_class_acc'] == round(fused['mean_class'] * 100, 2)

    assert validate_k400.main(common + ['--expected-top1', '101.0']) == 1
    # the int8 path, once refused: calibrated on --calib-videos, the
    # verdict names it
    assert validate_k400.main(common + [
        '--quant', 'int8_static', '--quant-stages', '1', '0', '0', '0',
        '--calib-videos', '2', '--expected-top1', '0.0', '--out',
        str(out)]) == 0
    quant = json.loads(out.read_text())
    assert quant['quant'] == 'int8_static' and quant['n_videos'] == 4
    assert list(quant) == _jax_result_keys()
