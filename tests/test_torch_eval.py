"""Port parity: the dense-test entry point.

``engine.eval.evaluate_dataset`` of the port against the JAX package's on
three rawframe videos in batches of two (the last one partial), with the
MVFNet-R50 of ``test_torch_recognizer.py`` (T=4, 64x64, 11 classes, weights
through ``state_dict_from_jax``) in f64, and the port's CLI
(``python -m mvfnet_tpu_torch.tools.test_recognizer``) on the CPU against
its in-process result.
"""

import os
import pickle
import re
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mvfnet_tpu.data as jdata
import mvfnet_tpu.utils.metrics as jmetrics
from mvfnet_tpu.engine.eval import evaluate_dataset as jax_evaluate
from mvfnet_tpu.engine.eval import reorder_rank_strided as jax_reorder
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.parallel import make_mesh
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.engine.eval import evaluate_dataset, reorder_rank_strided
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.ops import fused_block as fb
from mvfnet_tpu_torch.tools import test_recognizer as cli
from mvfnet_tpu_torch.utils.checkpoint import state_dict_from_jax
from test_torch_recognizer import NUM_CLASSES, SIZE, T, model_cfg

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
VIDEOS = [('v0', 12, 3), ('v1', 20, 7), ('v2', 9, 3)]
CLIPS, CROPS = 2, 3
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


def pipeline(device_norm):
    """The flagship's test pipeline at T=4, 2 clips, 64x80 frames."""
    return [
        dict(type='SampleFrames', clip_len=T, frame_interval=2,
             num_clips=CLIPS),
        dict(type='FrameSelector', use_native=False),
        dict(type='Resize', scale=(float('inf'), SIZE), keep_ratio=True),
        dict(type='ThreeCrop', crop_size=SIZE),
        dict(type='Flip', flip_ratio=0),
        dict(type='Normalize', mean=MEAN, std=STD, to_rgb=True,
             div_255=False, **({'device': True} if device_norm else {})),
        dict(type='FormatShape', input_format='NHWC'),
        dict(type='Collect', keys=['img_group', 'label'], meta_keys=[]),
    ]


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """Frames, annotation file, f64 JAX variables with randomized BN
    statistics, and the port's fp32 checkpoint of the same weights."""
    root = tmp_path_factory.mktemp('eval')
    rng = np.random.RandomState(0)
    for name, total, _ in VIDEOS:
        os.makedirs(root / name)
        for i in range(total):
            img = cv2.GaussianBlur(rng.randint(0, 256, (SIZE, 80, 3)).astype(
                np.uint8), (7, 7), 0)
            cv2.imwrite(str(root / name / f'img_{i + 1:05}.jpg'), img)
    (root / 'ann.txt').write_text(
        ''.join(f'{n} {t} {lab}\n' for n, t, lab in VIDEOS))

    jax.config.update('jax_enable_x64', True)
    cfg, test_cfg = model_cfg('prob')
    jmodel = jax_build(cfg, test_cfg=test_cfg)
    init = jax.jit(lambda key, x: jmodel.init(key, x, None,
                                              return_loss=False))
    variables = init(jax.random.PRNGKey(0),
                     jnp.zeros((1, T, SIZE, SIZE, 3), jnp.float32))
    variables = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64),
                                       variables)
    brng = np.random.RandomState(1)
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda v: (brng.uniform(0.8, 1.2, v.shape) if v.min() == 1.0
                   else brng.normal(0, 0.05, v.shape)),
        variables['batch_stats'])
    sd = {k: (v.float() if v.is_floating_point() else v)
          for k, v in state_dict_from_jax(variables).items()}
    torch.save({'state_dict': sd}, root / 'model.pth')
    yield root, variables
    jax.config.update('jax_enable_x64', False)


def dataset_cfg(root, device_norm):
    return dict(type='RawFramesDataset', ann_file=str(root / 'ann.txt'),
                data_root=str(root), pipeline=pipeline(device_norm),
                test_mode=True)


@pytest.mark.parametrize('device_norm', [False, True])
@pytest.mark.parametrize('average_clips', ['prob', 'score'])
def test_evaluate_dataset_matches_jax(setup, average_clips, device_norm,
                                      monkeypatch):
    root, variables = setup
    norm = dict(mean=MEAN, std=STD, to_rgb=True, div_255=False,
                device=True) if device_norm else None
    cfg, test_cfg = model_cfg(average_clips)
    want = jax_evaluate(jax_build(cfg, test_cfg=test_cfg), variables,
                        jdata.build_dataset(dataset_cfg(root, device_norm)),
                        mesh=make_mesh(jax.devices()[:1]), videos_per_gpu=2,
                        workers_per_gpu=2, norm_cfg=norm)

    port = build_recognizer(cfg, test_cfg=test_cfg).double()
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    calls = []
    real = fb.bottleneck_eval
    monkeypatch.setattr(fb, 'bottleneck_eval',
                        lambda *a: calls.append(a[0].shape) or real(*a))
    got = evaluate_dataset(port, build_dataset(dataset_cfg(root,
                                                           device_norm)),
                           videos_per_gpu=2, workers_per_gpu=2,
                           norm_cfg=norm, device='cpu')
    assert got.dtype == np.float64
    assert got.shape == want.shape == (len(VIDEOS), NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    # 5 fused blocks per batch: a batch of 2 videos, then 1
    frames = CROPS * CLIPS * T
    assert [tuple(s) for s in calls] == (
        [(2 * frames, 16, 16, 256)] * 2 + [(2 * frames, 8, 8, 512)] * 3
        + [(frames, 16, 16, 256)] * 2 + [(frames, 8, 8, 512)] * 3)
    if average_clips == 'prob':
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-12)


def test_evaluate_dataset_edges(setup, tmp_path):
    root, _ = setup
    model = torch.nn.Linear(2, 2)
    (tmp_path / 'empty.txt').write_text('')
    empty = build_dataset(dict(dataset_cfg(root, False),
                               ann_file=str(tmp_path / 'empty.txt')))
    assert evaluate_dataset(model, empty, device='cpu').shape == (0, 0)
    with pytest.raises(NotImplementedError, match='A5'):
        evaluate_dataset(model, empty, extract_feat=True, device='cpu')


@pytest.mark.parametrize('world,n', [(1, 5), (2, 5), (3, 7), (4, 2)])
def test_reorder_rank_strided_matches_jax(world, n):
    per_rank = -(-n // world)
    gathered = np.random.RandomState(world).rand(world * per_rank, 6)
    np.testing.assert_array_equal(reorder_rank_strided(gathered, world, n),
                                  jax_reorder(gathered, world, n))


def write_config(root, path):
    cfg, _ = model_cfg('prob')
    cfg.pop('fcn_testing')
    cfg.pop('dtype')
    ds = dataset_cfg(root, False)
    text = (f'model = {cfg!r}\n'
            "test_cfg = dict(average_clips='prob')\n"
            f'data = dict(videos_per_gpu=2, workers_per_gpu=2, '
            f'test={ds!r})\n')
    text = re.sub(r'\binf\b', "float('inf')", text)
    path.write_text(text)
    return str(path)


ACC = re.compile(r'^(Top-1 Accuracy|Top-5 Accuracy|Mean Class Accuracy) = '
                 r'(\d+\.\d\d)$', re.M)


def run_cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, '-m', 'mvfnet_tpu_torch.tools.test_recognizer']
        + [str(a) for a in args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


@pytest.mark.parametrize('fcn_testing', [True, False])
def test_cli_matches_in_process_evaluation(setup, tmp_path, fcn_testing):
    root, _ = setup
    config = write_config(root, tmp_path / 'cfg.py')
    out = tmp_path / 'scores.pkl'
    flags = ['--fcn_testing'] if fcn_testing else []
    proc = run_cli(config, root / 'model.pth', '--device', 'cpu', '--out',
                   out, '--videos_per_gpu', 2, *flags)
    assert proc.returncode == 0, proc.stderr
    with open(out, 'rb') as f:
        rows = pickle.load(f)
    assert isinstance(rows, list) and len(rows) == len(VIDEOS)
    assert all(r.shape == (NUM_CLASSES,) for r in rows)

    cfg = Config.fromfile(config)
    model = cli.build_model(cfg, fcn_testing, 'prob')
    cli.load_checkpoint(model, str(root / 'model.pth'))
    want = evaluate_dataset(model, build_dataset(dict(cfg.data['test'])),
                            videos_per_gpu=2, device='cpu')
    # the same fp32 arithmetic in two processes
    np.testing.assert_allclose(np.stack(rows), want, rtol=1e-6, atol=1e-7)

    labels = [lab for _, _, lab in VIDEOS]
    top1, top5 = jmetrics.top_k_accuracy(rows, labels, k=(1, 5))
    mca = jmetrics.mean_class_accuracy(rows, labels)
    assert ACC.findall(proc.stdout) == [
        ('Top-1 Accuracy', f'{top1 * 100:.02f}'),
        ('Top-5 Accuracy', f'{top5 * 100:.02f}'),
        ('Mean Class Accuracy', f'{mca * 100:.02f}')]


def test_cli_defaults_to_cuda_and_refuses_without_it(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    root, _ = setup
    config = write_config(root, tmp_path / 'cfg.py')
    proc = run_cli(config, root / 'model.pth')
    assert proc.returncode != 0
    assert 'CUDA is not available' in proc.stderr
    assert ACC.findall(proc.stdout) == []


def test_cli_refuses_what_is_not_ported(setup, tmp_path):
    root, _ = setup
    config = write_config(root, tmp_path / 'cfg.py')
    with pytest.raises(NotImplementedError, match='A9'):
        cli.main([config, str(tmp_path / 'model.msgpack'), '--device',
                  'cpu'])
    with pytest.raises(NotImplementedError, match='A8'):
        cli.main([config, str(root / 'model.pth'), '--launcher', 'env'])
    quant = tmp_path / 'quant.py'
    quant.write_text(f"_base_ = '{config}'\n"
                     "model = dict(backbone=dict(quant='int8_static'))\n")
    with pytest.raises(NotImplementedError, match='A13'):
        cli.main([str(quant), str(root / 'model.pth'), '--device', 'cpu'])
