"""Port parity: the dense-test entry point.

``engine.eval.evaluate_dataset`` of the port against the JAX package's on
three rawframe videos in batches of two (the last one partial), one clip
of three crops a video, with the first two stages of the MVFNet-R50 of
``test_torch_recognizer.py`` (MVF in the first; T=4, 64x64, 11 classes;
the port's seeded weights with randomized BN
statistics, carried into the JAX layout with
``jax_variables_from_state_dict``) in f64, and the port's CLI
(``python -m mvfnet_tpu_torch.tools.test_recognizer``) on the CPU against
its in-process result.
"""

import json
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
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.engine.eval import evaluate_dataset, reorder_rank_strided
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.ops import fused_block as fb
from mvfnet_tpu_torch.tools import test_recognizer as cli
from mvfnet_tpu_torch.utils.checkpoint import (jax_variables_from_state_dict,
                                               state_dict_from_jax)
from test_torch_recognizer import NUM_CLASSES, SIZE, T
from test_torch_recognizer import model_cfg as recognizer_cfg

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
VIDEOS = [('v0', 12, 3), ('v1', 20, 7), ('v2', 9, 3)]
CLIPS, CROPS = 1, 3
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


def model_cfg(average_clips):
    """``test_torch_recognizer.py``'s MVFNet-R50 on its first two stages,
    MVF in the first: ``layer2.1-3`` fuse, ``layer1`` does not."""
    cfg, test_cfg = recognizer_cfg(average_clips)
    backbone = dict(cfg['backbone'], num_stages=2, out_indices=(1,))
    module = dict(cfg['module_cfg'], mvf_freq=(1, 0))
    return dict(cfg, backbone=backbone, module_cfg=module,
                cls_head=dict(cfg['cls_head'], in_channels=512)), test_cfg


def pipeline(device_norm):
    """The flagship's test pipeline at T=4, 1 clip, 64x80 frames."""
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

    cfg, test_cfg = model_cfg('prob')
    jmodel = jax_build(cfg, test_cfg=test_cfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, T, SIZE, SIZE, 3)), None,
        return_loss=False))
    port = build_recognizer(cfg, test_cfg=test_cfg).double()
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    variables = jax_variables_from_state_dict(port.state_dict())
    variables = {k: variables[k] for k in shapes}
    assert jax.tree_util.tree_structure(variables) == \
        jax.tree_util.tree_structure(shapes)
    assert all(v.shape == s.shape for v, s in zip(
        jax.tree_util.tree_leaves(variables),
        jax.tree_util.tree_leaves(shapes)))
    jax.config.update('jax_enable_x64', True)
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
    # 3 fused blocks per batch (layer2.1-3): a batch of 2 videos, then 1
    frames = CROPS * CLIPS * T
    assert [tuple(s) for s in calls] == (
        [(2 * frames, 8, 8, 512)] * 3 + [(frames, 8, 8, 512)] * 3)
    if average_clips == 'prob':
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-12)


def test_evaluate_dataset_edges(setup, tmp_path):
    root, _ = setup
    model = torch.nn.Linear(2, 2)
    (tmp_path / 'empty.txt').write_text('')
    empty = build_dataset(dict(dataset_cfg(root, False),
                               ann_file=str(tmp_path / 'empty.txt')))
    assert evaluate_dataset(model, empty, device='cpu').shape == (0, 0)
    assert evaluate_dataset(model, empty, extract_feat=True,
                            device='cpu').shape == (0, 0)


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
    trace = tmp_path / 'spans.json'
    proc = run_cli(config, root / 'model.pth', '--device', 'cpu', '--out',
                   out, '--videos_per_gpu', 2, '--trace', trace, *flags)
    assert proc.returncode == 0, proc.stderr
    with open(out, 'rb') as f:
        rows = pickle.load(f)
    assert isinstance(rows, list) and len(rows) == len(VIDEOS)
    assert all(r.shape == (NUM_CLASSES,) for r in rows)
    # --trace wrote the pass's spans: a wait and an item a video, a step a
    # batch of two
    with open(trace) as f:
        names = [e['name'] for e in json.load(f)['traceEvents']
                 if e['ph'] == 'X']
    assert [names.count(n) for n in ('eval.pass', 'loader.wait',
                                     'data.getitem', 'step.eval')] == [
        1, len(VIDEOS), len(VIDEOS), 2]

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


def test_both_clis_score_a_pth_without_num_batches_tracked_alike(setup,
                                                                tmp_path):
    """The JAX package's CLI (a subprocess) and the port's on one ``.pth``
    without ``num_batches_tracked`` and a config without ``compute_dtype``:
    both load it non-strictly and compute in float32, so their pickles
    agree. Two videos at 32x32, one centre crop of one clip."""
    root, _ = setup
    sd = torch.load(root / 'model.pth', weights_only=False)['state_dict']
    ckpt = tmp_path / 'no_nbt.pth'
    torch.save({'state_dict': {k: v for k, v in sd.items()
                               if not k.endswith('num_batches_tracked')}},
               ckpt)
    (tmp_path / 'ann.txt').write_text(
        ''.join(f'{n} {t} {lab}\n' for n, t, lab in VIDEOS[:2]))
    cfg, _ = model_cfg('prob')
    cfg.pop('fcn_testing')
    cfg.pop('dtype')
    test = dict(dataset_cfg(root, False), ann_file=str(tmp_path / 'ann.txt'))
    test['pipeline'] = [
        dict(op, num_clips=1) if op['type'] == 'SampleFrames'
        else dict(type='Resize', scale=(float('inf'), 32), keep_ratio=True)
        if op['type'] == 'Resize'
        else dict(type='CenterCrop', crop_size=32)
        if op['type'] == 'ThreeCrop' else op for op in test['pipeline']]
    config = tmp_path / 'cfg.py'
    config.write_text(re.sub(r'\binf\b', "float('inf')", (
        f'model = {cfg!r}\n'
        "test_cfg = dict(average_clips='prob')\n"
        f'data = dict(videos_per_gpu=1, workers_per_gpu=2, test={test!r})\n'
        )))
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS='cpu')
    want_pkl = tmp_path / 'jax.pkl'
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, 'test_recognizer.py'),
         str(config), str(ckpt), '--out', str(want_pkl)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    got = cli.main([str(config), str(ckpt), '--device', 'cpu'])
    with open(want_pkl, 'rb') as f:
        want = np.stack(pickle.load(f))
    assert got['scores'].dtype == want.dtype == np.float32
    assert got['scores'].shape == want.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got['scores'], want, rtol=1e-5)
    assert ACC.findall(proc.stdout)[0] == (
        'Top-1 Accuracy', f'{got["top1"] * 100:.02f}')

    model = cli.build_model(Config.fromfile(str(config)), False, 'prob')
    report = cli.load_checkpoint(model, str(ckpt))
    assert (report['missing'], report['unexpected'],
            report['mismatched']) == ([], [], [])
    assert len(report['applied']) == len(sd) - sum(
        k.endswith('num_batches_tracked') for k in sd)


def test_cli_computes_in_the_config_dtype():
    """The port's CLI scores in the config's ``compute_dtype``: bf16 for the
    flagship (the JAX CLI's recognizer computes in float32 whatever the
    config says), float32 without one."""
    flagship = Config.fromfile(os.path.join(
        REPO, 'configs', 'mvf', 'k400', 'mvf_kinetics400_r50_8x8_dense.py'))
    model = cli.build_model(flagship, True, 'prob')
    assert model.compute_dtype == torch.bfloat16
    assert model.cls_head.new_fc.weight.dtype == torch.float32
    flagship.compute_dtype = None
    assert cli.build_model(flagship, True, 'prob').compute_dtype == \
        torch.float32


def test_cli_scores_a_jax_msgpack_as_its_pth(setup, tmp_path):
    """The JAX package's ``.msgpack`` of the weights in ``model.pth`` (f64
    values that float32 holds exactly) scores as the ``.pth`` does, with
    an empty import report."""
    root, variables = setup
    config = write_config(root, tmp_path / 'cfg.py')
    sd = torch.load(root / 'model.pth', weights_only=False)['state_dict']
    exact = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32).astype(np.float64), variables)
    ckpt = str(tmp_path / 'model.msgpack')
    jax_save(ckpt, exact, meta={'epoch': 3, 'iter': 30})
    got = cli.main([config, ckpt, '--device', 'cpu'])
    want = cli.main([config, str(root / 'model.pth'), '--device', 'cpu'])
    np.testing.assert_array_equal(got['scores'], want['scores'])
    model = cli.build_model(Config.fromfile(config), False, 'prob')
    report = cli.load_checkpoint(model, ckpt)
    assert (report['missing'], report['unexpected'],
            report['mismatched']) == ([], [], [])
    assert all(torch.equal(model.state_dict()[k], v) for k, v in sd.items()
               if not k.endswith('num_batches_tracked'))


def test_cli_refuses_what_is_not_ported(setup, tmp_path, monkeypatch):
    """What the CLI once refused it now runs (the int8 path): a
    ``.msgpack`` with a ``quant_stats`` collection scores in an
    unquantized model as without it (the JAX CLI restores only the
    model's collections), and an ``int8_static`` config calibrates on
    ``--calib_videos`` videos first, or refuses to score uncalibrated with
    ``--calib_videos 0``. ``--launcher env`` without torchrun's variables
    still raises."""
    root, variables = setup
    config = write_config(root, tmp_path / 'cfg.py')
    stats = {'backbone_mod': {'layer1_0': {'conv1': {
        'act_amax': np.float32(2.5), 'act_amax_calibrated': np.float32(1)}}}}
    exact = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float32).astype(np.float64), variables)
    calibrated = str(tmp_path / 'quant.msgpack')
    jax_save(calibrated, dict(exact, quant_stats=stats))
    got = cli.main([config, calibrated, '--device', 'cpu'])
    want = cli.main([config, str(root / 'model.pth'), '--device', 'cpu'])
    np.testing.assert_array_equal(got['scores'], want['scores'])
    assert got['quant_stats'] == {}
    # --launcher env needs torchrun's variables (tests/test_torch_dist.py
    # runs the CLI under torchrun)
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
              'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(KeyError, match='MASTER_ADDR'):
        cli.main([config, str(root / 'model.pth'), '--launcher', 'env',
                  '--device', 'cpu'])
    quant = tmp_path / 'quant.py'
    quant.write_text(f"_base_ = '{config}'\n"
                     "model = dict(backbone=dict(quant='int8_static'))\n")
    with pytest.raises(ValueError, match='calibrated'):
        cli.main([str(quant), str(root / 'model.pth'), '--device', 'cpu',
                  '--calib_videos', '0'])
    out = cli.main([str(quant), str(root / 'model.pth'), '--device', 'cpu',
                    '--calib_videos', '1'])
    assert out['scores'].shape == want['scores'].shape
    assert np.isfinite(out['scores']).all()
    markers = [v for k, v in out['quant_stats'].items()
               if k.endswith('calibrated')]
    assert markers and all(float(v) == 1 for v in markers)
