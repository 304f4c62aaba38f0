"""Port parity: feature extraction.

Three rawframe videos (the frames of ``test_torch_eval.py``), one clip of
T=4 frames each, a 32x32 centre crop, through the first two stages of
MVFNet-R50 (MVF in the first, T=4, 11 classes; ``test_torch_eval.py``'s
model) in f64 on both sides. The weights are the port's seeded init with
randomized BN statistics, carried into the JAX package with
``jax_variables_from_state_dict``; they are float32 numbers, so a float32
checkpoint holds them exactly.

- ``Recognizer2D.forward_extract_feat`` with and without ``fcn_testing``
  against the JAX package's on the three videos' frames, and
  ``evaluate_dataset(extract_feat=True)`` in batches of two against the
  same rows, one row of ``rows * C`` a video (rtol 1e-6 / atol 1e-8).
- The JAX package's ``evaluate_dataset(extract_feat=True)`` keeps the
  first N rows of its (N * rows, C) result (``mvfnet_tpu/engine/eval.py``,
  ``local[:len(dataset)]``): the port's rows laid out as (N * rows, C),
  cut the same way, equal it. With one row a video (``fcn_testing``, one
  clip, one crop) that is the whole result.
- The feature CLI's ``main`` in a subprocess on the CPU, from a
  ``.msgpack`` the JAX package wrote, with a config without
  ``compute_dtype`` and torch's default dtype f64 (so the model's
  parameters and compute are f64), against the JAX features at the same
  tolerance.
- A score pass and then a feature pass on one model return scores and
  features: the eval step cache tells the two apart.
"""

import json
import os
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
from mvfnet_tpu.engine.eval import evaluate_dataset as jax_evaluate
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.parallel import make_mesh
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.engine.eval import evaluate_dataset
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.tools import feature_extractor as cli
from mvfnet_tpu_torch.utils.checkpoint import jax_variables_from_state_dict
from test_torch_eval import model_cfg
from test_torch_recognizer import NUM_CLASSES, T

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
VIDEOS = [('v0', 12, 3), ('v1', 20, 7), ('v2', 9, 3)]
CROP, C = 32, 512
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]


def dataset_cfg(root):
    return dict(
        type='RawFramesDataset', ann_file=str(root / 'ann.txt'),
        data_root=str(root), test_mode=True, pipeline=[
            dict(type='SampleFrames', clip_len=T, frame_interval=2,
                 num_clips=1),
            dict(type='FrameSelector'),
            dict(type='Resize', scale=(float('inf'), CROP), keep_ratio=True),
            dict(type='CenterCrop', crop_size=CROP),
            dict(type='Normalize', mean=MEAN, std=STD, to_rgb=True),
            dict(type='FormatShape', input_format='NHWC'),
            dict(type='Collect', keys=['img_group', 'label'], meta_keys=[]),
        ])


def cfgs(fcn_testing):
    cfg, _ = model_cfg(None)
    return dict(cfg, fcn_testing=fcn_testing), dict(average_clips=None)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    """Frames, the port's weights as f64 JAX variables, the stacked
    frames of the three videos, and per ``fcn_testing`` the JAX package's
    ``forward_extract_feat`` rows on them and its ``evaluate_dataset``
    features."""
    root = tmp_path_factory.mktemp('features')
    rng = np.random.RandomState(0)
    for name, total, _ in VIDEOS:
        os.makedirs(root / name)
        for i in range(total):
            img = cv2.GaussianBlur(rng.randint(0, 256, (64, 80, 3)).astype(
                np.uint8), (7, 7), 0)
            cv2.imwrite(str(root / name / f'img_{i + 1:05}.jpg'), img)
    (root / 'ann.txt').write_text(
        ''.join(f'{n} {t} {lab}\n' for n, t, lab in VIDEOS))

    jax.config.update('jax_enable_x64', True)
    port = build_recognizer(cfgs(True)[0])
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    state = port.state_dict()
    variables = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float64),
        jax_variables_from_state_dict(state))
    dataset = jdata.build_dataset(dataset_cfg(root))
    frames = np.stack([dataset[i]['img_group'] for i in range(len(VIDEOS))])
    want = {}
    for fcn in (True, False):
        cfg, test_cfg = cfgs(fcn)
        jmodel = jax_build(cfg, test_cfg=test_cfg)
        feats = jax_evaluate(jmodel, variables, dataset,
                             mesh=make_mesh(jax.devices()[:1]),
                             videos_per_gpu=2, workers_per_gpu=2,
                             extract_feat=True)
        # one row a video with fcn_testing: the evaluation's result is
        # every row; per frame it keeps the first N rows only
        rows = feats if fcn else jax.jit(lambda v, x: jmodel.apply(
            v, x, method=lambda m, a: m.forward_extract_feat(a)))(
                variables, jnp.asarray(frames))
        want[fcn] = (np.asarray(rows), feats)
    yield dict(root=root, state=state, variables=variables, frames=frames,
               want=want)
    jax.config.update('jax_enable_x64', False)


def port_model(setup, fcn_testing):
    cfg, test_cfg = cfgs(fcn_testing)
    model = build_recognizer(cfg, test_cfg=test_cfg)
    model.load_state_dict(setup['state'], strict=True)
    return model.double().eval()


@pytest.mark.parametrize('fcn_testing', [True, False])
def test_features_match_jax(setup, fcn_testing):
    rows, jax_feats = setup['want'][fcn_testing]
    per_video = 1 if fcn_testing else T
    assert rows.shape == (len(VIDEOS) * per_video, C)

    model = port_model(setup, fcn_testing)
    with torch.no_grad():
        got = model.forward_extract_feat(torch.from_numpy(setup['frames']))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), rows, rtol=1e-6, atol=1e-8)

    feats = evaluate_dataset(model, build_dataset(dataset_cfg(setup['root'])),
                             videos_per_gpu=2, workers_per_gpu=2,
                             extract_feat=True, device='cpu')
    assert feats.shape == (len(VIDEOS), per_video * C)
    np.testing.assert_allclose(feats, rows.reshape(len(VIDEOS), -1),
                               rtol=1e-6, atol=1e-8)
    # the JAX package keeps the first N of its N * rows rows
    assert jax_feats.shape == (len(VIDEOS), C)
    np.testing.assert_allclose(feats.reshape(-1, C)[:len(VIDEOS)], jax_feats,
                               rtol=1e-6, atol=1e-8)


def test_feature_cli_matches_jax(setup, tmp_path, monkeypatch):
    cfg, _ = cfgs(True)
    cfg.pop('fcn_testing')
    cfg.pop('dtype')
    config = tmp_path / 'cfg.py'
    config.write_text(re.sub(r'\binf\b', "float('inf')", (
        f'model = {cfg!r}\n'
        f'data = dict(videos_per_gpu=2, workers_per_gpu=2, '
        f'test={dataset_cfg(setup["root"])!r})\n')))
    ckpt = str(tmp_path / 'jax.msgpack')
    jax_save(ckpt, setup['variables'], meta={'epoch': 1, 'iter': 1})
    out = tmp_path / 'features.json'
    env = dict(os.environ, PYTHONPATH=REPO)
    # the CLI's main with f64 parameters (torch's default dtype) and a
    # config without compute_dtype: the model computes in f64
    proc = subprocess.run(
        [sys.executable, '-c',
         'import sys, torch; torch.set_default_dtype(torch.float64); '
         'from mvfnet_tpu_torch.tools import feature_extractor; '
         'feature_extractor.main(sys.argv[1:])',
         str(config), ckpt, '--fcn_testing', '--videos_per_gpu', '2',
         '--device', 'cpu', '--out', str(out)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    written = json.loads(out.read_text())
    assert list(written) == [name for name, _, _ in VIDEOS]
    _, jax_feats = setup['want'][True]
    np.testing.assert_allclose(np.array(list(written.values())), jax_feats,
                               rtol=1e-6, atol=1e-8)
    # --launcher env needs torchrun's variables (tests/test_torch_dist.py
    # runs the CLI under torchrun)
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
              'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(KeyError, match='MASTER_ADDR'):
        cli.main([str(config), ckpt, '--launcher', 'env', '--device', 'cpu'])


def test_score_then_feature_pass_on_one_model(setup):
    """The cached eval step is keyed by mode: after a score pass, a feature
    pass on the same model gives the features a fresh model gives. The
    head's ``extract_feat`` flag makes the dense-test forward return them
    too."""
    model = port_model(setup, True)
    dataset = build_dataset(dataset_cfg(setup['root']))
    scores = evaluate_dataset(model, dataset, device='cpu')
    feats = evaluate_dataset(model, dataset, extract_feat=True, device='cpu')
    assert scores.shape == (len(VIDEOS), NUM_CLASSES)
    rows, _ = setup['want'][True]
    assert feats.shape == (len(VIDEOS), C)
    np.testing.assert_allclose(feats, rows, rtol=1e-6, atol=1e-8)

    model.cls_head.extract_feat = True
    with torch.no_grad():
        head_feats = model(torch.from_numpy(setup['frames']), None,
                           return_loss=False)
    np.testing.assert_allclose(head_feats.numpy(), rows, rtol=1e-6,
                               atol=1e-8)
