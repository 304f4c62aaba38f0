"""Port parity: video files (``VideoDataset``, the four decoders, the probe)
against the JAX package.

Three mp4v files written by ``cv2.VideoWriter`` (24 frames of 64x48 at 10
fps, textured content that changes every frame) and one file that is not a
container. Frames and the float32 pipeline output are bit-equal to the JAX
package's for every decoder name in both modes, with the JAX package on its
default path (its native FFmpeg worker where built) and pinned to its cv2
branch; the retry draws are the JAX package's one for one. Dense-test
scores and features of ResNet-18+MVF at 32x32 on a video list match the
JAX package's ``evaluate_dataset`` in f64 (rtol 1e-6 / atol 1e-8), and the
port's test CLI scores the list in-process.
"""

import contextlib
import io
import os
import pickle
import re

import cv2
import numpy as np
import pytest
import torch

import jax

from mvfnet_tpu.config import Config as JaxConfig
from mvfnet_tpu.data import build_dataset as jax_dataset
from mvfnet_tpu.data import video_io as jax_video_io
from mvfnet_tpu.engine.eval import evaluate_dataset as jax_evaluate
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.parallel.mesh import make_mesh
from mvfnet_tpu.utils import metrics as jmetrics
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.data import build_dataset, dataset_decoder
from mvfnet_tpu_torch.data import video_io
from mvfnet_tpu_torch.engine.eval import evaluate_dataset
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.tools import test_recognizer as cli
from mvfnet_tpu_torch.utils.checkpoint import jax_variables_from_state_dict

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
VIDEO_CONFIG = os.path.join(REPO, 'configs', 'mvf', 'k400',
                            'mvf_kinetics400_video_r50_4x16_dense.py')
FRAMES, W, H = 24, 64, 48
LABELS = [0, 1, 3]
T, SIZE, NUM_CLASSES = 2, 32, 5
MEAN, STD = [123.675, 116.28, 103.53], [58.395, 57.12, 57.375]
# (decoder op, accurate) for every decoder name and both PyAV modes
DECODERS = [('PyAVDecode', True), ('PyAVDecode', False),
            ('DecordDecode', True), ('OpenCVDecode', False),
            ('PIMSDecode', True)]


@pytest.fixture(scope='module')
def video_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('videos')
    rng = np.random.RandomState(0)
    for v in range(len(LABELS)):
        writer = cv2.VideoWriter(str(root / f'vid{v}.mp4'),
                                 cv2.VideoWriter_fourcc(*'mp4v'), 10.0,
                                 (W, H))
        base = cv2.GaussianBlur(rng.randint(0, 256, (H, W, 3)).astype(
            np.uint8), (9, 9), 0)
        for i in range(FRAMES):
            writer.write(np.roll(base, 2 * i + v, axis=1))
        writer.release()
    (root / 'broken.mp4').write_bytes(b'not a real container')
    (root / 'ann.txt').write_text(''.join(
        f'vid{v}.mp4 {lab}\n' for v, lab in enumerate(LABELS)))
    (root / 'ann_broken.txt').write_text(
        'broken.mp4 0\nvid1.mp4 1\nbroken.mp4 2\nvid2.mp4 3\n')
    (root / 'ann_all_broken.txt').write_text('broken.mp4 0\nbroken.mp4 1\n')
    (root / 'ann_one_column.txt').write_text('vid0.mp4\nvid2.mp4\n')
    return root


@pytest.fixture(params=['jax_default', 'jax_cv2'])
def jax_path(request, monkeypatch):
    """The JAX package as it runs by default (its native FFmpeg worker for
    the accurate decode and the probe, where the library is built), or
    pinned to its cv2 branch."""
    if request.param == 'jax_cv2':
        monkeypatch.setattr(jax_video_io, '_NATIVE_TRIED', True)
        monkeypatch.setattr(jax_video_io, '_NATIVE_DECODER', None)
    return request.param


def pipeline(decoder='PyAVDecode', accurate=False, clips=2,
             crop='ThreeCrop', tail=True):
    dec = dict(type=decoder)
    if decoder == 'PyAVDecode':
        dec['accurate'] = accurate
    ops = [dict(type='SampleFrames', clip_len=T, frame_interval=3,
                num_clips=clips), dec]
    if tail:
        ops += [
            dict(type='Resize', scale=(float('inf'), SIZE), keep_ratio=True),
            dict(type=crop, crop_size=SIZE),
            dict(type='Flip', flip_ratio=0),
            dict(type='Normalize', mean=MEAN, std=STD, to_rgb=True,
                 div_255=False),
            dict(type='FormatShape', input_format='NHWC'),
            dict(type='Collect', keys=['img_group', 'label'], meta_keys=[])]
    return ops


def dataset_cfg(root, ann='ann.txt', **kw):
    num_retries = kw.pop('num_retries', 10)
    return dict(type='VideoDataset', ann_file=str(root / ann),
                data_root=str(root), pipeline=pipeline(**kw),
                test_mode=True, num_retries=num_retries)


@pytest.mark.parametrize('decoder,accurate', DECODERS,
                         ids=[f'{d}-{"accurate" if a else "seek"}'
                              for d, a in DECODERS])
def test_decoders_match_jax(video_root, jax_path, decoder, accurate):
    for tail in (False, True):
        cfg = dataset_cfg(video_root, decoder=decoder, accurate=accurate,
                          tail=tail)
        port, ref = build_dataset(dict(cfg)), jax_dataset(dict(cfg))
        assert dataset_decoder(port) == video_io.DECODERS[accurate]
        for i in range(len(LABELS)):
            got, want = port[i], ref[i]
            assert got['label'] == want['label'] == LABELS[i]
            if tail:
                assert got['img_group'].dtype == np.float32
                assert got['img_group'].shape == (6 * T, SIZE, SIZE, 3)
                np.testing.assert_array_equal(got['img_group'],
                                              want['img_group'])
            else:
                assert len(got['img_group']) == 2 * T
                assert got['total_frames'] == want['total_frames'] == FRAMES
                np.testing.assert_array_equal(got['frame_inds'],
                                              want['frame_inds'])
                for a, b in zip(got['img_group'], want['img_group']):
                    assert a.shape == (H, W, 3)
                    np.testing.assert_array_equal(a, b)


def test_probe_and_an_index_past_the_end(video_root, jax_path):
    """The probe gives the written count; an index past the last frame takes
    the last frame in the accurate decode, and the seek decode's back-off
    lands on it too."""
    path = str(video_root / 'vid1.mp4')
    assert video_io.probe_num_frames(path) == \
        jax_video_io.probe_num_frames(path) == FRAMES
    for bad in (str(video_root / 'broken.mp4'), str(video_root / 'none')):
        with pytest.raises(IOError):
            video_io.probe_num_frames(bad)
    inds = np.array([0, 5, FRAMES - 1, FRAMES + 6, 5])
    accurate = video_io.decode_frames_accurate(path, inds)
    seek = video_io.decode_frames_seek(path, inds)
    for got, want in ((accurate, jax_video_io.decode_frames_accurate(
            path, inds)), (seek, jax_video_io.decode_frames_seek(path, inds))):
        assert len(got) == len(want) == len(inds)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(accurate, seek):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(accurate[3], accurate[2])
    assert video_io.decode_frames_accurate(
        str(video_root / 'broken.mp4'), inds) is None


def _recorded(dataset):
    """``dataset`` with each pipeline call's video index recorded."""
    seen = []
    run = dataset.pipeline

    def pipeline(results):
        seen.append(results['vid_idx'])
        return run(results)
    dataset.pipeline = pipeline
    return dataset, seen


def test_retries_draw_as_jax_does(video_root, jax_path):
    cfg = dataset_cfg(video_root, 'ann_broken.txt')
    (port, got), (ref, want) = (_recorded(build_dataset(dict(cfg))),
                                _recorded(jax_dataset(dict(cfg))))
    for i in range(4):
        a, b = port[i], ref[i]
        np.testing.assert_array_equal(a['img_group'], b['img_group'])
        assert a['label'] == b['label']
    assert got == want
    assert len(got) > 4                 # entries 0 and 2 retried

    cfg = dataset_cfg(video_root, 'ann_all_broken.txt', num_retries=3)
    for ds in (build_dataset(dict(cfg)), jax_dataset(dict(cfg))):
        ds, seen = _recorded(ds)
        with pytest.raises(RuntimeError, match='after 3 retries'):
            ds[1]
        assert len(seen) == 3
    with pytest.raises(RuntimeError):
        build_dataset(dict(cfg, num_retries=0))[0]


def test_one_column_lists(video_root):
    cfg = dataset_cfg(video_root, 'ann_one_column.txt')
    port, ref = build_dataset(dict(cfg)), jax_dataset(dict(cfg))
    assert port.video_infos == ref.video_infos == [
        dict(filename=str(video_root / f'vid{v}.mp4'), label=0)
        for v in (0, 2)]
    np.testing.assert_array_equal(port[1]['img_group'], ref[1]['img_group'])


def test_video_config_loads_as_in_jax(monkeypatch):
    monkeypatch.setenv('MVF_DATA_ROOT', '/videos/')
    port, ref = Config.fromfile(VIDEO_CONFIG), JaxConfig.fromfile(
        VIDEO_CONFIG)
    assert port._cfg_dict == ref._cfg_dict
    assert port.data['test']['type'] == 'VideoDataset'
    assert 'filename_tmpl' not in port.data['test']
    assert port.data['test']['data_root'] == '/videos/k400_val_video'
    assert port.model['module_cfg']['n_segment'] == 4
    assert port.data['test']['pipeline'][1] == dict(type='PyAVDecode',
                                                    accurate=False)


def model_cfg():
    return dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=18, out_indices=(3,),
                      norm_eval=False),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.5, in_channels=512, init_std=0.01,
                      num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(1, 1, 1, 1), mode='THW'),
        fcn_testing=True)


@pytest.fixture(scope='module')
def port_weights():
    port = build_recognizer(dict(model_cfg(), dtype=None),
                            test_cfg=dict(average_clips='prob'))
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    return port.state_dict()


@pytest.mark.parametrize('extract_feat', [False, True],
                         ids=['scores', 'features'])
def test_evaluate_dataset_on_videos_matches_jax(video_root, port_weights,
                                                extract_feat):
    """f64 on both sides. Features on one centre-cropped clip a video: one
    row each, which the JAX package keeps as it should (with more rows it
    keeps the wrong ones; ROADMAP.md, section C)."""
    kw = dict(clips=1, crop='CenterCrop') if extract_feat else {}
    cfg = dataset_cfg(video_root, **kw)
    sd = {k: v.double() if v.is_floating_point() else v
          for k, v in port_weights.items()}
    port = build_recognizer(dict(model_cfg(), dtype=None),
                            test_cfg=dict(average_clips='prob')).double()
    port.load_state_dict(sd, strict=True)
    got = evaluate_dataset(port, build_dataset(dict(cfg)), videos_per_gpu=1,
                           extract_feat=extract_feat, device='cpu')
    jax.config.update('jax_enable_x64', True)
    try:
        jmodel = jax_build(dict(model_cfg(), dtype=None),
                           test_cfg=dict(average_clips='prob'))
        variables = jax_variables_from_state_dict(sd)
        want = jax_evaluate(jmodel, variables, jax_dataset(dict(cfg)),
                            mesh=make_mesh(jax.devices()[:1]),
                            videos_per_gpu=1, extract_feat=extract_feat)
    finally:
        jax.config.update('jax_enable_x64', False)
    assert got.dtype == np.float64
    assert got.shape == want.shape == (
        len(LABELS), 512 if extract_feat else NUM_CLASSES)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)
    if not extract_feat:
        np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-12)


def test_cli_scores_a_video_list(video_root, port_weights, tmp_path):
    """The port's test CLI, in-process on the CPU, on the video list."""
    cfg = model_cfg()
    cfg.pop('fcn_testing')
    text = (f'model = {cfg!r}\n'
            "test_cfg = dict(average_clips='prob')\n"
            f'data = dict(videos_per_gpu=2, workers_per_gpu=2, '
            f'test={dataset_cfg(video_root)!r})\n')
    config = tmp_path / 'video.py'
    config.write_text(re.sub(r'\binf\b', "float('inf')", text))
    ckpt = tmp_path / 'model.pth'
    torch.save({'state_dict': port_weights}, ckpt)
    out = tmp_path / 'scores.pkl'
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = cli.main([str(config), str(ckpt), '--device', 'cpu',
                           '--fcn_testing', '--out', str(out)])
    with open(out, 'rb') as f:
        rows = pickle.load(f)
    assert len(rows) == len(LABELS)
    assert all(r.shape == (NUM_CLASSES,) and np.isfinite(r).all()
               for r in rows)
    np.testing.assert_array_equal(np.stack(rows), result['scores'])
    np.testing.assert_allclose(np.stack(rows).sum(1), 1.0, rtol=1e-5)
    top1, top5 = jmetrics.top_k_accuracy(rows, LABELS, k=(1, 5))
    mca = jmetrics.mean_class_accuracy(rows, LABELS)
    assert re.findall(r'^(?:Top-1|Top-5|Mean Class) Accuracy = (\S+)$',
                      buf.getvalue(), re.M) == [
        f'{v * 100:.02f}' for v in (top1, top5, mca)]
