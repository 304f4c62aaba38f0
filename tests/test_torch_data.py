"""Port parity: the host data pipeline, bit for bit.

Every op of the port's ``data`` package runs beside the JAX package's on
the same numpy inputs and the same ``numpy.random.Generator`` seed, and
gives equal arrays of equal dtype: ``SampleFrames``, each transform, the
samplers, ``RawFramesDataset`` and ``PklDataset`` on cv2-written frames
under the flagship config's pipelines (at small sizes), the loader's
batches, and the accuracy metrics. The JAX side decodes with cv2
(``FrameSelector(use_native=False)``).
"""

import copy
import math
import os
import pickle

import cv2
import numpy as np
import pytest

import mvfnet_tpu.data as jdata
import mvfnet_tpu.data.sampler as jsampler
import mvfnet_tpu.utils.metrics as jmetrics
import mvfnet_tpu_torch.data as pdata
import mvfnet_tpu_torch.data.sampler as psampler
import mvfnet_tpu_torch.utils.metrics as pmetrics
from mvfnet_tpu_torch.config import Config

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
FLAGSHIP = os.path.join(REPO, 'configs', 'mvf', 'k400',
                        'mvf_kinetics400_r50_8x8_dense.py')


def assert_same(got, want, path='results'):
    """Equal structure, equal values, equal dtypes; generators skipped."""
    if isinstance(want, np.random.Generator):
        return
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_same(got[k], want[k], f'{path}[{k!r}]')
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f'{path}[{i}]')
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def run_both(name, kwargs, results, seed=0):
    """The named op of each package on a deep copy of ``results``, each
    with a fresh generator from ``seed``."""
    outs = []
    for reg in (jdata.PIPELINES, pdata.PIPELINES):
        res = copy.deepcopy(results)
        res['rng'] = np.random.default_rng(seed)
        outs.append(reg.get(name)(**copy.deepcopy(kwargs))(res))
    return outs


# ------------------------------------------------------------ SampleFrames

@pytest.mark.parametrize('test_mode', [True, False])
@pytest.mark.parametrize('sth_samples', [1, 2, 10, 3])
@pytest.mark.parametrize('total', [5, 64, 300])
def test_sample_frames_match_jax(total, sth_samples, test_mode):
    for clip_len, interval in ((8, 8), (1, 1), (4, 3)):
        for num_clips in (1, 3, 10):
            for jitter in (False, True):
                kw = dict(clip_len=clip_len, frame_interval=interval,
                          num_clips=num_clips, temporal_jitter=jitter,
                          sth_samples=sth_samples)
                res = dict(total_frames=total, test_mode=test_mode)
                outs = []
                for reg in (jdata.PIPELINES, pdata.PIPELINES):
                    r = dict(res, rng=np.random.default_rng(7))
                    try:
                        outs.append(reg.get('SampleFrames')(**kw)(r))
                    except ValueError as e:   # avg_duration <= 0, both
                        outs.append(type(e))
                assert_same(outs[1], outs[0])


def test_sample_frames_without_total_frames_raises(tmp_path):
    """Without ``total_frames`` the container is probed; a file that is no
    container makes the probe raise ``IOError`` and the op return None, so
    that ``VideoDataset`` draws another video, as in the JAX package."""
    from mvfnet_tpu.data import video_io as jax_video_io
    from mvfnet_tpu_torch.data import video_io
    bad = str(tmp_path / 'a.mp4')
    with open(bad, 'wb') as f:
        f.write(b'not a container')
    for probe in (video_io.probe_num_frames,
                  jax_video_io.probe_num_frames):
        with pytest.raises(IOError, match='frame count'):
            probe(bad)
    for reg in (pdata.PIPELINES, jdata.PIPELINES):
        assert reg.get('SampleFrames')(clip_len=2)(
            dict(filename=bad, test_mode=True)) is None


# -------------------------------------------------------------- transforms

def frames(n=4, h=48, w=64, seed=0, gray=False):
    rng = np.random.RandomState(seed)
    shape = (h, w) if gray else (h, w, 3)
    return [rng.randint(0, 256, shape).astype(np.uint8) for _ in range(n)]


def base(imgs, modality='RGB', **extra):
    return dict(img_group=imgs, modality=modality, num_clips=2, clip_len=2,
                **extra)


INF = float('inf')
TRANSFORM_CASES = [
    ('Resize', dict(scale=(INF, 256)), base(frames())),             # up
    ('Resize', dict(scale=(INF, 32)), base(frames())),              # down
    ('Resize', dict(scale=(INF, 48)), base(frames())),              # same
    ('Resize', dict(scale=0.5), base(frames())),
    ('Resize', dict(scale=(40, 30), keep_ratio=False), base(frames())),
    ('Resize', dict(scale=(INF, 32), interpolation='nearest'),
     base(frames())),
    ('CenterCrop', dict(crop_size=32), base(frames())),
    ('CenterCrop', dict(crop_size=(40, 24)), base(frames())),
    ('ThreeCrop', dict(crop_size=48), base(frames())),               # h
    ('ThreeCrop', dict(crop_size=(64, 32)), base(frames())),         # w
    ('ThreeCrop', dict(crop_size=24), base(frames())),               # other
    ('TenCrop', dict(crop_size=32), base(frames())),
    ('TenCrop', dict(crop_size=32), base(frames(gray=True), 'Flow')),
    ('MultiScaleCrop', dict(input_size=32), base(frames())),
    ('MultiScaleCrop', dict(input_size=32, fix_crop=False),
     base(frames())),
    ('MultiScaleCrop', dict(input_size=(32, 24), more_fix_crop=False,
                            max_distort=0), base(frames())),
    ('RandomResizedCrop', dict(input_size=32), base(frames())),
    ('RandomResizedCrop', dict(input_size=32, scale=(0.9, 1.0)),
     base(frames())),
    ('RandomRescaledCrop', dict(input_size=32, scale=(48, 60)),
     base(frames())),
    ('Flip', dict(flip_ratio=0.5), base(frames())),
    ('Flip', dict(flip_ratio=1.0, direction='vertical'), base(frames())),
    ('Flip', dict(flip_ratio=0.5), base(frames(gray=True), 'Flow')),
    ('ColorJitter', dict(), base(frames())),
    ('ColorJitter', dict(color_space_aug=True), base(frames())),
    ('Normalize', dict(mean=[123.675, 116.28, 103.53],
                       std=[58.395, 57.12, 57.375], to_rgb=True),
     base(frames())),
    ('Normalize', dict(mean=[0.5] * 3, std=[0.25] * 3, div_255=True),
     base(frames())),
    ('Normalize', dict(mean=[1.0] * 3, std=[2.0] * 3, to_rgb=True,
                       device=True), base(frames())),
    ('Pad', dict(divisor=32), base(frames())),
    ('Pad', dict(divisor=16), base(frames(gray=True), 'Flow')),
    ('FormatShape', dict(input_format='NHWC'), base(frames())),
    ('FormatShape', dict(input_format='NHWC'),
     base(frames(10, gray=True), 'Flow')),
    ('FormatShape', dict(input_format='NHWC'), base(frames(5), 'RGBDiff')),
    ('FormatShape', dict(input_format='NTHWC'), base(frames())),
    ('FormatShape', dict(input_format='NCHW'), base(frames())),
    ('FormatShape', dict(input_format='NCTHW'), base(frames())),
    ('FormatShape', dict(input_format='NCTHW'),
     dict(base(frames()), clip_len=1, num_clips=4)),
    ('Collect', dict(keys=['img_group', 'label']),
     base(frames(), label=3, ori_shape=(48, 64, 3), img_shape=(48, 64, 3))),
    ('Collect', dict(keys=['img_group'], meta_keys=[]), base(frames())),
    ('ToTensor', dict(keys=['label']), base(frames(), label=3)),
    ('ImageToTensor', dict(keys=['img']), dict(img=frames(1)[0])),
    ('Transpose', dict(keys=['img'], order=(2, 0, 1)),
     dict(img=frames(1)[0])),
]
# the frame and video loaders, held against JAX on files here and in
# tests/test_torch_video.py
LOADERS = {'SampleFrames', 'FrameSelector', 'PklLoader', 'PyAVDecode',
           'DecordDecode', 'OpenCVDecode', 'PIMSDecode'}


def test_every_transform_has_a_case():
    names = set(pdata.PIPELINES._module_dict) - LOADERS
    assert names == {c[0] for c in TRANSFORM_CASES}
    assert names <= set(jdata.PIPELINES.module_dict)


@pytest.mark.parametrize('case', range(len(TRANSFORM_CASES)))
@pytest.mark.parametrize('seed', [0, 1])
def test_transform_matches_jax(case, seed):
    name, kwargs, results = TRANSFORM_CASES[case]
    want, got = run_both(name, kwargs, results, seed)
    assert_same(got, want)


def test_resize_is_bilinear_cv2_at_the_pipeline_scales():
    """The dense test's Resize: short edge 256 from a 455x256 frame is the
    identity scale, from 320x240 an upscale, from 640x480 a downscale."""
    for h, w in ((256, 455), (240, 320), (480, 640)):
        img = frames(1, h, w, seed=h)[0]
        want, got = run_both('Resize', dict(scale=(INF, 256)),
                             base([img]))
        assert_same(got, want)
        assert min(got['img_group'][0].shape[:2]) == 256


# ---------------------------------------------------------------- samplers

SAMPLER_GRID = [
    (n, world, rank, shuffle, seed, epoch, pad)
    for n, world in ((10, 1), (10, 3), (7, 4), (2, 5), (0, 2))
    for rank in sorted({0, world - 1})
    for shuffle in (False, True)
    for seed, epoch in ((0, 0), (3, 1))
    for pad in (True, False)
]


@pytest.mark.parametrize('n,world,rank,shuffle,seed,epoch,pad', SAMPLER_GRID)
def test_sharded_sampler_matches_jax(n, world, rank, shuffle, seed, epoch,
                                     pad):
    samplers = [mod.ShardedSampler(n, world, rank, shuffle=shuffle,
                                   seed=seed, pad=pad)
                for mod in (jsampler, psampler)]
    for s in samplers:
        s.set_epoch(epoch)
    want, got = ([int(i) for i in s] for s in samplers)
    assert got == want
    assert len(samplers[1]) == len(samplers[0])


@pytest.mark.parametrize('world,rank', [(1, 0), (2, 1), (3, 2)])
def test_group_samplers_match_jax(world, rank):
    flags = np.array([0, 1, 1, 0, 1, 1, 1, 0, 1])
    for cls, kw in (('GroupSampler', {}),
                    ('DistributedGroupSampler',
                     dict(world_size=world, rank=rank))):
        samplers = [getattr(mod, cls)(flags, 2, seed=5, **kw)
                    for mod in (jsampler, psampler)]
        for s in samplers:
            s.set_epoch(2)
        assert list(samplers[1]) == list(samplers[0])
        assert len(samplers[1]) == len(samplers[0])


# ---------------------------------------------------------------- datasets

VIDEOS = [('vid_a', 70, 2), ('vid_b', 100, 0), ('vid_c', 9, 1)]


@pytest.fixture(scope='module')
def frame_root(tmp_path_factory):
    """Three rawframe videos of 48x64 JPEGs (1-based names), their .pkl
    packs, and annotation files for both dataset types."""
    root = tmp_path_factory.mktemp('frames')
    rng = np.random.RandomState(0)
    raw, pkl = [], []
    for name, total, label in VIDEOS:
        os.makedirs(root / name)
        packed = []
        for i in range(total):
            img = cv2.GaussianBlur(
                rng.randint(0, 256, (48, 64, 3)).astype(np.uint8), (5, 5), 0)
            cv2.imwrite(str(root / name / f'img_{i + 1:05}.jpg'), img)
            packed.append(cv2.imencode('.jpg', img)[1].tobytes())
        with open(root / f'{name}.pkl', 'wb') as f:
            pickle.dump(packed, f)
        raw.append(f'{name} {total} {label}')
        pkl.append(f'{name}.pkl {total} {label}')
    (root / 'raw.txt').write_text('\n'.join(raw) + '\n\n')
    (root / 'pkl.txt').write_text('\n'.join(pkl) + '\n')
    return root


def small(pipeline):
    """A flagship pipeline at 48x64 frames: crops of 32 (train/val) or 40
    (test), short edge 40, and cv2 decoding on the JAX side."""
    out = []
    for op in pipeline:
        op = dict(op)
        if op['type'] == 'FrameSelector':
            op['use_native'] = False
        if 'input_size' in op:
            op['input_size'] = 32
        if op['type'] == 'CenterCrop':
            op['crop_size'] = 32
        if op['type'] == 'ThreeCrop':
            op['crop_size'] = 40
        if op['type'] == 'Resize':
            op['scale'] = (INF, 40)
        out.append(op)
    return out


def dataset_cfg(root, split, kind='RawFramesDataset'):
    cfg = Config.fromfile(FLAGSHIP)
    ds = dict(cfg.data[split])
    pipeline = small(ds['pipeline'])
    if kind == 'PklDataset':
        pipeline = [dict(type='PklLoader') if op['type'] == 'FrameSelector'
                    else op for op in pipeline]
        ds.pop('filename_tmpl')
    return dict(ds, type=kind, pipeline=pipeline, data_root=str(root),
                ann_file=str(root / ('pkl.txt' if kind == 'PklDataset'
                                     else 'raw.txt')))


@pytest.mark.parametrize('epoch', [0, 1])
@pytest.mark.parametrize('split', ['train', 'val', 'test'])
@pytest.mark.parametrize('kind', ['RawFramesDataset', 'PklDataset'])
def test_dataset_items_match_jax(frame_root, kind, split, epoch):
    cfg = dataset_cfg(frame_root, split, kind)
    jds = jdata.build_dataset(copy.deepcopy(cfg))
    pds = pdata.build_dataset(copy.deepcopy(cfg))
    assert len(pds) == len(jds) == len(VIDEOS)
    assert pds.video_infos == jds.video_infos
    for ds in (jds, pds):
        ds.set_epoch(epoch)
    for i in range(len(VIDEOS)):
        want, got = jds[i], pds[i]
        assert_same(got, want)
    crop = 40 if split == 'test' else 32
    views = 3 * 10 if split == 'test' else 1
    assert got['img_group'].shape == (views * 8, crop, crop, 3)
    assert got['img_group'].dtype == np.float32


def test_repeat_dataset_matches_jax(frame_root):
    cfg = dict(type='RepeatDataset', times=2,
               dataset=dataset_cfg(frame_root, 'train'))
    jds = jdata.build_dataset(copy.deepcopy(cfg))
    pds = pdata.build_dataset(copy.deepcopy(cfg))
    assert len(pds) == len(jds) == 2 * len(VIDEOS)
    for ds in (jds, pds):
        ds.set_epoch(1)
    assert_same(pds[4], jds[4])


def test_corrupt_frame_falls_back_to_backup(frame_root, tmp_path):
    """A truncated JPEG decodes to the first frame loaded, on both sides."""
    bad = tmp_path / 'bad'
    os.makedirs(bad)
    for i in range(4):
        src = frame_root / 'vid_a' / f'img_{i + 1:05}.jpg'
        data = src.read_bytes() if i != 2 else b''
        (bad / f'img_{i + 1:05}.jpg').write_bytes(data)
    res = dict(filename=str(bad), filename_tmpl='img_{:05}.jpg',
               frame_inds=np.arange(4), modality='RGB')
    want, got = run_both('FrameSelector', dict(use_native=False), res)
    assert_same(got, want)
    np.testing.assert_array_equal(got['img_group'][2], got['img_group'][0])
    sel = pdata.PIPELINES.get('FrameSelector')(use_native=True)
    assert sel.decoder == 'cv2.imdecode'


def test_flow_frames_match_jax(tmp_path):
    """Flow: x/y grayscale pairs, 1-based names."""
    rng = np.random.RandomState(1)
    for i in range(6):
        for axis in 'xy':
            cv2.imwrite(str(tmp_path / f'{axis}_{i + 1:05}.jpg'),
                        rng.randint(0, 256, (24, 32)).astype(np.uint8))
    res = dict(filename=str(tmp_path), filename_tmpl='{}_{:05}.jpg',
               frame_inds=np.array([0, 2, 5]), modality='Flow')
    want, got = run_both('FrameSelector', dict(use_native=False), res)
    assert_same(got, want)
    assert len(got['img_group']) == 6


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize('batch_size,drop_last,workers',
                         [(2, False, 2), (2, True, 3), (3, False, 1),
                          (1, False, 4)])
def test_loader_batches_match_jax(frame_root, batch_size, drop_last,
                                  workers):
    cfg = dataset_cfg(frame_root, 'val')
    loaders = []
    for mod in (jdata, pdata):
        ds = mod.build_dataset(copy.deepcopy(cfg))
        loaders.append(mod.DataLoader(
            ds, batch_size, mod.ShardedSampler(len(ds), shuffle=True,
                                               seed=4),
            num_workers=workers, drop_last=drop_last))
    for loader in loaders:
        loader.set_epoch(1)
    want, got = (list(loader) for loader in loaders)
    assert len(got) == len(loaders[1]) == len(loaders[0])
    assert len(got) == (len(VIDEOS) // batch_size if drop_last
                        else math.ceil(len(VIDEOS) / batch_size))
    assert_same(got, want)


def test_build_dataloader_matches_jax(frame_root):
    cfg = dataset_cfg(frame_root, 'val')
    loaders = [mod.build_dataloader(mod.build_dataset(copy.deepcopy(cfg)),
                                    videos_per_gpu=2, workers_per_gpu=2,
                                    dist=True, world_size=2, rank=1,
                                    shuffle=False)
               for mod in (jdata, pdata)]
    want, got = (list(loader) for loader in loaders)
    assert_same(got, want)
    assert loaders[1].drop_last is False


def test_build_dataloader_dist_needs_a_process_group(frame_root):
    ds = pdata.build_dataset(dataset_cfg(frame_root, 'val'))
    with pytest.raises(RuntimeError, match='torch.distributed'):
        pdata.build_dataloader(ds, 1, 1, dist=True)


# ----------------------------------------------------------------- metrics

@pytest.mark.parametrize('ties', [False, True])
def test_metrics_match_jax(ties):
    rng = np.random.RandomState(5)
    scores = rng.rand(40, 7)
    if ties:
        scores = np.round(scores * 3) / 3      # many equal scores per row
    labels = rng.randint(0, 7, 40)
    for k in ((1,), (1, 5), (2, 3, 7)):
        assert pmetrics.top_k_accuracy(list(scores), labels, k) == \
            jmetrics.top_k_accuracy(list(scores), labels, k)
    assert pmetrics.mean_class_accuracy(scores, labels) == \
        jmetrics.mean_class_accuracy(scores, labels)
    np.testing.assert_array_equal(pmetrics.softmax(scores),
                                  jmetrics.softmax(scores))
    fused = [list(scores), list(scores[::-1])]
    assert_same(pmetrics.get_weighted_score(fused, [0.3, 0.7]),
                jmetrics.get_weighted_score(fused, [0.3, 0.7]))


def test_file_client_matches_jax(tmp_path):
    from mvfnet_tpu.utils.file_client import FileClient as JaxClient
    from mvfnet_tpu_torch.utils.file_client import FileClient
    p = tmp_path / 'blob'
    p.write_bytes(b'\x00\x01frames')
    assert FileClient('disk').get(str(p)) == JaxClient('disk').get(str(p))
    with pytest.raises(ValueError, match='not supported'):
        FileClient('nope')
