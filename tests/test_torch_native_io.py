"""The port's native batch JPEG decode worker (``data/native_io.py`` over
``csrc/nvjpeg_decode.cu``) and ``FrameSelector``'s use of it.

On the CPU: the port's ``FrameSelector`` (cv2, the plain version) against
the JAX package's ``FrameSelector(use_native=True)`` (its libjpeg worker,
built from ``native/`` as ``tests/test_native_io.py`` builds it) within
that file's bound; the Python header probe against the JAX worker's
``mvf_jpeg_probe`` on good, corrupt, truncated and missing files; the
backup frame; the refusal of nvJPEG without a card; the build's link flags;
the ``ycc_to_bgr`` kernel's plain version against a line-by-line
transcription of libjpeg-turbo's upsampling loops and colour tables.

On the card (``cuda`` marker; this file imports JAX only inside the CPU
tests, so it runs where only PyTorch is installed):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_native_io.py
"""

import os
import shutil
import subprocess
import threading

import cv2
import numpy as np
import pytest
import torch

from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.data import native_io
from mvfnet_tpu_torch.data.loading import FrameSelector
from mvfnet_tpu_torch.ops import _cuda
from mvfnet_tpu_torch.tools.jpeg_kinds import KINDS, cv2_decode, diff, \
    write_kinds

NATIVE_DIR = os.path.join(os.path.dirname(__file__), '..', 'native')
NATIVE_LIB = os.path.join(NATIVE_DIR, 'build', 'libmvf_native.so')

# nvJPEG (with ycc_to_bgr) against cv2.imdecode on each kind, on the card:
# the mean absolute difference a value, and the largest. The two IDCTs
# round apart by at most 1 a sample (grayscale: max 1), which B = Y +
# 1.772 (Cb - 128) turns into at most 1 + 2; the first card run gave
# max 3 and mean 0.014-0.031 (PERF.md)
NVJPEG_MEAN_ABS = 1.0
NVJPEG_MAX_ABS = 3


@pytest.fixture(scope='module')
def kinds(tmp_path_factory):
    return write_kinds(str(tmp_path_factory.mktemp('kinds')))


@pytest.fixture(scope='module')
def jax_native():
    """The JAX package's libjpeg worker, built as tests/test_native_io.py
    builds it."""
    if not os.path.exists(NATIVE_LIB):
        subprocess.run(['make', '-C', NATIVE_DIR], check=True,
                       capture_output=True)
    from mvfnet_tpu.data import native_io as jax_native_io
    return jax_native_io


def _clip_dir(root, images):
    """``images`` (paths, or bytes for a corrupt frame) as a rawframe
    directory ``img_00001.jpg``...; its FrameSelector results."""
    os.makedirs(root)
    for i, img in enumerate(images):
        dst = os.path.join(root, f'img_{i + 1:05}.jpg')
        if isinstance(img, bytes):
            with open(dst, 'wb') as f:
                f.write(img)
        else:
            shutil.copy(img, dst)
    return dict(filename=root, filename_tmpl='img_{:05}.jpg',
                frame_inds=np.arange(len(images)), modality='RGB')


def _within_jax_bound(a, b):
    """tests/test_native_io.py's bound between the libjpeg worker and cv2:
    at most 1 level, and under 1% of the values differ."""
    d = diff(a, b)
    assert d['max_abs'] <= 1 and d['share_differ'] < 0.01, d


# ------------------------------------------------------------------ CPU

def test_frameselector_cpu_matches_jax_native(kinds, jax_native, tmp_path):
    from mvfnet_tpu.data.loading import FrameSelector as JaxFrameSelector
    same = [p for k, p in kinds.items() if KINDS[k][0][:2] == (256, 455)]
    results = _clip_dir(str(tmp_path / 'clip'), same)
    jax_sel = JaxFrameSelector(use_native=True)
    assert jax_sel._native is not None      # the worker, not its fallback
    got = FrameSelector(use_native=True)(dict(results))
    want = jax_sel(dict(results))
    assert len(got['img_group']) == len(want['img_group']) == len(same)
    for a, b in zip(got['img_group'], want['img_group']):
        _within_jax_bound(a, b)
    # the odd size alone, through both
    odd = _clip_dir(str(tmp_path / 'odd'), [kinds['odd']])
    _within_jax_bound(FrameSelector()(dict(odd))['img_group'][0],
                      jax_sel(dict(odd))['img_group'][0])


def _corrupt_variants(path):
    """Good bytes cut at every offset of the header and a few past it, and
    other damage."""
    data = open(path, 'rb').read()
    sos = data.index(b'\xff\xda')
    cuts = [data[:i] for i in range(0, sos + 16)]
    cuts += [data[:len(data) // 2], data[:-2]]
    other = [b'\xff\xd8\xff\xe0 garbage not a jpeg', b'plain text',
             data[:2] + b'\x00' * 64 + data[2:],       # extraneous bytes
             data[:2] + b'\xff\xff\xff' + data[2:],    # fill bytes
             data[:sos] + data[sos + 2:],              # no SOS marker
             data.replace(b'\xff\xc0', b'\xff\xc3', 1),  # lossless SOF
             data.replace(b'\xff\xc0', b'\xff\xc5', 1)]  # hierarchical SOF
    return cuts + other


def test_probe_matches_jax_worker(kinds, jax_native, tmp_path):
    loader = jax_native.NativeImageLoader()
    cases = list(kinds.values()) + [str(tmp_path / 'missing.jpg')]
    for i, data in enumerate(_corrupt_variants(kinds['yuv420'])
                             + _corrupt_variants(kinds['progressive'])):
        path = str(tmp_path / f'cut_{i}.jpg')
        with open(path, 'wb') as f:
            f.write(data)
        cases.append(path)
    got = [native_io.probe(p) for p in cases]
    want = [loader.probe(p) for p in cases]
    assert got == want
    assert sum(g is None for g in got) > 100 and got[0] == (256, 455, 3)


def test_corrupt_frame_takes_backup_in_both(kinds, jax_native, tmp_path):
    from mvfnet_tpu.data.loading import FrameSelector as JaxFrameSelector
    bad = b'\xff\xd8\xff\xe0 garbage not a jpeg'
    results = _clip_dir(str(tmp_path / 'clip'),
                        [kinds['yuv420'], bad, kinds['yuv444']])
    sel = FrameSelector()
    got = sel(dict(results))['img_group']
    want = JaxFrameSelector(use_native=True)(dict(results))['img_group']
    for a, b in zip(got, want):
        _within_jax_bound(a, b)
    np.testing.assert_array_equal(got[1], got[0])     # the backup frame
    assert sel.counts == {'cv2.imdecode': 3}


def test_nvjpeg_without_a_card_raises(kinds, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(native_io.NvjpegError, match='no CUDA device'):
        native_io.NativeImageLoader('cuda')
    with pytest.raises(native_io.NvjpegError):
        FrameSelector().decode_on('cuda:0')
    with pytest.raises(ValueError, match='cv2.imdecode'):
        native_io.NativeImageLoader('cpu')
    # the dataset builder passes the device on; the CPU keeps cv2
    ann = tmp_path / 'ann.txt'
    _clip_dir(str(tmp_path / 'v0'), [kinds['yuv420']] * 2)
    ann.write_text('v0 2 0\n')
    cfg = dict(type='RawFramesDataset', ann_file=str(ann),
               data_root=str(tmp_path), test_mode=True,
               pipeline=[dict(type='SampleFrames', clip_len=2,
                              frame_interval=1, num_clips=1),
                         dict(type='FrameSelector')])
    with pytest.raises(native_io.NvjpegError):
        build_dataset(dict(cfg), 'cuda')
    dataset = build_dataset(dict(cfg), 'cpu')
    assert dataset.pipeline.transforms[1].decoder == 'cv2.imdecode'
    assert dataset[0]['img_group'][0].shape == (256, 455, 3)
    sel = FrameSelector(use_native=False)
    sel.decode_on('cuda')
    assert sel.decoder == 'cv2.imdecode'


def test_build_links_nvjpeg_and_hashes_flags(monkeypatch, tmp_path):
    nvcc = str(tmp_path / 'cuda' / 'bin' / 'nvcc')
    path, args = _cuda.library_path('nvjpeg_decode', nvcc)
    lib64 = str(tmp_path / 'cuda' / 'lib64')
    assert args[-3:] == [f'-L{lib64}', f'-Xlinker=-rpath={lib64}',
                         '-lnvjpeg']
    assert _cuda.library_path('fused_bottleneck', nvcc)[1] \
        == _cuda.NVCC_FLAGS
    monkeypatch.setattr(_cuda, 'LINK', {'nvjpeg_decode': ('-lnvjpeg',
                                                          '-lculibos')})
    other, _ = _cuda.library_path('nvjpeg_decode', nvcc)
    assert other != path and os.path.dirname(other) == _cuda.BUILD_DIR


def _libjpeg_upsample(p, h, w, hf, vf):
    """libjpeg-turbo's jdsample.c row loops (h2v2_fancy_upsample,
    h2v1_fancy_upsample, h1v2_fancy_upsample, int_upsample), transcribed
    statement by statement, with libjpeg's context rows (the first row
    above the image, the last below it)."""
    ch, cw = p.shape
    p = p.astype(int)
    out = np.zeros((ch * vf, cw * hf), int)

    def row(k):
        return p[min(max(k, 0), ch - 1)]
    if (hf, vf) in ((2, 2), (2, 1)) and cw > 2:
        for k in range(ch):
            for v in range(vf):
                if vf == 2:
                    cs = row(k) * 3 + row(k - 1 if v == 0 else k + 1)
                    o = out[2 * k + v]
                    this, nxt = cs[0], cs[1]
                    o[0] = (this * 4 + 8) >> 4
                    o[1] = (this * 3 + nxt + 7) >> 4
                    last, this = this, nxt
                    for col in range(2, cw):
                        nxt = cs[col]
                        o[2 * col - 2] = (this * 3 + last + 8) >> 4
                        o[2 * col - 1] = (this * 3 + nxt + 7) >> 4
                        last, this = this, nxt
                    o[2 * cw - 2] = (this * 3 + last + 8) >> 4
                    o[2 * cw - 1] = (this * 4 + 7) >> 4
                else:
                    r, o = p[k], out[k]
                    o[0] = r[0]
                    o[1] = (r[0] * 3 + r[1] + 2) >> 2
                    for col in range(1, cw - 1):
                        inv = r[col] * 3
                        o[2 * col] = (inv + r[col - 1] + 1) >> 2
                        o[2 * col + 1] = (inv + r[col + 1] + 2) >> 2
                    o[2 * cw - 2] = (r[cw - 1] * 3 + r[cw - 2] + 1) >> 2
                    o[2 * cw - 1] = r[cw - 1]
    elif (hf, vf) == (1, 2):
        for k in range(ch):
            out[2 * k] = (row(k) * 3 + row(k - 1) + 1) >> 2
            out[2 * k + 1] = (row(k) * 3 + row(k + 1) + 2) >> 2
    else:
        out = np.repeat(np.repeat(p, vf, 0), hf, 1)
    return out[:h, :w]


def _libjpeg_ycc_to_bgr(y, cb, cr):
    """jdcolor.c's build_ycc_rgb_table and ycc_rgb_convert, transcribed."""
    def fix(x):
        return int(x * (1 << 16) + 0.5)
    x = np.arange(256) - 128
    cr_r = (fix(1.40200) * x + (1 << 15)) >> 16
    cb_b = (fix(1.77200) * x + (1 << 15)) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + (1 << 15)
    y = y.astype(int)
    return np.clip(np.stack([y + cb_b[cb], y + ((cb_g[cb] + cr_g[cr]) >> 16),
                             y + cr_r[cr]], -1), 0, 255).astype(np.uint8)


@pytest.mark.parametrize('h,w,hf,vf', [
    (37, 53, 2, 2), (256, 455, 2, 2), (16, 24, 2, 2), (5, 4, 2, 2),
    (6, 3, 2, 2), (37, 53, 2, 1), (9, 5, 2, 1), (37, 53, 1, 2),
    (37, 53, 1, 1), (37, 53, 4, 1), (37, 53, 4, 2)])
def test_ycc_to_bgr_plain_is_libjpegs(h, w, hf, vf):
    rs = np.random.RandomState(h * w + hf * 10 + vf)
    ch, cw = -(-h // vf), -(-w // hf)
    y = rs.randint(0, 256, (h, w)).astype(np.uint8)
    cb, cr = (rs.randint(0, 256, (ch, cw)).astype(np.uint8)
              for _ in range(2))
    got = native_io.ycc_to_bgr(torch.from_numpy(y), torch.from_numpy(cb),
                               torch.from_numpy(cr), hf, vf).numpy()
    want = _libjpeg_ycc_to_bgr(
        y, _libjpeg_upsample(cb, h, w, hf, vf),
        _libjpeg_upsample(cr, h, w, hf, vf))
    np.testing.assert_array_equal(got, want)
    gray = native_io.ycc_to_bgr(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(gray, np.repeat(y[..., None], 3, -1))


# one decode call's worth of frames of every kind: (h, w, hf, vf), hf 0 for
# grayscale; 5 x 4 and 6 x 3 take box upsampling (chroma 2 samples wide)
MIXED = [(256, 455, 2, 2), (37, 53, 2, 2), (37, 53, 2, 1), (37, 53, 1, 2),
         (37, 53, 1, 1), (37, 53, 4, 1), (37, 53, 4, 2), (5, 4, 2, 2),
         (6, 3, 2, 2), (70, 300, 2, 1), (33, 17, 0, 0)]


def _mixed_batch(offset=0):
    """MIXED's frames as ``(y, cb, cr, hf, vf)`` of seeded uint8 planes on
    the CPU; with ``offset``, each plane starts ``offset`` + its index bytes
    into a larger buffer (planes at every alignment)."""
    rs = np.random.RandomState(15)

    def plane(h, w, i):
        start = (offset + i) % 16 if offset else 0
        data = rs.randint(0, 256, h * w + start).astype(np.uint8)
        return torch.from_numpy(data)[start:].view(h, w)
    frames = []
    for i, (h, w, hf, vf) in enumerate(MIXED):
        if hf == 0:
            frames.append((plane(h, w, i), None, None, 1, 1))
        else:
            ch, cw = -(-h // vf), -(-w // hf)
            frames.append((plane(h, w, i), plane(ch, cw, i + 1),
                           plane(ch, cw, i + 2), hf, vf))
    return frames


def test_batch_plain_is_per_frame_and_libjpegs():
    frames = _mixed_batch()
    launches = native_io.ycc_to_bgr.launches
    got = native_io.ycc_to_bgr_batch(frames)
    assert native_io.ycc_to_bgr.launches == launches   # the CPU launches none
    assert len(got) == len(frames)
    for (y, cb, cr, hf, vf), g in zip(frames, got):
        np.testing.assert_array_equal(
            g.numpy(), native_io.ycc_to_bgr_plain(y, cb, cr, hf, vf).numpy())
        if cb is None:
            want = np.repeat(y.numpy()[..., None], 3, -1)
        else:
            h, w = y.shape
            want = _libjpeg_ycc_to_bgr(
                y.numpy(), _libjpeg_upsample(cb.numpy(), h, w, hf, vf),
                _libjpeg_upsample(cr.numpy(), h, w, hf, vf))
        np.testing.assert_array_equal(g.numpy(), want)
    assert native_io.ycc_to_bgr_batch([]) == []


# ----------------------------------------------------------------- card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (chip_smoke.py phase 13 makes the '
                    'same checks on the card)')
    return native_io.NativeImageLoader('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', sorted(KINDS))
def test_nvjpeg_matches_cv2(cuda, kinds, kind):
    got = cuda.load(kinds[kind])
    d = diff(got, cv2_decode(kinds[kind]))
    print(kind, d)
    assert d['mean_abs'] <= NVJPEG_MEAN_ABS and \
        d['max_abs'] <= NVJPEG_MAX_ABS, d


@pytest.mark.cuda
@pytest.mark.parametrize('h,w,hf,vf', [(256, 455, 2, 2), (37, 53, 2, 2),
                                       (37, 53, 2, 1), (37, 53, 1, 2),
                                       (5, 4, 2, 2), (37, 53, 4, 1),
                                       (256, 455, 1, 1)])
def test_ycc_to_bgr_kernel_equals_plain(cuda, h, w, hf, vf):
    rs = np.random.RandomState(h + w + hf + vf)
    ch, cw = -(-h // vf), -(-w // hf)
    planes = [torch.from_numpy(rs.randint(0, 256, s).astype(np.uint8))
              for s in ((h, w), (ch, cw), (ch, cw))]
    before = native_io.ycc_to_bgr.launches
    got = native_io.ycc_to_bgr(*[p.cuda() for p in planes], hf, vf)
    gray = native_io.ycc_to_bgr(planes[0].cuda())
    torch.cuda.synchronize()
    assert native_io.ycc_to_bgr.launches == before + 2
    np.testing.assert_array_equal(
        got.cpu().numpy(), native_io.ycc_to_bgr_plain(*planes, hf, vf).numpy())
    np.testing.assert_array_equal(
        gray.cpu().numpy(), native_io.ycc_to_bgr_plain(planes[0]).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize('offset', [0, 5])
def test_ycc_to_bgr_batch_kernel_equals_plain(cuda, offset):
    frames = _mixed_batch(offset)
    on_card = [tuple(p.cuda() if isinstance(p, torch.Tensor) else p
                     for p in f) for f in frames]
    launches = native_io.ycc_to_bgr.launches
    converted = native_io.ycc_to_bgr.frames
    got = native_io.ycc_to_bgr_batch(on_card)
    torch.cuda.synchronize()
    assert native_io.ycc_to_bgr.launches == launches + 1
    assert native_io.ycc_to_bgr.frames == converted + len(frames)
    for f, g, shape in zip(frames, got, MIXED):
        np.testing.assert_array_equal(
            g.cpu().numpy(), native_io.ycc_to_bgr_plain(*f).numpy(),
            err_msg=str(shape))


@pytest.mark.cuda
def test_decode_call_launches_once(cuda, kinds):
    paths = [kinds[k] for k in sorted(KINDS) if k != 'gray']
    for load, n in ((lambda: cuda.load_batch(paths), len(paths)),
                    (lambda: cuda.load(paths[0]), 1)):
        launches = native_io.ycc_to_bgr.launches
        converted = native_io.ycc_to_bgr.frames
        calls = native_io.NativeImageLoader.decode_calls
        assert load() is not None
        assert native_io.ycc_to_bgr.launches == launches + 1
        assert native_io.ycc_to_bgr.frames == converted + n
        assert native_io.NativeImageLoader.decode_calls == calls + 1


@pytest.mark.cuda
def test_decoded_planes_convert_as_plain(cuda, kinds):
    colour = [kinds[k] for k in sorted(KINDS) if k != 'gray']
    for paths in (colour, [kinds['gray']] * 2):
        frames, planes = cuda.load_batch_planes(paths)
        for frame, (y, cb, cr, hf, vf) in zip(frames, planes):
            want = native_io.ycc_to_bgr_plain(
                *(None if p is None else torch.from_numpy(p)
                  for p in (y, cb, cr)), hf, vf)
            np.testing.assert_array_equal(frame, want.numpy())


@pytest.mark.cuda
def test_nvjpeg_batch_equals_single_decodes(cuda, kinds):
    colour = [kinds[k] for k in sorted(KINDS) if k != 'gray'] * 2
    for paths in (colour, [kinds['gray']] * 3):
        batch = cuda.load_batch(paths)
        assert batch is not None and len(batch) == len(paths)
        for p, b in zip(paths, batch):
            np.testing.assert_array_equal(b, cuda.load(p))
    # grayscale and colour in one batch: refused, then one by one
    assert cuda.load_batch([kinds['gray'], kinds['yuv420']]) is None


@pytest.mark.cuda
def test_nvjpeg_four_threads_at_once(cuda, kinds):
    paths = [kinds['yuv420'], kinds['odd'], kinds['yuv444'],
             kinds['restart']] * 4
    want = [cuda.load(p) for p in paths]
    errors, done = [], []

    def work():
        try:
            for _ in range(5):
                got = cuda.load_batch(paths)
                assert all(np.array_equal(g, w) for g, w in zip(got, want))
            done.append(1)
        except Exception as e:      # noqa: BLE001 (reported below)
            errors.append(e)
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(done) == 4


@pytest.mark.cuda
def test_frameselector_on_cuda(cuda, kinds, tmp_path):
    bad = b'\xff\xd8\xff\xe0 garbage not a jpeg'
    good = _clip_dir(str(tmp_path / 'good'), [kinds['yuv420'],
                                              kinds['yuv444']])
    sel = FrameSelector()
    sel.decode_on('cuda')
    assert sel.decoder == 'nvjpeg'
    got = sel(dict(good))['img_group']
    for img, kind in zip(got, ('yuv420', 'yuv444')):
        np.testing.assert_array_equal(img, cuda.load(kinds[kind]))
    assert sel.counts == {'nvjpeg': 2}
    # a corrupt frame: the batch fails, frames go one by one, the bad one
    # to cv2 (which fails too) and then to the backup frame
    broken = _clip_dir(str(tmp_path / 'broken'), [kinds['yuv420'], bad])
    got = sel(dict(broken))['img_group']
    np.testing.assert_array_equal(got[1], got[0])
    assert sel.counts == {'nvjpeg': 3, 'cv2.imdecode': 1}
