"""The int8 kernel's host-side logic on the CPU: the plan (variant, padded
Cin, tile width) at every shape the card tests and phase 12 of
``chip_smoke.py`` launch; phase 12's shape list against what the models
launch (derived on the meta device); zero-padding Cin leaves the plain
version's results unchanged; the quantized modules' packed weight gives
what the JAX layout gave; the bound counts only the pixels a strided 1x1
reads. No JAX compile, a few seconds.
"""

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.models import common
from mvfnet_tpu_torch.ops import int8_conv as q8
from mvfnet_tpu_torch.tools import int8_bench
from mvfnet_tpu_torch.tools import test_recognizer as cli
from test_torch_cuda_kernels import INT8_SHAPES

# the plan of each card-test case, in INT8_SHAPES' order
CARD_PLANS = [
    ('tma', 64, 256), ('gather', 256, 64), ('gather', 128, 128),
    ('padded_gather', 16, 64), ('tma', 32, 128), ('padded_tma', 64, 64),
    ('gather', 64, 64), ('gather', 64, 128), ('gather', 32, 64),
    ('tma_taps', 128, 256), ('tma', 64, 256), ('gather', 64, 64),
    ('gather', 512, 128), ('padded_tma', 32, 64), ('padded_tma', 112, 64),
    ('tma_taps', 256, 256), ('tma', 256, 64), ('tma', 64, 128),
    ('tma_taps', 128, 64), ('tma_taps', 256, 128), ('tma_taps', 128, 256),
    ('tma_taps', 128, 128), ('tma_taps', 64, 64), ('tma_taps', 192, 64),
]


@pytest.mark.parametrize('case', range(len(INT8_SHAPES)))
def test_plan_of_each_card_test_shape(case):
    xs, ws, stride, padding, dilation = INT8_SHAPES[case]
    assert tuple(q8.plan(xs, ws[3], ws[:3], stride, padding,
                         dilation)) == CARD_PLANS[case]


def test_card_tests_cover_every_variant_and_tile_width():
    plans = [q8.plan(xs, ws[3], ws[:3], st, pad, dil)
             for xs, ws, st, pad, dil in INT8_SHAPES]
    assert {p.variant for p in plans} == {'tma', 'tma_taps', 'gather',
                                          'padded_tma', 'padded_gather'}
    assert {p.tile_n for p in plans} == set(q8.TILE_WIDTHS)


@pytest.mark.parametrize('key', int8_bench.PHASE12_SHAPES,
                         ids=int8_bench.key_str)
def test_plan_of_each_phase12_shape(key):
    """TMA of x as a matrix exactly where x is the im2col matrix (1x1,
    stride 1, no padding); a tap a box where the conv moves in H and W
    only, Cin is a multiple of 64 and 128 output pixels are whole rows
    or images; Cin padded to the next multiple of 16; the narrowest tile
    that covers Cout (256 above it)."""
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    p = q8.plan((nb, t, h, w, cin), cout, kernel, stride,
                tuple((q, q) for q in pad), dil)
    plain = kernel == (1, 1, 1) and stride == (1, 1, 1) and pad == (0, 0, 0)
    ho = (h + 2 * pad[1] - dil[1] * (kernel[1] - 1) - 1) // stride[1] + 1
    wo = (w + 2 * pad[2] - dil[2] * (kernel[2] - 1) - 1) // stride[2] + 1
    taps = (not plain and kernel[0] == 1 and stride[0] == 1 and
            pad[0] == 0 and cin % 64 == 0 and
            (ho * wo % 128 == 0 and 128 % wo == 0 or 128 % (ho * wo) == 0))
    assert p.variant.replace('padded_', '') == (
        'tma' if plain else 'tma_taps' if taps else 'gather')
    assert p.variant.startswith('padded_') == (cin % 16 != 0)
    assert p.cin % 16 == 0 and cin <= p.cin < cin + 16
    assert p.tile_n == (64 if cout <= 64 else 128 if cout <= 128 else 256)


def test_phase12_shape_list_is_what_the_models_launch():
    """The flagship under phase 12's five cases at 240 frames of 256^2,
    and the shipped I3D and X3D configs' dense tests, on the meta device:
    every launch's key is in PHASE12_SHAPES, and every entry is
    launched."""
    keys = set()

    def record(x, wp, stride, padding, dilation, scale=None, bias=None,
               out_dtype=None):
        keys.add(q8.int8_conv_key(x, q8.unpack_weight(wp), stride, padding,
                                  dilation,
                                  out_dtype if scale is not None else None))
        return real(x, wp, stride, padding, dilation, scale, bias, out_dtype)

    real = q8.int8_conv_packed
    mp = pytest.MonkeyPatch()
    mp.setattr(q8, 'int8_conv_packed', record)
    try:
        cfg = Config.fromfile(chip_smoke.CONFIG)
        runs = [(cfg, over, (1, 240, 256, 256, 3))
                for over in chip_smoke.INT8_CASES.values()]
        for name in ('i3d', 'x3d'):
            c3 = Config.fromfile(chip_smoke.CONFIGS_3D[name])
            sample = [op for op in c3.data['test']['pipeline']
                      if op['type'] == 'SampleFrames'][0]
            runs.append((c3, dict(quant='int8'),
                         (1, sample['num_clips'] * 3, sample['clip_len'],
                          256, 256, 3)))
        for c, over, shape in runs:
            model = cli.build_model(c, True, None, backbone=over).eval()
            with torch.no_grad():
                model.to('meta')(torch.zeros(shape, device='meta'), None,
                                 return_loss=False)
    finally:
        mp.undo()
    assert keys == set(int8_bench.PHASE12_SHAPES)


def _rand_int8(rng, shape):
    return torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8))


@pytest.mark.parametrize('xs,ws,stride,pad', [
    ((2, 1, 19, 17, 3), (1, 7, 7, 64), (1, 2, 2), (0, 3, 3)),
    ((2, 3, 6, 6, 24), (1, 1, 1, 54), (1, 1, 1), (0, 0, 0)),
    ((2, 3, 6, 6, 54), (1, 1, 1, 24), (1, 1, 1), (0, 0, 0)),
    ((1, 2, 7, 7, 108), (1, 1, 1, 48), (1, 1, 1), (0, 0, 0)),
    ((2, 2, 8, 8, 24), (1, 1, 1, 48), (1, 2, 2), (0, 0, 0)),
])
def test_channel_padding_leaves_the_results_unchanged(xs, ws, stride, pad):
    """Zero channels added to x and w, as the wrapper adds them for the
    kernel, leave the int32 sums and both epilogues bit for bit."""
    rng = np.random.RandomState(sum(xs))
    x = _rand_int8(rng, xs)
    w = _rand_int8(rng, ws[:3] + (xs[-1], ws[3]))
    scale = torch.from_numpy(rng.rand(ws[3]).astype(np.float32) * 1e-3)
    bias = torch.from_numpy(rng.randn(ws[3]).astype(np.float32))
    cin16 = q8.plan(xs, ws[3], ws[:3], stride, tuple((p, p) for p in pad),
                    (1, 1, 1)).cin
    assert cin16 > xs[-1]
    xp = torch.nn.functional.pad(x, (0, cin16 - xs[-1]))
    wp = q8.unpack_weight(torch.nn.functional.pad(q8.pack_weight(w),
                                                  (0, cin16 - xs[-1])))
    padding = tuple((p, p) for p in pad)
    for sc, bi, dt in ((None, None, None), (scale, bias, torch.bfloat16),
                       (scale, None, torch.float32)):
        want = q8.int8_conv_plain(x, w, stride, padding, (1, 1, 1), sc, bi,
                                  dt)
        got = q8.int8_conv_plain(xp, wp, stride, padding, (1, 1, 1), sc, bi,
                                 dt)
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_packed_weight_is_the_jax_layout_permuted():
    """``_packed`` (the modules' one copy of the quantized weight) is the
    kernel's layout of the JAX layout they handed over before, for 2-D
    and 3-D weights, contiguous; the packed dispatch on the CPU equals
    ``int8_conv`` on the JAX layout."""
    rng = np.random.RandomState(0)
    w2 = _rand_int8(rng, (32, 16, 3, 3))          # O I kh kw
    w3 = _rand_int8(rng, (32, 16, 3, 1, 3))       # O I kt kh kw
    for wq, jax_layout in ((w2, w2.permute(2, 3, 1, 0)[None]),
                           (w3, w3.permute(2, 3, 4, 1, 0))):
        wp = common._packed(wq)
        assert wp.is_contiguous() and wp.ndim == 5
        assert torch.equal(wp, q8.pack_weight(jax_layout))
        assert torch.equal(q8.unpack_weight(wp), jax_layout)
    x = _rand_int8(rng, (2, 4, 6, 6, 16))
    args = ((1, 1, 2), ((1, 1), (0, 0), (1, 1)), (1, 1, 1))
    scale = torch.full((32,), 1e-3)
    assert torch.equal(
        q8.int8_conv_packed(x, common._packed(w3), *args, scale, None,
                            torch.float32),
        q8.int8_conv(x, w3.permute(2, 3, 4, 1, 0), *args, scale, None,
                     torch.float32))


@pytest.mark.parametrize('kind', ['conv2d', 'split', 'conv3d'])
def test_quant_modules_hand_over_the_packed_weight(kind, monkeypatch):
    """Each quantized module calls the packed entry with a contiguous
    ``(Cout, kt, kh, kw, Cin)`` weight, and its output equals the same
    convs through the plain version on the JAX layout."""
    torch.manual_seed(0)
    if kind == 'conv3d':
        m = common.QuantConv3d(8, 24, (3, 1, 3), padding=(1, 0, 1))
        x = torch.randn(2, 8, 4, 5, 5)
    else:
        m = common.QuantConv2d(16, 24, 1 if kind == 'split' else 3,
                               padding=0 if kind == 'split' else 1,
                               split=4 if kind == 'split' else 0)
        x = torch.randn(2, 16, 6, 6)
    seen = []
    real = q8.int8_conv_packed

    def spy(x8, wp, *args, **kw):
        seen.append(wp)
        return real(x8, wp, *args, **kw)

    monkeypatch.setattr(q8, 'int8_conv_packed', spy)
    got = m.eval()(x)
    assert seen and all(wp.is_contiguous() and wp.ndim == 5 and
                        wp.shape[0] == 24 for wp in seen)

    def by_jax_layout(x8, wp, *args, **kw):
        return q8.int8_conv(x8, q8.unpack_weight(wp).contiguous(), *args,
                            **kw)

    monkeypatch.setattr(q8, 'int8_conv_packed', by_jax_layout)
    assert torch.equal(got, m(x))


@pytest.mark.parametrize('cin,kernel,stride,padding,out,box', [
    (128, (1, 3, 3), (1, 1, 1), (0, 1, 1), (1, 32, 32), (4, 1)),
    (256, (1, 3, 3), (1, 2, 2), (0, 1, 1), (1, 8, 8), (8, 2)),
    (512, (1, 1, 1), (1, 2, 2), (0, 0, 0), (1, 4, 4), (4, 8)),
    (128, (1, 3, 3), (1, 1, 1), (0, 1, 1), (1, 12, 12), None),
    (64, (1, 3, 3), (1, 1, 1), (0, 1, 1), (1, 64, 64), (2, 1)),
    (96, (1, 3, 3), (1, 1, 1), (0, 1, 1), (1, 32, 32), None),
    (128, (3, 3, 3), (1, 1, 1), (1, 1, 1), (4, 8, 8), None),
    (128, (1, 3, 3), (2, 1, 1), (0, 1, 1), (2, 8, 8), None),
    (128, (1, 1, 3), (1, 1, 1), (0, 0, 1), (1, 1, 512), None),
])
def test_taps_box(cin, kernel, stride, padding, out, box):
    """``(rows, images)`` where 128 output pixels are whole rows or whole
    images of a conv that moves in H and W only with Cin % 64 == 0, and
    the box spans at most 256 elements along an axis; else None."""
    assert q8.taps_box(cin, kernel, stride, tuple((p, p) for p in padding),
                       out) == box


def test_bound_counts_the_pixels_a_strided_pointwise_conv_reads():
    key = (240, 1, 64, 64, 256, 512, (1, 1, 1), (1, 2, 2), (0, 0, 0),
           (1, 1, 1), 'bfloat16')
    _, _, ops, nbytes = int8_bench.bound(key)
    m = 240 * 32 * 32
    assert ops == 2 * m * 256 * 512
    assert nbytes == m * 256 + 256 * 512 + m * 512 * 2 + 4 * 512
    key3 = (240, 1, 64, 64, 128, 128, (1, 3, 3), (1, 2, 2), (0, 1, 1),
            (1, 1, 1), 'int32')
    _, _, _, nbytes3 = int8_bench.bound(key3)
    assert nbytes3 == 240 * 64 * 64 * 128 + 9 * 128 * 128 + m * 128 * 4
    counts = collections.Counter(k[-1] for k in int8_bench.PHASE12_SHAPES)
    assert sum(counts.values()) == len(int8_bench.PHASE12_SHAPES) == 54
