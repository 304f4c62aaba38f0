"""Port parity: the int8 eval path against the JAX package.

Each quant module of the port (``QuantConv2d`` with stride, padding,
dilation, bias, ``carry_out`` and an ``IntCarry`` input; ``QuantConv3d``
per conv type; the MVF block's split conv1; the stem in bf16) takes the
same float32 input and weights as the JAX module: the int8 activations,
the int8 weights and the int32 accumulators each conv computes are equal
(both packages' convs are recorded: ``jax.lax.conv_general_dilated`` and
``ops.int8_conv.int8_conv``), and the outputs agree within rtol 1e-6.

Whole models in f64 (rtol 1e-6 / atol 1e-8): the MVFNet-R50 cut to two
stages (MVF in the first) calibrated under ``int8_static`` with
``quant_carry`` (the carry runs in layer2) and ``quant_stem``, the
calibration state equal to JAX's; ResNet-18's basic blocks under
``int8`` with a ``quant_stages`` mask; I3D
(``spatial``) and X3D (``pointwise`` under ``int8`` and calibrated
``int8_static``, its first stage left unquantized by ``s2d_stages``); MVF
in a later quantized stage, calibrated on smooth frames and scored on
noise. Where a round-half boundary flips an int8 value between
the two packages the test reports the count and holds the model to the
JAX package's own bound instead, rms < 2% of the reference
(``tests/test_quant_int8.py``).

And the JAX package's contracts on the port: the unquantized model's
``state_dict`` keys, a drift under 5%, the calibration guard, the train
refusal, the ``quant_stages`` length check, unknown modes, the
golden-weights margin test; the test CLI's ``--calib_videos`` against the
root CLI's loop, and a calibrated ``.msgpack`` both ways.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.models import common as jax_common
from mvfnet_tpu.models.backbones import resnet as jax_resnet
from mvfnet_tpu.utils.checkpoint import (import_torch_weights,
                                         load_torch_state_dict)
from mvfnet_tpu.utils.checkpoint import load_checkpoint as jax_load
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu_torch.models import build_backbone, build_recognizer
from mvfnet_tpu_torch.models import common
from mvfnet_tpu_torch.ops import int8_conv as q8
from mvfnet_tpu_torch.tools import test_recognizer as cli
from mvfnet_tpu_torch.utils.checkpoint import (is_quant_stat,
                                               jax_variables_from_state_dict,
                                               load_weights,
                                               save_msgpack_checkpoint,
                                               state_dict_from_jax)
from test_models import r50_mvf_cfg
from test_torch_eval import dataset_cfg, setup  # noqa: F401
from test_torch_i3d import i3d_backbone, jax_shapes, one_thread, tree_shapes
from test_torch_slowfast_x3d import x3d_backbone

T, B, HW, NUM_CLASSES = 4, 2, 32, 5
RTOL, ATOL = 1e-6, 1e-8


@pytest.fixture
def f64():
    jax.config.update('jax_enable_x64', True)
    with one_thread():
        yield
    jax.config.update('jax_enable_x64', False)


class Recorder:
    """Every int8 conv of both packages: (x, w, int32 acc) in the kernel's
    layouts, NTHWC / THWIO (a 2-D conv with T = kt = 1)."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        real_jax = jax.lax.conv_general_dilated

        def record(*arrays):
            x, w, acc = (np.asarray(a) for a in arrays)
            if x.ndim == 4:
                x, w, acc = x[:, None], w[None], acc[:, None]
            self.jax.append((x, w, acc))

        def jax_conv(lhs, rhs, *args, **kwargs):
            out = real_jax(lhs, rhs, *args, **kwargs)
            if kwargs.get('preferred_element_type') == jnp.int32:
                # also from inside jit
                jax.debug.callback(record, lhs, rhs, out, ordered=True)
            return out

        real_port = q8.int8_conv

        def port_conv(x, w, stride, padding, dilation, *rest, **kw):
            acc = q8.int8_conv_plain(x, w, stride, padding, dilation)
            self.port.append(tuple(a.numpy() for a in (x, w, acc)))
            return real_port(x, w, stride, padding, dilation, *rest, **kw)

        monkeypatch.setattr(jax.lax, 'conv_general_dilated', jax_conv)
        monkeypatch.setattr(q8, 'int8_conv', port_conv)

    def clear(self):
        self.jax.clear()
        self.port.clear()

    def flips(self) -> int:
        """int8 activations that differ between the packages, all convs."""
        assert len(self.jax) == len(self.port)
        return sum(int((j[0] != p[0]).sum()) for j, p in
                   zip(self.jax, self.port) if j[0].shape == p[0].shape)

    def assert_equal(self, skip: int = 0):
        """Equal int8 operands and accumulators, after ``skip`` convs (the
        stem's space-to-depth form: ``test_stem_in_bf16_matches_jax``)."""
        assert len(self.jax) == len(self.port) > 0
        for j, p in list(zip(self.jax, self.port))[skip:]:
            for a, b in zip(j, p):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.fixture
def rec(monkeypatch):
    return Recorder(monkeypatch)


def _rand(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


# name: (cin, cout, kernel, stride, padding, dilation, bias, carry_out)
CONV2D = {
    'pointwise': (16, 32, 1, 1, 0, 1, False, False),
    'strided_3x3_bias': (16, 24, 3, 2, 1, 1, True, False),
    'dilated_3x3': (8, 16, 3, 1, 2, 2, False, False),
    'carry_out': (16, 32, 3, 1, 1, 1, False, True),
}


@pytest.mark.parametrize('name', sorted(CONV2D))
def test_quant_conv2d_matches_jax(name, rec):
    cin, cout, k, s, p, d, bias, carry = CONV2D[name]
    x = _rand(0, 2, 9, 11, cin, scale=2.0)
    kernel = _rand(1, k, k, cin, cout, scale=0.2)
    params = {'kernel': kernel}
    if bias:
        params['bias'] = _rand(2, cout)
    jmod = jax_common.QuantConv2d(
        features=cout, kernel_size=(k, k), strides=(s, s),
        padding=((p, p), (p, p)), dilation=d, use_bias=bias,
        carry_out=carry)
    want = jmod.apply({'params': params}, jnp.asarray(x))
    port = common.conv2d(cin, cout, k, stride=s, padding=p, dilation=d,
                         bias=bias, quant='int8', carry_out=carry)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        if bias:
            port.bias.copy_(torch.from_numpy(params['bias']))
        got = port(_nchw(x))
    rec.assert_equal()
    if carry:
        assert isinstance(got, common.IntCarry)
        np.testing.assert_array_equal(got.acc.numpy(), np.asarray(want.acc))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=RTOL)
    else:
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=RTOL, atol=1e-7)


def test_integer_carry_input_matches_jax(rec):
    """A static conv fed an ``IntCarry`` and the previous BN's affine:
    the requantized int8 input (ReLU in the clip) and its product."""
    acc = np.random.RandomState(3).randint(-40000, 40000, (2, 6, 6, 16),
                                           dtype=np.int32)
    scale = np.abs(_rand(4, 16)) * 1e-4
    a, b = np.abs(_rand(5, 16)) + 0.5, _rand(6, 16) * 0.1
    kernel = _rand(7, 3, 3, 16, 8, scale=0.2)
    amax = np.float32(3.5)
    jmod = jax_common.QuantConv2d(features=8, kernel_size=(3, 3),
                                  padding=((1, 1), (1, 1)), static=True)
    want = jmod.apply(
        {'params': {'kernel': kernel},
         'quant_stats': {'act_amax': amax, 'act_amax_calibrated': 1.0}},
        jax_common.IntCarry(jnp.asarray(acc), jnp.asarray(scale)),
        prev_affine=(jnp.asarray(a), jnp.asarray(b)))
    port = common.conv2d(16, 8, 3, padding=1, quant='int8_static')
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        port.act_amax.fill_(float(amax))
        got = port(common.IntCarry(torch.from_numpy(acc),
                                   torch.from_numpy(scale), torch.float32),
                   prev_affine=(torch.from_numpy(a), torch.from_numpy(b)))
    rec.assert_equal()
    assert rec.port[0][0].min() >= 0
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-7)


# name: (kernel, stride)
CONV3D = {'temporal': ((3, 1, 1), (2, 1, 1)),
          'spatial': ((1, 3, 3), (1, 2, 2)),
          'pointwise': ((1, 1, 1), (1, 1, 1)),
          'full': ((3, 3, 3), (1, 1, 1))}


@pytest.mark.parametrize('name', sorted(CONV3D))
def test_quant_conv3d_matches_jax(name, rec):
    kernel_size, stride = CONV3D[name]
    assert common.quant_conv3d_type(kernel_size) == \
        jax_common.quant_conv3d_type(kernel_size) == \
        (name if name != 'full' else 'temporal')
    pad = tuple((k - 1) // 2 for k in kernel_size)
    x = _rand(8, 2, 6, 7, 7, 16, scale=2.0)
    kernel = _rand(9, *kernel_size, 16, 24, scale=0.2)
    bias = _rand(10, 24)
    jmod = jax_common.QuantConv3d(features=24, kernel_size=kernel_size,
                                  strides=stride,
                                  padding=tuple((q, q) for q in pad),
                                  use_bias=True)
    want = jmod.apply({'params': {'kernel': kernel, 'bias': bias}},
                      jnp.asarray(x))
    port = common.conv3d(16, 24, kernel_size, stride=stride, bias=True,
                         quant='int8')
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(4, 3, 0, 1, 2)))
        port.bias.copy_(torch.from_numpy(bias))
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    rec.assert_equal()
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize('quant', ['int8', 'int8_static'])
def test_split_conv1_matches_jax(quant, rec):
    """The MVF block's conv1: the first ``split`` channels and the rest
    with their own activation scales, one weight scale; calibrated stats
    equal JAX's."""
    y = _rand(11, 2, 8, 8, 8, scale=3.0)
    rest = _rand(12, 2, 8, 8, 24)
    kernel = _rand(13, 1, 1, 32, 20, scale=0.2)
    jmod = jax_resnet._SplitPointwiseConv(features=20, split=8,
                                          in_channels=32, stride=2,
                                          quant=quant)
    variables = {'params': {'kernel': kernel}}
    port = common.conv2d(32, 20, 1, stride=2, quant=quant, split=8)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
    x = _nchw(np.concatenate([y, rest], -1))
    if quant == 'int8_static':
        _, mut = jmod.apply(variables, jnp.asarray(y), jnp.asarray(rest),
                            mutable=['quant_stats'])
        variables.update(mut)
        with torch.no_grad(), common.quant_calibration(port):
            port(x)
        for k, v in mut['quant_stats'].items():
            assert float(getattr(port, k)) == float(v)
        assert sorted(mut['quant_stats']) == sorted(
            common.quant_buffers(port))
        rec.clear()
    want = jmod.apply(variables, jnp.asarray(y), jnp.asarray(rest))
    with torch.no_grad():
        got = port(x)
    rec.assert_equal()
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=RTOL, atol=1e-7)


def _space_to_depth(x, k):
    """The JAX stem's re-layout of the port's int8 input and weights."""
    xp = np.pad(x, [(0, 0), (4, 4), (4, 4), (0, 0)])
    n, hp, wp, c = xp.shape
    xp = xp.reshape(n, hp // 2, 2, wp // 2, 2, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(n, hp // 2, wp // 2, 4 * c)
    kp = np.pad(k, [(1, 0), (1, 0), (0, 0), (0, 0)])
    f = k.shape[-1]
    kp = kp.reshape(4, 2, 4, 2, c, f).transpose(0, 2, 1, 3, 4, 5).reshape(
        4, 4, 4 * c, f)
    return xp, kp


def test_stem_in_bf16_matches_jax(rec):
    """The quantized stem quantizes its weight after the cast to bf16; the
    JAX space-to-depth form and the port's direct 7x7/s2 conv see the same
    int8 values and sum the same products."""
    x = _rand(14, 2, 32, 32, 3, scale=2.0)
    kernel = _rand(15, 7, 7, 3, 16, scale=0.1)
    jmod = jax_resnet._SpaceToDepthStem(features=16, quant='int8',
                                        dtype=jnp.bfloat16)
    want = jmod.apply({'params': {'kernel': kernel}}, jnp.asarray(x))
    port = common.QuantConv2d(3, 16, 7, stride=2, padding=3, bias=False,
                              quant='int8', stem=True)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        got = port(_nchw(x).to(torch.bfloat16))
    (jx, jw, jacc), (px, pw, pacc) = rec.jax[0], rec.port[0]
    sx, sw = _space_to_depth(px[:, 0], pw[0])
    np.testing.assert_array_equal(sx, jx[:, 0])
    np.testing.assert_array_equal(sw, jw[0])
    np.testing.assert_array_equal(pacc, jacc[:, :, :16, :16])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.permute(0, 2, 3, 1).float().numpy(),
        np.asarray(want.astype(jnp.float32)))


def r50_cfg(quant, **backbone):
    return dict(
        type='Recognizer2D',
        backbone=dict(dict(type='ResNet', depth=50, num_stages=2,
                           out_indices=(1,), norm_eval=False, quant=quant),
                      **backbone),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.0, in_channels=512, init_std=0.01,
                      num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(1, 0, 0, 0), mode='THW'),
        fcn_testing=True, dtype=None)


def _recognizer_3d(backbone, in_channels):
    return dict(type='Recognizer3D', backbone=backbone,
                cls_head=dict(type='I3DClsHead', dropout_ratio=0.0,
                              in_channels=in_channels,
                              num_classes=NUM_CLASSES, init_std=0.01),
                dtype=None)


# name: (model config, input (B, S, ...) without the batch, calibrate)
MODELS = {
    'r50_static_carry_stem': (r50_cfg('int8_static', quant_carry=True,
                                      quant_stem=True),
                              (T, HW, HW, 3), True),
    'r18_int8_mask': (dict(r50_cfg('int8', depth=18, quant_stages=(1, 0)),
                           cls_head=dict(r50_cfg(None)['cls_head'],
                                         in_channels=128)),
                      (T, HW, HW, 3), False),
    'i3d_spatial': (_recognizer_3d(i3d_backbone(
        num_stages=2, out_indices=(1,), quant='int8_static'), 512),
        (1, 8, HW, HW, 3), True),
    'x3d_pointwise': (_recognizer_3d(x3d_backbone(
        depth=1, ratio_width=0.5, num_stages=2, out_indices=(1,),
        quant='int8', s2d_stages=(0,)), 2048), (1, 4, HW, HW, 3), False),
    'x3d_pointwise_static': (_recognizer_3d(x3d_backbone(
        depth=1, ratio_width=0.5, num_stages=2, out_indices=(1,),
        quant='int8_static', s2d_stages=(0,)), 2048), (1, 4, HW, HW, 3),
        True),
}


@pytest.mark.parametrize('name', sorted(MODELS))
def test_model_matches_jax(name, f64, monkeypatch):
    """The JAX model under ``jit``, as its CLIs run it. XLA computes the
    abs-max's ``/ 127`` there as a product with the reciprocal, one ulp
    off the division the JAX source and the port compute (the JAX
    modules applied op by op equal the port exactly, as the tests above
    hold them); the int8 values that this flips are counted."""
    cfg, shape, calibrate = MODELS[name]
    x = np.random.RandomState(1).randn(B, *shape) * 0.5
    got, want, rec, _ = _port_and_jax(name, cfg, shape,
                                      x if calibrate else None, x,
                                      monkeypatch)
    _hold_to_jax(name, cfg, got, want, rec)


def _port_and_jax(name, cfg, shape, calib, x, monkeypatch):
    """The port's and the JAX model's logits on ``x`` (the port's model
    with them), both calibrated on ``calib`` unless it is None, the
    port given JAX's calibrated scales; the recorder of the scoring
    pass."""
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None)).double()
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    port.eval()
    shapes = jax_shapes(cfg, (1,) + shape)
    variables = jax_variables_from_state_dict(port.state_dict())
    variables = {k: variables[k] for k in shapes if k != 'quant_stats'}
    if name.startswith('x3d'):
        # the JAX X3D's space-to-depth stages compute in the module dtype,
        # float32 when it is None
        cfg = dict(cfg, dtype='float64')
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    rec = Recorder(monkeypatch)
    if calib is not None:
        _, mut = jax.jit(lambda v, x: jmodel.apply(
            v, x, None, return_loss=False, mutable=['quant_stats']))(
                variables, jnp.asarray(calib))
        variables.update(mut)
        with torch.no_grad(), port.calibrate():
            port(torch.from_numpy(calib), None, return_loss=False)
        got_stats = common.quant_buffers(port)
        want_stats = {k: v for k, v in state_dict_from_jax(
            {'params': variables['params'],
             'quant_stats': mut['quant_stats']}).items()
            if is_quant_stat(k)}
        assert set(want_stats) == set(got_stats)
        for k, v in want_stats.items():     # within rounding flips
            np.testing.assert_allclose(got_stats[k].numpy(), v.numpy(),
                                       rtol=2e-2)
        # the JAX scales: the flips of the calibration pass stay out of
        # the comparison below
        with torch.no_grad():
            for k, v in want_stats.items():
                got_stats[k].copy_(v)
    keys = [k for k in shapes if k in variables]
    assert tree_shapes({k: variables[k] for k in keys}) == \
        tree_shapes({k: shapes[k] for k in keys})
    rec.clear()
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, None, return_loss=False))(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.dtype == np.float64 and got.shape == (B, NUM_CLASSES)
    return got, want, rec, port


def _hold_to_jax(name, cfg, got, want, rec):
    """Equal int8 operands and logits within rtol 1e-6 / atol 1e-8; or,
    where a round-half boundary flipped int8 values, the count of them
    and JAX's own bound, rms < 2% of the reference."""
    if np.allclose(got, want, rtol=RTOL, atol=ATOL):
        rec.assert_equal(skip=int(cfg['backbone'].get('quant_stem', 0)))
        return
    flips = rec.flips()
    print(f'{name}: {flips} int8 values flipped at a round-half boundary')
    assert flips > 0
    rms = np.sqrt(((got - want) ** 2).mean())
    assert rms < 0.02 * np.sqrt((want ** 2).mean())


def _smooth_frames(seed, b, t, hw):
    """Frames of coarse random fields upsampled bilinearly, in the range
    of normalized video frames: the content a calibration sees."""
    coarse = torch.from_numpy(np.random.RandomState(seed).rand(
        b * t, 3, 4, 4) * 4 - 2)
    up = torch.nn.functional.interpolate(coarse, size=(hw, hw),
                                         mode='bilinear', align_corners=False)
    return up.permute(0, 2, 3, 1).reshape(b, t, hw, hw, 3).numpy()


def test_noise_after_smooth_calibration_drifts_as_jax_does(f64, monkeypatch):
    """MVF in a later quantized stage (layer2 of the cut R50 at
    ``quant_stages`` (1, 1)) calibrated on smooth frames, then scored on
    white noise, whose activations the calibrated scales clip: the port
    follows JAX there as on the calibration's own input, so its drift from
    the unquantized model is the reference's own. Both drifts print."""
    name = 'r50_static_mvf_layer2_noise'
    cfg = r50_cfg('int8_static', quant_stages=(1, 1))
    cfg['module_cfg'] = dict(cfg['module_cfg'], mvf_freq=(0, 1, 0, 0))
    shape = (T, HW, HW, 3)
    calib = _smooth_frames(3, B, T, HW)
    x = np.random.RandomState(4).randn(B, *shape)
    got, want, rec, port = _port_and_jax(name, cfg, shape, calib, x,
                                         monkeypatch)
    _hold_to_jax(name, cfg, got, want, rec)
    plain = build_recognizer(                # the same weights, unquantized
        dict(cfg, backbone=dict(cfg['backbone'], quant=None)),
        test_cfg=dict(average_clips=None)).double().eval()
    plain.load_state_dict(port.state_dict(), strict=True)
    with torch.no_grad():
        ref = plain(torch.from_numpy(x), None, return_loss=False).numpy()
    drift = {k: float(np.sqrt(((v - ref) ** 2).mean() / (ref ** 2).mean()))
             for k, v in (('port', got), ('jax', want))}
    print(f'{name}: rms drift from the unquantized model {drift}')
    assert drift['jax'] > 0
    assert abs(drift['port'] - drift['jax']) <= 0.02 * drift['jax']


def test_carry_differs_from_unfused_within_lsb_noise():
    """In bf16 the integer carry moves rounding points only (its fold runs
    in f32 where the unfused form rounds to bf16): within 2% rms of the
    unfused form, and not equal to it (the carry path ran)."""
    x = torch.from_numpy(np.random.RandomState(2).randn(B, T, HW, HW, 3)
                         .astype(np.float32))
    out = {}
    for carry in (False, True):
        port = build_recognizer(dict(r50_cfg('int8_static',
                                             quant_carry=carry),
                                     dtype='bfloat16'),
                                test_cfg=dict(average_clips=None))
        port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
        port.eval()
        with torch.no_grad():
            with port.calibrate():
                port(x, None, return_loss=False)
            out[carry] = port(x, None, return_loss=False).float().numpy()
    diff = np.sqrt(((out[True] - out[False]) ** 2).mean())
    assert 0 < diff < 0.02 * np.sqrt((out[False] ** 2).mean())


def test_same_state_dict_keys_and_bounded_drift():
    port0 = build_recognizer(r50_cfg(None), test_cfg=dict(
        average_clips=None)).eval()
    port8 = build_recognizer(r50_cfg('int8'), test_cfg=dict(
        average_clips=None)).eval()
    port0.init_weights(torch.Generator().manual_seed(0))
    assert list(port0.state_dict()) == list(port8.state_dict())
    port8.load_state_dict(port0.state_dict(), strict=True)
    assert common.quant_buffers(port8) and not common.quant_buffers(port0)
    x = torch.from_numpy(np.random.RandomState(1).randn(B, T, HW, HW, 3)
                         .astype(np.float32) * 2)
    with torch.no_grad():
        s0 = port0(x, None, return_loss=False).numpy()
        s8 = port8(x, None, return_loss=False).numpy()
    rms = np.sqrt(((s0 - s8) ** 2).mean())
    assert 0 < rms < 0.05 * np.sqrt((s0 ** 2).mean())


def test_calibration_guard():
    ms = build_recognizer(r50_cfg('int8_static'), test_cfg=dict(
        average_clips=None)).eval()
    with pytest.raises(ValueError, match='calibrated'):
        common.check_quant_calibrated(ms)
    x = torch.zeros(1, T, HW, HW, 3)
    with torch.no_grad(), ms.calibrate():
        ms(x, None, return_loss=False)
    common.check_quant_calibrated(ms)
    assert not any(m.calibrating for m in common.quant_modules(ms))
    for quant in (None, 'int8'):
        common.check_quant_calibrated(build_recognizer(r50_cfg(quant)))


def test_calibration_guard_skips_x3d_s2d_stages():
    """An X3D stage that JAX runs in space-to-depth form is unquantized and
    keeps no calibration state: calibrating the other int8 convs satisfies
    the guard. An input too small for that form would quantize the stage,
    and ``int8_static`` refuses it."""
    cfg, shape, _ = MODELS['x3d_pointwise_static']
    ms = build_recognizer(cfg, test_cfg=dict(average_clips=None)).eval()
    with pytest.raises(ValueError, match='calibrated'):
        common.check_quant_calibrated(ms)
    with torch.no_grad(), ms.calibrate():
        ms(torch.zeros(1, *shape), None, return_loss=False)
    common.check_quant_calibrated(ms)
    stats = common.quant_buffers(ms)
    assert stats and not any(k.startswith('backbone.layer1.')
                             for k in stats)
    odd = torch.zeros(1, 1, 4, HW + 2, HW + 2, 3)   # 17 x 17 at layer1
    with pytest.raises(ValueError, match='s2d_stages'), torch.no_grad():
        ms(odd, None, return_loss=False)


@pytest.mark.parametrize('family', ['2d', 'i3d', 'x3d'])
def test_training_and_short_quant_stages_are_refused(family):
    if family == '2d':
        cfg = dict(type='ResNet', depth=50, num_stages=2, out_indices=(1,),
                   quant='int8')
        x = torch.zeros(1, 3, 32, 32)
    elif family == 'i3d':
        cfg = i3d_backbone(num_stages=2, out_indices=(1,), quant='int8')
        x = torch.zeros(1, 3, 4, 32, 32)
    else:
        cfg = x3d_backbone(depth=1, num_stages=2, out_indices=(1,),
                           quant='int8')
        x = torch.zeros(1, 3, 4, 32, 32)
    bb = build_backbone(dict(cfg, quant_stages=(1, 1)))
    with pytest.raises(ValueError, match='eval-only'):
        bb.train()(x)
    with pytest.raises(ValueError, match='quant_stages'):
        build_backbone(dict(cfg, num_stages=4, out_indices=(3,),
                            quant_stages=(1, 1)))


def test_unknown_modes_are_refused():
    with pytest.raises(ValueError, match='unknown quant'):
        common.conv2d(8, 8, 3, quant='fp4')
    with pytest.raises(ValueError, match='unknown quant'):
        common.conv3d(8, 8, (1, 3, 3), quant='fp4')
    with pytest.raises(ValueError, match='carry_out requires'):
        common.conv2d(8, 8, 3, carry_out=True)


def test_golden_weights_margin_drift():
    """The JAX package's margin test on the port: the golden R50+MVF
    weights (PRNGKey(0), carried from JAX), the shipping (1, 1, 0, 0)
    ``int8_static`` recipe calibrated on a 16-video batch; no top-1 flip,
    and every video's top-2 drift below its margin."""
    jmodel = jax_build(r50_mvf_cfg(), test_cfg=dict(average_clips=None))
    init = jax.jit(lambda key, x: jmodel.init(key, x, None,
                                              return_loss=False))
    variables = init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4, 32, 32, 3), jnp.float32))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, variables))
    cfg_q = r50_mvf_cfg()
    cfg_q['backbone'] = dict(cfg_q['backbone'], quant='int8_static',
                             quant_stages=(1, 1, 0, 0))
    m0 = build_recognizer(r50_mvf_cfg(), test_cfg=dict(average_clips=None))
    mq = build_recognizer(cfg_q, test_cfg=dict(average_clips=None))
    for m in (m0, mq):
        m.load_state_dict(sd, strict=True)
        m.eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(16, 4, 32, 32, 3)
                         .astype(np.float32))
    with torch.no_grad():
        with mq.calibrate():
            mq(x, None, return_loss=False)
        s0 = m0(x, None, return_loss=False).numpy()
        sq = mq(x, None, return_loss=False).numpy()
    order = np.argsort(s0, axis=-1)
    top1, top2 = order[:, -1], order[:, -2]
    idx = np.arange(len(s0))
    margin = s0[idx, top1] - s0[idx, top2]
    d = np.abs(sq - s0)
    pair_drift = d[idx, top1] + d[idx, top2]
    assert (s0.argmax(-1) == sq.argmax(-1)).all()
    assert (pair_drift < margin).all(), (pair_drift.max(), margin.min())


def test_cli_calibration_matches_the_root_cli(setup, tmp_path):
    """``--calib_videos 2`` on the eval test's videos, through an
    ``int8_static`` ResNet-18's first stage with MVF: the port's CLI
    records the quant_stats the root CLI's loop records (JAX, float32, the
    same ``.pth``): the first quantized conv's (MVF's conv1), which no int8
    rounding precedes, within 1e-5; the others within the JAX package's
    2% bound, as the two packages' float32 sums differ in their last bits,
    which can flip an int8 value and move a later abs-max by a step."""
    root, _ = setup
    model = dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=18, num_stages=1,
                      out_indices=(0,), norm_eval=False,
                      quant='int8_static'),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.0, in_channels=64, init_std=0.01,
                      num_classes=11),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(1, 0, 0, 0), mode='THW'))
    test = dict(dataset_cfg(root, False))
    test['pipeline'] = [
        dict(type='CenterCrop', crop_size=HW) if op['type'] == 'ThreeCrop'
        else dict(op, scale=(float('inf'), HW)) if op['type'] == 'Resize'
        else op
        for op in test['pipeline']]
    quant = tmp_path / 'quant.py'
    quant.write_text(re.sub(r'\binf\b', "float('inf')", (
        f'model = {model!r}\n'
        "test_cfg = dict(average_clips='prob')\n"
        f'data = dict(videos_per_gpu=1, workers_per_gpu=1, '
        f'test={test!r})\n')))
    port = build_recognizer(model)
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    ckpt = tmp_path / 'r18.pth'
    torch.save({'state_dict': port.state_dict()}, ckpt)
    got = cli.main([str(quant), str(ckpt), '--device', 'cpu',
                    '--calib_videos', '2'])
    assert np.isfinite(got['scores']).all()

    import logging

    import mvfnet_tpu.data as jdata
    from mvfnet_tpu import Config as JaxConfig
    from mvfnet_tpu.ops.normalize import maybe_device_normalize
    cfg = JaxConfig.fromfile(str(quant))
    model_cfg = dict(cfg.model, fcn_testing=False)
    jmodel = jax_build(model_cfg, train_cfg=None,
                       test_cfg=dict(cfg.test_cfg))
    dataset = jdata.build_dataset(dict(cfg.data['test']))
    # the root CLI's load_model_variables for a .pth, its init jitted:
    # the quant_stats start from the init pass on zeros
    init = jax.jit(lambda key, x: jmodel.init(key, x, None,
                                              return_loss=False,
                                              train=False))
    variables = init(jax.random.PRNGKey(0), jnp.zeros(
        (1,) + dataset[0]['img_group'].shape, jnp.float32))
    variables = import_torch_weights(load_torch_state_dict(str(ckpt)),
                                     variables, logger=logging.getLogger(
                                         'test'))
    apply = jax.jit(lambda v, x: jmodel.apply(
        v, x, None, return_loss=False, mutable=['quant_stats']))
    for i in range(2):          # the root CLI's calibration loop
        imgs = jnp.asarray(np.asarray(dataset[i]['img_group'])[None])
        imgs = maybe_device_normalize(imgs, None)
        _, mut = apply(variables, imgs)
        variables = dict(variables, **mut)
    want = {k: v for k, v in state_dict_from_jax(
        {'params': variables['params'],
         'quant_stats': variables['quant_stats']}).items()
            if is_quant_stat(k)}
    assert set(want) == set(got['quant_stats'])
    first = 'backbone.layer1.0.conv1.net.act_amax'
    np.testing.assert_allclose(got['quant_stats'][first].numpy(),
                               want[first].numpy(), rtol=1e-5)
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(got['quant_stats'][k].numpy(), v.numpy(),
                                   rtol=2e-2)
        moved += not np.allclose(got['quant_stats'][k].numpy(), v.numpy(),
                                 rtol=1e-5)
    print(f'{moved} of {len(want)} statistics beyond 1e-5')
    assert all(float(v) == 1 for k, v in want.items()
               if k.endswith('calibrated'))


def test_calibrated_msgpack_round_trips(tmp_path):
    """The port writes a calibrated model's ``quant_stats`` into its
    ``.msgpack`` and the JAX package reads them; the JAX package's
    ``.msgpack`` loads them into the port's buffers; the scores stay."""
    cfg = r50_cfg('int8_static', quant_carry=True)
    port = build_recognizer(cfg, test_cfg=dict(average_clips=None)).eval()
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, T, HW, HW, 3)
                         .astype(np.float32))
    with torch.no_grad(), port.calibrate():
        port(x, None, return_loss=False)
    stats = common.quant_buffers(port)
    path = str(tmp_path / 'port.msgpack')
    save_msgpack_checkpoint(path, port, meta={'epoch': 1, 'iter': 2})
    variables, _, _ = jax_load(path)
    assert sorted(variables) == ['batch_stats', 'params', 'quant_stats']
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    jax_common.check_quant_calibrated(jmodel, variables)
    back = state_dict_from_jax(variables)
    for k, v in stats.items():
        assert torch.equal(back[k], v)

    jax_path = str(tmp_path / 'jax.msgpack')
    jax_save(jax_path, variables, meta={'epoch': 1, 'iter': 2})
    fresh = build_recognizer(cfg, test_cfg=dict(average_clips=None)).eval()
    with pytest.raises(ValueError, match='calibrated'):
        common.check_quant_calibrated(fresh)
    report = load_weights(fresh, jax_path)
    assert (report['missing'], report['unexpected'],
            report['mismatched']) == ([], [], [])
    common.check_quant_calibrated(fresh)
    for k, v in common.quant_buffers(fresh).items():
        assert torch.equal(v, stats[k])
    with torch.no_grad():
        np.testing.assert_array_equal(
            fresh(x, None, return_loss=False).numpy(),
            port(x, None, return_loss=False).numpy())
    # an unquantized model ignores the collection, as the JAX CLI does
    plain = build_recognizer(r50_cfg(None), test_cfg=dict(
        average_clips=None))
    report = load_weights(plain, jax_path)
    assert (report['missing'], report['unexpected']) == ([], [])
