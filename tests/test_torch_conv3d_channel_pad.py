"""The space-to-depth form of the 3-D stems' conv (models/common.py).

A bf16 stem conv on the card runs as ``common.conv3d_space_to_depth``:
2x2 pixel blocks folded into zero-padded channels, a spatial stride-1
conv. Here, on the CPU in f64, that form is held against ``F.conv3d``
with the plain weight at each stem geometry of the port's 3-D backbones
(forward, weight and input gradients), ``common.takes_space_to_depth``
against the size floor that PERF.md §6's table sets, the convs that must
keep the plain conv, and ``Conv3d.counts['channels_padded']``. The bf16
tensor-core kernel on the card is in tests/test_torch_cuda_kernels.py.
"""

import pytest
import torch
import torch.nn.functional as F

from mvfnet_tpu_torch.models import common
from mvfnet_tpu_torch.models.backbones.resnet_i3d import ResNet_I3D

COUNTS = common.Conv3d.counts
CL = torch.channels_last_3d

# name: (Cin, Cout, kernel, stride, padding, a small input (N, T, H, W),
# the config's test input (30 views)); Inception's inputs are its
# forward's (2, 4)-padded ones
STEMS = {
    'i3d': (3, 64, (5, 7, 7), (2, 2, 2), (2, 3, 3), (2, 8, 16, 20),
            (30, 32, 256, 256)),
    'slowfast_slow': (3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                      (2, 4, 16, 16), (30, 4, 256, 256)),
    'slowfast_fast': (3, 8, (5, 7, 7), (1, 2, 2), (2, 3, 3),
                      (2, 8, 16, 16), (30, 32, 256, 256)),
    'x3d': (3, 24, (5, 7, 7), (2, 2, 2), (2, 3, 3), (2, 8, 14, 18),
            (30, 16, 256, 256)),
    'r3d': (3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3), (2, 4, 12, 12),
            (30, 8, 112, 112)),
    'r2plus1d': (3, 45, (1, 7, 7), (1, 2, 2), (0, 3, 3), (2, 4, 12, 16),
                 (30, 8, 112, 112)),
    'inception_i3d': (3, 64, (7, 7, 7), (2, 2, 2), (0, 0, 0),
                      (1, 10, 22, 22), (30, 70, 230, 230)),
    'inception_i3d_flow': (2, 64, (7, 7, 7), (2, 2, 2), (0, 0, 0),
                           (1, 10, 22, 24), (30, 70, 230, 230)),
}


def _stem(name, bias=False, dtype=torch.float64):
    cin, cout, kernel, stride, padding = STEMS[name][:5]
    conv = common.conv3d(cin, cout, kernel, stride=stride, padding=padding,
                         bias=bias).to(dtype)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen))
        if bias:
            conv.bias.copy_(torch.randn(cout, generator=gen))
    return conv


def _input(cin, shape, dtype=torch.float64, seed=1):
    n, t, h, w = shape
    x = torch.randn((n, cin, t, h, w), generator=torch.Generator()
                    .manual_seed(seed), dtype=torch.float64)
    return x.to(dtype).contiguous(memory_format=CL)


def _space_to_depth(conv, x):
    return common.conv3d_space_to_depth(x, conv.weight, conv.bias,
                                        conv.stride, conv.padding,
                                        conv.dilation)


def _plain(conv, x):
    return F.conv3d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                    conv.dilation)


@pytest.mark.parametrize('name', STEMS)
def test_space_to_depth_equals_the_plain_conv(name):
    conv = _stem(name, bias=True)
    x = _input(conv.in_channels, STEMS[name][5])
    want = _plain(conv, x)
    got = _space_to_depth(conv, x)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


@pytest.mark.parametrize('name', STEMS)
def test_space_to_depth_gradients_equal_the_plain_conv(name):
    """The weight's gradient reaches it through the fold and the pad of
    the taps, a slice of the folded weight's gradient; the input's
    through the fold of the input."""
    conv = _stem(name)
    x = _input(conv.in_channels, STEMS[name][5]).requires_grad_()
    grad = torch.randn(_plain(conv, x).shape, generator=torch.Generator()
                       .manual_seed(2), dtype=torch.float64)
    want = torch.autograd.grad(_plain(conv, x), (conv.weight, x), grad)
    got = torch.autograd.grad(_space_to_depth(conv, x), (conv.weight, x),
                              grad)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-12 * w.abs().max().item()


@pytest.mark.parametrize('views', [30, 1])
@pytest.mark.parametrize('name', STEMS)
def test_the_rule_takes_each_stem_above_the_floor(name, views):
    """At the config's test shape (30 views) every stem takes the form in
    bf16 on the card (PERF.md §6: each wins there, forward and with the
    weight gradient); at one view only Inception's 25.7 M outputs clear
    the 20 M floor."""
    conv = _stem(name)
    shape = (views, conv.in_channels) + STEMS[name][6][1:]
    want = views == 30 or name.startswith('inception_i3d')
    assert common.takes_space_to_depth(conv, shape, torch.bfloat16,
                                       torch.device('cuda')) is want


# name: (the conv, an input (N, C, T, H, W), the dtype, the device the
# rule is asked about); every conv here keeps the plain conv, and all but
# the last clear the size floor
PLAIN = {
    'grouped': (lambda: common.conv3d(6, 48, (1, 7, 7), stride=(1, 2, 2),
                                      groups=3),
                (30, 6, 8, 112, 112), torch.bfloat16, 'cuda'),
    'cin45': (lambda: common.conv3d(45, 64, (3, 7, 7), stride=(1, 2, 2)),
              (30, 45, 8, 112, 112), torch.bfloat16, 'cuda'),
    'cin64': (lambda: common.conv3d(64, 64, (1, 7, 7), stride=(1, 2, 2)),
              (30, 64, 8, 112, 112), torch.bfloat16, 'cuda'),
    'x3d_depthwise': (lambda: common.conv3d(24, 24, (3, 1, 1), groups=24),
                      (30, 24, 8, 128, 128), torch.bfloat16, 'cuda'),
    'fp32': (lambda: _stem('i3d', dtype=torch.float32),
             (30, 3, 32, 256, 256), torch.float32, 'cuda'),
    'cpu': (lambda: _stem('i3d', dtype=torch.bfloat16),
            (30, 3, 32, 256, 256), torch.bfloat16, 'cpu'),
    'stride1': (lambda: common.conv3d(3, 64, (3, 7, 7)),
                (30, 3, 8, 112, 112), torch.bfloat16, 'cuda'),
    'odd_width': (lambda: _stem('i3d'), (30, 3, 32, 256, 255),
                  torch.bfloat16, 'cuda'),
    'below_floor': (lambda: _stem('r2plus1d'), (16, 3, 8, 112, 112),
                    torch.bfloat16, 'cuda'),
}


@pytest.mark.parametrize('name', PLAIN)
def test_other_convs_take_the_plain_conv_and_count_nothing(name):
    make, shape, dtype, device = PLAIN[name]
    conv = make()
    assert not common.takes_space_to_depth(conv, shape, dtype,
                                           torch.device(device))
    conv = conv.to(dtype)
    n, c, t, h, w = shape
    x = _input(c, (1, min(t, 4), min(h, 16), min(w, 15 if w % 2 else 16)),
               dtype)
    before = COUNTS['channels_padded']
    got = conv(x)
    assert COUNTS['channels_padded'] == before
    want = F.conv3d(x, conv.weight.to(dtype), None, conv.stride,
                    conv.padding, conv.dilation, conv.groups)
    assert torch.equal(got, want)


def test_i3d_counts_one_padded_conv_a_forward(monkeypatch):
    """A small I3D's forward with the rule taking its stem (as bf16 on the
    card does), in f64 on the CPU: one ``channels_padded`` count a
    forward, and the features of the plain forward."""
    model = ResNet_I3D(depth=18, num_stages=2, out_indices=(1,),
                       conv1_kernel=(5, 7, 7), conv1_stride_t=2,
                       pool1_stride_t=2, norm_cfg=dict(type='BN3d'))
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.double().eval()
    x = _input(3, (2, 8, 32, 32))
    with torch.no_grad():
        before = COUNTS['channels_padded']
        want = model(x)
        assert COUNTS['channels_padded'] == before
        monkeypatch.setattr(common, 'takes_space_to_depth',
                            lambda conv, *args: conv.in_channels < 8)
        got = model(x)
        assert COUNTS['channels_padded'] == before + 1
        model(x)
        assert COUNTS['channels_padded'] == before + 2
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()


def test_space_to_depth_takes_a_pathway_s_strided_frames():
    """SlowFast's pathways convolve every tau-th frame of the clip, a view
    strided in time; the form reads it as it is."""
    conv = _stem('slowfast_slow', bias=True)
    x = _input(3, (2, 16, 16, 20))[:, :, ::4]
    want = _plain(conv, x)
    got = _space_to_depth(conv, x)
    assert (got - want).abs().max().item() <= 1e-12 * want.abs().max().item()
