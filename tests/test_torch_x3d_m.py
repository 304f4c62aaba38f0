"""X3D-M at its published widths against the plain reference.

The port's ``ResNet_X3D`` built from the benchmark's configuration
(``port_bench/configs/x3d_m_16x5.json``: the published form's options)
and loaded strictly with the reference's seeded state dict, against
``port_bench/reference/x3d.py``, both in float64 on the CPU, 2 clips of 4
frames at 32^2: eval logits, train-mode logits with one dropout mask, and
one SGD step through ``make_train_step`` (loss, clipped gradients leaf by
leaf, the parameters' change). Besides: tracing on leaves outputs and
gradients bit-equal and spans each depthwise conv and SE forward and
backward; the counters read 27 depthwise convs and 15 SEs a forward; the
model has X3D-M's 3.8 M parameters; the published form's SE keeps its
gate in fp32 (``SEModule``'s ``fp32_gate``): on a bf16 input its FC
gradients are an fp32 SE's, and on an fp32 or fp64 input the option
changes nothing.

Tolerances: both sides compute in float64 from the same float32
normalization, so they differ only in the order of their sums (cuDNN-free
CPU convolutions, BatchNorm's reductions, the two SE forms): 1e-9
relative with a 1e-12 floor, about 1e4 times float64's rounding over the
model's 84 BatchNorms, and 1e5 times below float32's.
"""

import os
import sys

import pytest
import torch

import torch_reference  # noqa: F401  (the worker's share of the cores)
from mvfnet_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.models.backbones.resnet_x3d import X3DBottleneck
from mvfnet_tpu_torch.models.common import SEModule
from mvfnet_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from port_bench.lib import harness, weights  # noqa: E402
from port_bench.reference import x3d  # noqa: E402
from port_bench.reference.models import Ops, normalize  # noqa: E402
from port_bench.reference.train import PARAM_KINDS  # noqa: E402

CONFIG = harness.load_json(os.path.join(harness.HERE, 'configs',
                                        'x3d_m_16x5.json'))
MODEL = CONFIG['model']
SHAPE = (2, 1, 4, 32, 32, 3)          # (B, clips, T, H, W, 3)
SEED = 2 ** 33 + 5
RTOL, ATOL = 1e-9, 1e-12
# the stem's conv_t and each block's conv2; SE on blocks 0, 2, ... of the
# stages' 3 / 5 / 11 / 7
DWCONVS, SES = 27, 2 + 3 + 6 + 4


def f64(state):
    return {k: v.double() if v.is_floating_point() else v
            for k, v in state.items()}


@pytest.fixture(scope='module')
def state():
    return f64(weights.make_state(x3d.spec(MODEL), SEED, 'cpu', 0.1))


@pytest.fixture(scope='module')
def batch():
    imgs = torch.from_numpy(weights.uint8_frames(SHAPE, 1, SEED, 2,
                                                 'cpu')[0])
    labels = torch.tensor([3, 397])
    return imgs, labels


def port_model(state):
    """The port's recognizer of the configuration, computing in the
    parameters' dtype (float64), holding ``state``."""
    model = build_recognizer(dict(MODEL, dtype=None), train_cfg=None,
                             test_cfg=CONFIG['test_cfg']).double()
    model.load_state_dict(state, strict=True)
    return model


def clips(imgs):
    """The normalized clips, (B * clips, T, H, W, 3) for the port and
    (B * clips, 3, T, H, W) for the reference."""
    x = normalize(imgs, CONFIG['img_norm_cfg'], torch.float64)
    x = x.reshape((-1,) + tuple(x.shape[2:]))
    return x, x.permute(0, 4, 1, 2, 3)


def close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def mask(seed, rows):
    """The head's dropout mask from a generator seeded ``seed``, drawn as
    ``I3DClsHead.dropout`` draws it, and its kept entries."""
    g = torch.Generator().manual_seed(seed)
    keep = torch.rand((rows, 2048), generator=g) >= 0.5
    return torch.Generator().manual_seed(seed), keep


def test_the_model_has_x3d_ms_parameters(state):
    model = port_model(state)
    count = sum(p.numel() for p in model.parameters())
    assert 3.7e6 < count < 3.9e6
    kinds = weights.kinds(x3d.spec(MODEL))
    assert count == sum(v.numel() for k, v in state.items()
                        if kinds[k] in PARAM_KINDS)


def test_eval_logits_match_the_reference(state, batch):
    port_in, ref_in = clips(batch[0])
    model = port_model(state).eval()
    with torch.no_grad():
        got = model.cls_head(model.extract_feat(port_in))
        want = x3d.logits(Ops(state), ref_in, MODEL)
    assert got.shape == (2, 400)
    close(got, want)


def test_train_logits_match_the_reference(state, batch):
    port_in, ref_in = clips(batch[0])
    model = port_model(state).train()
    generator, keep = mask(SEED + 1, 2)
    with torch.no_grad():
        got = model.cls_head(model.extract_feat(port_in),
                             generator=generator)
        want = x3d.logits(Ops(state, train=True), ref_in, MODEL, keep)
    close(got, want)


@pytest.fixture(scope='module')
def one_step(state, batch):
    """One SGD step of the port's train step and of the reference, from
    the same state, batch and mask, at the configuration's recipe."""
    imgs, labels = batch
    model = port_model(state)
    schedule = build_lr_schedule(CONFIG['lr_config'],
                                 CONFIG['optimizer']['lr'],
                                 CONFIG['iters_per_epoch'],
                                 CONFIG['total_epochs'])
    optimizer = build_optimizer(
        model, CONFIG['optimizer'], schedule,
        grad_clip=CONFIG['optimizer_config']['grad_clip'])
    step = make_train_step(model, optimizer, schedule,
                           norm_cfg=dict(CONFIG['img_norm_cfg'], device=True),
                           device='cpu')
    generator, keep = mask(SEED + 2, 2)
    metrics = step(imgs, labels, generator)
    names = {p: n for n, p in model.named_parameters()}
    wd = CONFIG['optimizer']['weight_decay']
    grads = {names[p]: s['momentum_buffer'] - wd * state[names[p]]
             for p, s in optimizer.state.items()}
    after = {n: p.detach() for n, p in model.named_parameters()}
    want = x3d.train_steps(
        state, weights.kinds(x3d.spec(MODEL)), [(imgs, labels)], [keep],
        [schedule(0)], MODEL, CONFIG['img_norm_cfg'], CONFIG['optimizer'],
        CONFIG['optimizer_config']['grad_clip']['max_norm'])
    return (float(metrics['loss']), grads, after), want


def test_one_step_loss_matches_the_reference(one_step):
    (loss, _, _), (losses, _, _, _) = one_step
    assert loss == pytest.approx(losses[0], rel=RTOL)


def test_one_step_clipped_gradients_match_the_reference(one_step):
    (_, grads, _), (_, want, _, _) = one_step
    assert set(grads) == set(want)
    for k in want:
        close(grads[k], want[k])


def test_one_step_change_matches_the_reference(one_step, state):
    (_, _, after), (_, _, final, _) = one_step
    assert set(after) == set(final)
    for k in final:
        close(after[k] - state[k], final[k] - state[k])


def forward_backward(state, imgs):
    """Train-mode logits and every parameter's gradient of their sum."""
    model = port_model(state).train()
    generator, _ = mask(SEED + 3, 2)
    out = model.cls_head(model.extract_feat(clips(imgs)[0]),
                         generator=generator)
    out.sum().backward()
    return out.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_tracing_on_is_bit_equal_and_spans_forward_and_backward(state,
                                                                 batch):
    out_off, grads_off = forward_backward(state, batch[0])
    tracing.clear()
    tracing.enable()
    try:
        out_on, grads_on = forward_backward(state, batch[0])
    finally:
        tracing.disable()
    spans = tracing.collect()
    tracing.clear()
    assert torch.equal(out_on, out_off)
    assert all(torch.equal(grads_on[k], grads_off[k]) for k in grads_off)
    names = [s['name'] for s in spans]
    # each forward, and each backward opened when the gradient arrives
    assert names.count('model.dwconv') == 2 * DWCONVS
    assert names.count('model.se') == 2 * SES


def test_counters_count_each_depthwise_conv_and_se(state, batch):
    model = port_model(state).eval()
    before = dict(X3DBottleneck.counts)
    with torch.no_grad():
        model.extract_feat(clips(batch[0])[0])
    assert X3DBottleneck.counts['dwconv'] - before.get('dwconv', 0) == \
        DWCONVS
    assert X3DBottleneck.counts['se'] - before.get('se', 0) == SES


def se_pair(dtype, seed=7):
    """Two SEs with one set of weights, the gate in fp32 and in the
    input's dtype, and an input of ``dtype`` whose channels have means of
    their own (as a BatchNorm's output has)."""
    torch.manual_seed(seed)
    pair = [SEModule(54, hidden=8, fp32_gate=g) for g in (True, False)]
    pair[1].load_state_dict(pair[0].state_dict())
    x = torch.randn(2, 54, 4, 8, 8) + torch.randn(1, 54, 1, 1, 1)
    weighting = torch.randn(x.shape).to(dtype)     # the loss's gradient
    return pair, x.to(dtype), weighting


def se_grads(se, x, weighting, dtype=None):
    """The SE's output and its FCs' gradients under the loss
    ``sum(out * weighting)``, the input taken in ``dtype``."""
    se.zero_grad()
    x = x if dtype is None else x.to(dtype)
    out = se(x)
    (out * weighting.to(out.dtype)).sum().backward()
    return out.detach(), [p.grad.clone() for p in se.parameters()]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_the_fp32_gate_changes_nothing_at_fp32_or_fp64(dtype):
    (gate32, plain), x, weighting = se_pair(dtype)
    out_a, grads_a = se_grads(gate32.to(dtype), x, weighting)
    out_b, grads_b = se_grads(plain.to(dtype), x, weighting)
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(a, b) for a, b in zip(grads_a, grads_b))


def test_the_fp32_gate_gives_an_fp32_ses_gradients_at_bf16():
    (gate32, plain), x, weighting = se_pair(torch.bfloat16)
    # the SE in fp32 on the same bf16 values: the gate's gradient sums
    # the same exact products, in another order
    _, want = se_grads(plain, x, weighting, torch.float32)
    _, got = se_grads(gate32, x, weighting)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    # a gate in bf16 rounds each channel's scale and each product of the
    # gate's gradient: the same comparison fails
    _, rounded = se_grads(plain, x, weighting)
    assert not all(torch.allclose(a, b, rtol=1e-4, atol=1e-6)
                   for a, b in zip(rounded, want))
