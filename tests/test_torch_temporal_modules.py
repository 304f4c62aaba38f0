"""Port parity: the temporal modules and the TRN heads (TSM, CoST, the
non-local ``LocalAttention`` in its 2-D and I3D placements, TRN and
TRNmultiscale consensus).

Modules are held against the JAX package in f64 with the same weights:
module by module, then in whole recognizers whose weights go through the
port's bridge (the carried tree equals the JAX model's ``eval_shape``
tree). Forwards agree to rtol 1e-6 / atol 1e-8; the train step (a
non-local R50 on two stages with a TRNmultiscale head, dropout 0.8 with
one scripted mask on both sides) to rtol 1e-9 on the loss and gradient
norm and 1e-7 / atol 1e-9 on the updated parameters and BatchNorm
statistics. The non-local blocks' ``conv_in`` and ``bn`` weights are
scaled down after the random init: their cubic affinity grows the logits
past 1e100 otherwise, in both packages alike.

The TRN train step shows what the JAX train step trains on: it supplies no
``'subsets'`` RNG, so the multiscale module takes the deterministic pick,
and so does the port without a generator (ROADMAP.md, section C).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine import train_step as jax_train_step_mod
from mvfnet_tpu.engine.train_step import TrainState
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.models.heads import consensus as jax_consensus
from mvfnet_tpu.models.heads.tsn_head import TSNClsHead as JaxTSNClsHead
from mvfnet_tpu.models.modules import cost as jax_cost
from mvfnet_tpu.models.modules import nonlocal_attention as jax_nl
from mvfnet_tpu.models.modules import tsm as jax_tsm
from mvfnet_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models.heads.consensus import RelationModuleMultiScale
from mvfnet_tpu_torch.models.heads.tsn_head import TSNClsHead
from mvfnet_tpu_torch.models.modules.cost import CoST
from mvfnet_tpu_torch.models.modules.nonlocal_attention import (
    LocalAttention, nonlocal_block_indices)
from mvfnet_tpu_torch.models.modules.tsm import ShiftConv2d, temporal_shift
from mvfnet_tpu_torch.utils.checkpoint import (jax_entries,
                                               jax_variables_from_state_dict)
from test_torch_i3d import (ATOL, LR_CONFIG, MAX_NORM, RECIPE, RTOL,
                            STATE_ATOL, STATE_RTOL, STEP_RTOL, f64,
                            i3d_backbone, jax_forward, jax_variables,
                            model_cfg, port_model)

assert f64  # the module-scoped x64 fixture, autouse

NUM_CLASSES = 5
R50 = dict(type='ResNet', depth=50, out_indices=(3,), norm_eval=False)


def tsn_cfg(backbone, in_channels, dropout=0.0, consensus=None, **extra):
    """A ``Recognizer2D`` with a TSN head, computing in the params' dtype."""
    head = dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                dropout_ratio=dropout, in_channels=in_channels,
                init_std=0.01, num_classes=NUM_CLASSES)
    if consensus:
        head['consensus_cfg'] = consensus
    return dict(type='Recognizer2D', backbone=backbone, cls_head=head,
                dtype=None, **extra)


def frames(seed, b, s, hw):
    return np.random.RandomState(seed).randn(b, s, hw, hw, 3) * 0.5


def tame_nonlocal(port, scale=0.1):
    """Scale every non-local block's ``conv_in`` and BN gamma down."""
    with torch.no_grad():
        for m in port.modules():
            if isinstance(m, LocalAttention):
                m.conv_in.weight.mul_(scale)
                m.bn.weight.mul_(scale)
    return port


def assert_forward_matches(cfg, x, port=None):
    port = (port or port_model(cfg)).eval()
    shape = (1,) + x.shape[1:]
    want = jax_forward(cfg, jax_variables(port, cfg, shape), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    return got


# -- module level --------------------------------------------------------

def test_temporal_shift_matches_jax_with_zero_boundaries():
    t, fold = 4, 2
    x = np.random.RandomState(0).randn(2 * t, 3, 5, 8 * fold)
    want = np.asarray(jax_tsm.TemporalShift(n_segment=t, n_div=8).apply(
        {}, jnp.asarray(x)))
    got = temporal_shift(torch.from_numpy(x), t, 8).numpy()
    np.testing.assert_array_equal(got, want)
    g5 = got.reshape(2, t, 3, 5, -1)
    x5 = x.reshape(2, t, 3, 5, -1)
    assert (g5[:, -1, ..., :fold] == 0).all()             # back: last frame
    assert (g5[:, 0, ..., fold:2 * fold] == 0).all()      # fwd: first frame
    np.testing.assert_array_equal(g5[:, :-1, ..., :fold],
                                  x5[:, 1:, ..., :fold])
    # the conv MobileNetV2 shifts before: an identity 1x1 kernel
    conv = ShiftConv2d(16, 16, 1, bias=False, n_segment=t).double()
    with torch.no_grad():
        conv.weight.copy_(torch.eye(16).reshape(16, 16, 1, 1))
        nchw = conv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize('train', [False, True])
def test_cost_matches_jax(train):
    t, c = 3, 6
    port = CoST(t, c).double()
    port.reset_taps(torch.Generator().manual_seed(0))
    with torch.no_grad():
        port.bn.running_mean.uniform_(-0.1, 0.1)
        port.bn.running_var.uniform_(0.8, 1.2)
    x = np.random.RandomState(1).randn(2 * t, 5, 4, c)
    variables = {
        'params': {'shift_conv': jnp.asarray(
            port.shift_conv.weight.detach()[:, :, 0].permute(2, 3, 1, 0)
            .numpy()),
            'bn': {'scale': jnp.asarray(port.bn.weight.detach().numpy()),
                   'bias': jnp.asarray(port.bn.bias.detach().numpy())}},
        'batch_stats': {'bn': {'mean': jnp.asarray(port.bn.running_mean),
                               'var': jnp.asarray(port.bn.running_var)}}}
    jmod = jax_cost.CoST(n_segment=t, in_channels=c, dtype=jnp.float64)
    want, state = jmod.apply(variables, jnp.asarray(x), train=train,
                             mutable=['batch_stats'])
    port.train(train)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(port.bn.running_var.numpy(),
                               np.asarray(state['batch_stats']['bn']['var']),
                               rtol=RTOL)


NL_OPTIONS = {
    'dot_product': dict(),
    'softmax': dict(instantiation='softmax'),
    'time_shift': dict(use_time_shift=True),
    'softmax_shift_weighting': dict(instantiation='softmax',
                                    use_time_shift=True,
                                    time_weighting_size=(18, 18, 1)),
    'kernel5_weighting': dict(kernel_size=5, padding=2,
                              time_weighting_size=(1, 50, 1)),
}


@pytest.mark.parametrize('name', sorted(NL_OPTIONS))
def test_local_attention_matches_jax(name):
    """Every option of the module, in eval (each) and train (BatchNorm on
    the batch, its statistics updated) mode."""
    opts = NL_OPTIONS[name]
    n, t, h, w, c, hid = 2, 2, 5, 4, 8, 4
    port = LocalAttention(c, hid, **opts).double()
    port.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        if port.time_weighting is not None:
            port.time_weighting.uniform_(0.5, 1.5)
        port.bn.running_var.uniform_(0.8, 1.2)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}

    def conv(prefix):
        return {'kernel': jnp.asarray(sd[prefix + '.weight'].transpose(
            2, 3, 4, 1, 0)), 'bias': jnp.asarray(sd[prefix + '.bias'])}

    params = {'conv_in': conv('conv_in'), 'conv_out': conv('conv_out'),
              'bn': {'scale': sd['bn.weight'], 'bias': sd['bn.bias']}}
    if port.time_weighting is not None:
        params['time_weighting'] = sd['time_weighting']
    variables = {'params': params, 'batch_stats': {'bn': {
        'mean': sd['bn.running_mean'], 'var': sd['bn.running_var']}}}
    jmod = jax_nl.LocalAttention(dim=c, hidden=hid, dtype=jnp.float64, **opts)
    x = np.random.RandomState(1).randn(n, t, h, w, c)
    for train in (False, True):
        want, state = jmod.apply(variables, jnp.asarray(x), train=train,
                                 mutable=['batch_stats'])
        port.train(train)
        got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=str(train))
    np.testing.assert_allclose(port.bn.running_mean.numpy(),
                               np.asarray(state['batch_stats']['bn']['mean']),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('blocks,num', [(4, 2), (6, 3), (23, 3), (2, 2),
                                        (36, 3), (2, 3)])
def test_nonlocal_block_indices_match_jax(blocks, num):
    assert nonlocal_block_indices(blocks, num) == \
        jax_nl.nonlocal_block_indices(blocks, num)


# -- the 2-D and 3-D placements ------------------------------------------

def test_cost_r50_forward_matches_jax():
    """CoST in stages 3-4 (``shift_freq``) replaces conv2 of their
    non-first blocks; those blocks are not fusable."""
    cfg = tsn_cfg(R50, 2048, module_cfg=dict(
        type='CoST', n_segment=2, shift_freq=(0, 0, 1, 1), place='blockres'))
    port = port_model(cfg)
    bb = port.backbone
    assert isinstance(bb.layer3[1].conv2, CoST)
    assert not isinstance(bb.layer3[0].conv2, CoST)
    assert [j for i in range(1, 5) for j, b in enumerate(
        getattr(bb, f'layer{i}')) if b.fusable] == [1, 2, 1, 2, 3]
    assert_forward_matches(cfg, frames(0, 2, 2, 32), port)


def test_nonlocal_r50_forward_matches_jax():
    """Non-local blocks after layer2.{1,3} and layer3.{1,3,5}; the wrapped
    blocks still fuse in eval."""
    cfg = tsn_cfg(R50, 2048, nonlocal_cfg=dict(n_segment=2))
    port = tame_nonlocal(port_model(cfg))
    names = {n for n, _ in port.named_modules() if n.endswith('.nl')}
    assert names == {f'backbone.layer{i}.{j}.nl'
                     for i, js in ((2, (1, 3)), (3, (1, 3, 5))) for j in js}
    assert port.backbone.layer2[1].block.fusable
    assert_forward_matches(cfg, frames(0, 2, 2, 32), port)


def test_i3d_nonlocal_forward_matches_jax():
    """``nonlocal_cfg`` in I3D: after blocks 0 and 2 of stage 2 by a
    per-block ``nonlocal_freq``, as ``layer2.{0,2}.nonlocal_block``."""
    cfg = model_cfg(i3d_backbone(
        num_stages=2, out_indices=(1,), nonlocal_stages=(1,),
        nonlocal_freq=(0, (1, 0, 1, 0)), nonlocal_cfg=dict(embed_dim=64)),
        512)
    port = tame_nonlocal(port_model(cfg))
    assert {n for n, _ in port.named_modules()
            if n.endswith('nonlocal_block')} == {
        'backbone.layer2.0.nonlocal_block', 'backbone.layer2.2.nonlocal_block'}
    assert port.backbone.layer2[0].nonlocal_block.hidden == 64
    x = np.random.RandomState(1).randn(2, 1, 8, 32, 32, 3) * 0.5
    port.eval()
    want = jax_forward(cfg, jax_variables(port, cfg), x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), None, return_loss=False).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- TRN heads -----------------------------------------------------------

def _head_variables(port_head):
    """The port head's weights as the JAX head's variables."""
    sd = {'cls_head.' + k: v for k, v in port_head.state_dict().items()}
    return {'params': jax_variables_from_state_dict(sd)['params']['head_mod']}


@pytest.mark.parametrize('ctype,frames_,spatial', [
    ('TRN', 3, 'avg'), ('TRNmultiscale', 4, 'avg'),
    ('TRNmultiscale', 5, 'max')])
def test_trn_head_forward_matches_jax(ctype, frames_, spatial):
    """The head on the deterministic pick: ``new_fc`` to 256, then the
    relation MLPs; ``spatial_type='max'`` pools by the maximum."""
    kw = dict(spatial_type=spatial, dropout_ratio=0.0, in_channels=16,
              num_classes=NUM_CLASSES,
              consensus_cfg=dict(type=ctype, num_frames=frames_))
    port = TSNClsHead(**kw).double()
    port.init_weights(torch.Generator().manual_seed(0))
    assert port.new_fc.weight.shape == (256, 16)
    x = np.random.RandomState(2).randn(2 * frames_, 3, 2, 16)
    jhead = JaxTSNClsHead(dtype=jnp.float64, **kw)
    want = jhead.apply(_head_variables(port), jnp.asarray(x), frames_)
    got = port.eval()(torch.from_numpy(x), frames_)
    assert got.shape == (2, NUM_CLASSES)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('ctype', ['TRN', 'TRNmultiscale'])
def test_trn_head_without_num_frames(ctype):
    """A TRN ``consensus_cfg`` without ``num_frames``: the JAX head sizes
    its relation MLPs from its first call's segments, the port, which
    sizes them when it builds the head, refuses the config (ROADMAP.md,
    section C)."""
    kw = dict(dropout_ratio=0.0, in_channels=16, num_classes=NUM_CLASSES,
              consensus_cfg=dict(type=ctype))
    x = jnp.asarray(np.random.RandomState(2).randn(6, 3, 2, 16))
    variables = JaxTSNClsHead(dtype=jnp.float64, **kw).init(
        jax.random.PRNGKey(0), x, 3)
    assert (variables['params']['consensus'][
        'fc1' if ctype == 'TRN' else 'fc_fusion_0_fc1'][
        'kernel'].shape[0] == 3 * 256)
    with pytest.raises(ValueError, match='num_frames'):
        TSNClsHead(**kw)


def test_trn_multiscale_stochastic_picks_match_jax(monkeypatch):
    """Fed the subsets ``jax.random.choice`` draws for the JAX module's
    ``'subsets'`` RNG, the port computes what JAX does; its own generator
    draws reproducibly and differs from the deterministic pick."""
    num_frames, dim = 4, 8
    port = RelationModuleMultiScale(dim, num_frames, NUM_CLASSES).double()
    port.reset_parameters(torch.Generator().manual_seed(0))
    sd = {'cls_head.segmental_consensus.' + k: v
          for k, v in port.state_dict().items()}
    variables = {'params': jax_variables_from_state_dict(sd)['params'][
        'head_mod']['consensus']}
    x = np.random.RandomState(3).randn(2, num_frames, dim)
    drawn = []
    choice = jax.random.choice

    def recording(*args, **kwargs):
        out = choice(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, 'choice', recording)
    jmod = jax_consensus.RelationModuleMultiScale(
        img_feature_dim=dim, num_frames=num_frames, num_classes=NUM_CLASSES,
        dtype=jnp.float64)
    want = jmod.apply(variables, jnp.asarray(x),
                      rngs={'subsets': jax.random.PRNGKey(7)})
    assert [len(d) for d in drawn] == [3, 3]     # scales 3 and 2: 4 and 6
    xt = torch.from_numpy(x)
    got = port(xt, picks=drawn)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    det = port(xt)
    want_det = jmod.apply(variables, jnp.asarray(x))     # no 'subsets' RNG
    np.testing.assert_allclose(det.detach().numpy(), np.asarray(want_det),
                               rtol=RTOL, atol=ATOL)
    gen = [port(xt, generator=torch.Generator().manual_seed(s))
           for s in (1, 1)]
    torch.testing.assert_close(gen[0], gen[1], rtol=0, atol=0)
    assert not torch.allclose(gen[0], det)


# -- one train step: non-local R50 + TRNmultiscale, dropout 0.8 ----------

def scripted_dropout(monkeypatch, mask):
    """Both packages' head dropout keeps exactly ``mask``."""
    monkeypatch.setattr(jax.random, 'bernoulli',
                        lambda *a, **k: jnp.asarray(mask))

    def dropout(self, feat, generator):
        if not (self.training and self.dropout_ratio):
            return feat
        keep = torch.from_numpy(mask)
        return torch.where(keep, feat / (1 - self.dropout_ratio),
                           torch.zeros_like(feat))

    monkeypatch.setattr(TSNClsHead, 'dropout', dropout)


def assert_train_step_matches_jax(cfg, port, imgs, labels):
    """One train step of the port's ``make_train_step`` and the JAX
    package's from one state (the step LR policy, SGD nesterov, the clip):
    the loss, gradient norm, parameters and BatchNorm statistics."""
    variables = jax_variables(port, cfg, (1,) + imgs.shape[1:])
    jmodel = jax_build(cfg, test_cfg=dict(average_clips=None))
    sched = jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    tx = jax_optim.build_optimizer(
        variables['params'], RECIPE, sched,
        grad_clip=dict(max_norm=MAX_NORM, norm_type=2))
    jstep = jax_train_step_mod.make_train_step(jmodel, tx, mesh=None,
                                               donate=False)
    state, m = jstep(TrainState.create(variables, tx), jnp.asarray(imgs),
                     jnp.asarray(labels), jax.random.PRNGKey(0))
    want = [float(m['loss']), float(m['grad_norm'])]
    psched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 8)
    opt = build_optimizer(port, RECIPE, psched,
                          grad_clip=dict(max_norm=MAX_NORM, norm_type=2))
    pm = make_train_step(port, opt, psched, device='cpu')(imgs, labels)
    np.testing.assert_allclose([pm['loss'].item(), pm['grad_norm'].item()],
                               want, rtol=STEP_RTOL)
    got = port.state_dict()
    stats = 0
    for coll, path, name, value in jax_entries(
            jax.tree_util.tree_map(np.asarray, state.variables())):
        np.testing.assert_allclose(got[name].numpy(), value,
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=path)
        stats += coll == 'batch_stats'
    assert stats > 0
    return want


def test_nonlocal_trn_train_step_matches_jax(monkeypatch):
    """Both packages train the multiscale head on the deterministic pick:
    the JAX step passes only a dropout RNG, and the port passes no subset
    generator; another pick gives another loss."""
    s, b = 4, 2
    cfg = tsn_cfg(dict(R50, num_stages=2, out_indices=(1,)), 512,
                  dropout=0.8, nonlocal_cfg=dict(n_segment=s),
                  consensus=dict(type='TRNmultiscale', num_frames=s))
    mask = np.random.RandomState(5).rand(b * s, 512) >= 0.8
    scripted_dropout(monkeypatch, mask)
    port = tame_nonlocal(port_model(cfg))
    other = tame_nonlocal(port_model(cfg))
    imgs = frames(7, b, s, 32)
    labels = np.array([1, 3])
    want = assert_train_step_matches_jax(cfg, port, imgs, labels)
    multiscale = other.cls_head.segmental_consensus
    monkeypatch.setattr(multiscale, 'forward', functools.partial(
        RelationModuleMultiScale.forward, multiscale,
        picks=[[0, 1, 2], [3, 4, 5]]))
    loss = other.train()(torch.from_numpy(imgs), torch.from_numpy(labels),
                         return_loss=True)['loss_cls'].item()
    assert abs(loss - want[0]) > 1e-6 * abs(want[0])
