"""Port parity: the JAX package's ``.msgpack`` checkpoints.

- The port's codec (``utils/msgpack_codec.py``) against
  ``flax.serialization``: the same bytes for the same tree, and each side
  restores the other's bytes, on a tree of every leaf kind a flax
  checkpoint holds (f32, f64, i32, i64, bool and bf16 arrays, numpy
  scalars, empty maps, array payloads in bin8, bin16 and bin32, a chunked
  leaf with flax's ``MAX_CHUNK_SIZE`` lowered) and the scalar widths.
- A checkpoint the JAX package's ``save_checkpoint`` wrote loads into the
  port equal to ``state_dict_from_jax`` bit for bit, meta included; one the
  port's ``save_msgpack_checkpoint`` wrote restores into the JAX model's
  variables with flax's ``from_state_dict``, bit for bit.
- The optax state across formats, in f64 with the recipe and a clip of 2
  (``test_torch_train_step.py``'s model at depth 18, R18+MVF at T=2, B=2,
  here at 32x32): the JAX step's state after 2 steps, saved by JAX, resumes the
  port, whose next step equals JAX's continued run (loss and grad norm at
  rtol 1e-9); the port's state after it, saved by the port, resumes the JAX
  step, whose next step equals the port's continued run at the same
  tolerance; final parameters at rtol 1e-7 / atol 1e-9. The state's layout
  follows the recipe when a state moves or goes (no clip, no weight decay,
  no momentum, a label without decay, frozen parameters).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mvfnet_tpu.engine import optim as jax_optim
from mvfnet_tpu.engine.train_step import TrainState
from mvfnet_tpu.engine.train_step import make_train_step as jax_train_step
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.utils.checkpoint import load_checkpoint as jax_load
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu_torch.engine.optim import build_lr_schedule, build_optimizer
from mvfnet_tpu_torch.engine.train_step import make_train_step
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.utils import msgpack_codec as codec
from mvfnet_tpu_torch.utils.checkpoint import (jax_entries,
                                               jax_variables_from_state_dict,
                                               load_checkpoint,
                                               load_optax_state,
                                               optax_state_from_optimizer,
                                               save_msgpack_checkpoint,
                                               state_dict_from_jax)
from test_torch_train_step import LR_CONFIG, RECIPE, model_cfg


def _bf16_pair(rng, n):
    """The same bf16 values as an ml_dtypes array (flax) and a torch
    tensor (the port)."""
    j = jnp.asarray(rng.randn(n), jnp.bfloat16)
    bits = np.asarray(j).view(np.int16)
    return np.asarray(j), torch.from_numpy(bits.copy()).view(torch.bfloat16)


def _trees():
    rng = np.random.RandomState(0)
    bf_flax, bf_port = _bf16_pair(rng, 9)
    leaves = {
        'f32': rng.randn(3, 4).astype(np.float32),          # bin8
        'f64': rng.randn(40, 5),                            # bin16
        'i32': np.arange(-5, 7, dtype=np.int32),
        'i64': np.arange(20000, dtype=np.int64),            # bin32
        'bool': np.array([[True, False], [False, True]]),
        'empty_array': np.zeros((0, 3), np.float32),
        'scalar_f32': np.float32(2.5), 'scalar_i64': np.int64(-3),
        'scalar_bool': np.bool_(True), 'array_0d': np.asarray(7, np.int32),
        'chunked': rng.randn(60000).astype(np.float32),     # 2 chunks
        'masked': {}, 'nested': {'b': {}, 'a': {'z': np.ones(2)}},
        'python': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                   2 ** 32, 2 ** 63, -1, -32, -33, -128, -129, -32768,
                   -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0,
                   None, True, False, 'x' * 31, 'y' * 32, 'z' * 300,
                   'w' * 70000, list(range(16)), {str(i): i for i in
                                                   range(16)}],
    }
    return dict(leaves, bf16=bf_flax), dict(leaves, bf16=bf_port)


def _assert_same(port, flax_value, path='root'):
    """A tree the port restored against flax's, leaf by leaf, dtypes
    included; bf16 compared by bits."""
    if isinstance(flax_value, dict):
        assert isinstance(port, dict) and set(port) == set(flax_value), path
        for k in flax_value:
            _assert_same(port[k], flax_value[k], f'{path}/{k}')
    elif isinstance(flax_value, list):
        assert isinstance(port, list) and len(port) == len(flax_value), path
        for i, (a, b) in enumerate(zip(port, flax_value)):
            _assert_same(a, b, f'{path}/{i}')
    elif isinstance(flax_value, (np.ndarray, np.generic)) \
            and flax_value.dtype.name == 'bfloat16':
        assert isinstance(port, torch.Tensor), path
        assert port.dtype == torch.bfloat16, path
        assert tuple(port.shape) == flax_value.shape, path
        np.testing.assert_array_equal(
            port.reshape(-1).view(torch.int16).numpy(),
            np.asarray(flax_value).reshape(-1).view(np.int16), err_msg=path)
    elif isinstance(flax_value, (np.ndarray, np.generic)):
        assert type(port) is type(flax_value), path
        assert port.dtype == flax_value.dtype, path
        np.testing.assert_array_equal(port, flax_value, err_msg=path)
    else:
        assert type(port) is type(flax_value) and port == flax_value, path


def test_codec_matches_flax_both_ways(monkeypatch):
    monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', 200000)
    monkeypatch.setattr(codec, 'MAX_CHUNK_SIZE', 200000)
    flax_tree, port_tree = _trees()
    want = serialization.msgpack_serialize(flax_tree)
    got = codec.msgpack_serialize(port_tree)
    assert got == want
    # the leaves take every bin width, and one is chunked
    assert b'\xc4\x30' in want and b'\xc5\x06\x40' in want \
        and b'\xc6\x00\x02\x71\x00' in want
    assert codec.CHUNKED.encode() in want

    _assert_same(codec.msgpack_restore(want),
                 serialization.msgpack_restore(want))
    _assert_same(codec.msgpack_restore(bytearray(got)), flax_tree)
    back = serialization.msgpack_restore(got)
    np.testing.assert_array_equal(back['chunked'], flax_tree['chunked'])
    assert back['python'] == flax_tree['python']

    # a bf16 scalar restores as a 0-d tensor
    scalar = jnp.asarray(1.5, jnp.bfloat16)
    got = codec.msgpack_restore(serialization.msgpack_serialize(
        {'s': np.asarray(scalar)[()]}))['s']
    assert got.dtype == torch.bfloat16 and got.shape == () \
        and got.item() == 1.5


def test_codec_refuses_what_flax_checkpoints_do_not_hold():
    complex_ext = serialization.msgpack_serialize({'c': 1 + 2j})
    with pytest.raises(ValueError, match='ext type 2'):
        codec.msgpack_restore(complex_ext)
    with pytest.raises(ValueError, match='ext type 5'):
        codec.unpackb(b'\xd4\x05\x00')
    blob = codec.packb({'a': np.ones(3, np.float32)})
    with pytest.raises(ValueError, match='truncated'):
        codec.unpackb(blob[:-1])
    with pytest.raises(ValueError, match='extra data'):
        codec.unpackb(blob + b'\xc0')
    with pytest.raises(ValueError, match='not a type code'):
        codec.unpackb(b'\xc1')
    with pytest.raises(TypeError, match='set'):
        codec.packb({'a': {1, 2}})


def small_model_cfg():
    """``test_torch_train_step.py``'s model at depth 18: R18 + MVF, every
    label the optax state keeps, at a fraction of R50's compile and step
    time."""
    cfg = model_cfg({})
    cfg['backbone'] = dict(cfg['backbone'], depth=18)
    cfg['cls_head'] = dict(cfg['cls_head'], in_channels=512)
    return cfg


@pytest.fixture(scope='module')
def shapes():
    """The JAX recognizer's variables' shapes (``eval_shape``)."""
    jmodel = jax_build(small_model_cfg())
    return dict(jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3), jnp.float32),
        None, return_loss=False)))


def jax_template(shapes):
    """JAX recognizer variables of seeded numbers."""
    rng = np.random.RandomState(3)
    return jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


def test_jax_checkpoint_loads_into_the_port(shapes, tmp_path):
    variables = jax_template(shapes)
    path = str(tmp_path / 'epoch_3.msgpack')
    jax_save(path, variables, meta={'epoch': 3, 'iter': 12})
    state_dict, opt_state, meta = load_checkpoint(path)
    want = state_dict_from_jax(variables)
    assert list(state_dict) == list(want)
    for k, v in want.items():
        assert state_dict[k].dtype == v.dtype and torch.equal(
            state_dict[k], v), k
    assert meta == {'epoch': 3, 'iter': 12} and opt_state is None
    port = build_recognizer(dict(small_model_cfg()))
    port.load_state_dict(state_dict, strict=True)

    os.remove(path + '.meta.json')
    assert load_checkpoint(path)[2] == {}


def test_port_checkpoint_loads_into_jax(shapes, tmp_path):
    port = build_recognizer(dict(small_model_cfg()))
    port.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    state = port.state_dict()
    path = str(tmp_path / 'port.msgpack')
    save_msgpack_checkpoint(path, port, meta={'epoch': 1, 'iter': 4})
    assert not [f for f in os.listdir(tmp_path) if f.endswith('.tmp')]
    with open(path + '.meta.json') as f:
        assert json.load(f) == {'epoch': 1, 'iter': 4}

    variables_sd, opt_sd, meta = jax_load(path)
    assert opt_sd is None and meta == {'epoch': 1, 'iter': 4}
    template = jax_template(shapes)
    restored = {k: serialization.from_state_dict(template[k], variables_sd[k])
                for k in template}
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(template)
    entries = list(jax_entries(restored))
    assert len(entries) == sum(not k.endswith('num_batches_tracked')
                               for k in state)
    for _, jpath, name, value in entries:
        assert value.dtype == np.float32
        np.testing.assert_array_equal(value, state[name].numpy(),
                                      err_msg=jpath)
    # and the two layout maps invert each other
    back = state_dict_from_jax(jax_variables_from_state_dict(state))
    assert set(back) == set(state)
    assert all(torch.equal(back[k], v) for k, v in state.items())


@pytest.fixture
def f64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


def _port_step(state_dict, max_norm):
    port = build_recognizer(small_model_cfg(),
                            test_cfg=dict(average_clips=None)).double()
    port.load_state_dict(state_dict, strict=True)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 6)
    opt = build_optimizer(port, RECIPE, sched,
                          grad_clip=dict(max_norm=max_norm, norm_type=2))
    return port, opt, make_train_step(port, opt, sched, device='cpu')


def assert_state_close(port, jstate):
    ref = state_dict_from_jax(jstate.variables())
    ours = port.state_dict()
    for k, v in ref.items():
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-7,
                                       atol=1e-9, err_msg=k)


def test_resume_across_formats_continues_the_trajectory(f64, tmp_path):
    """JAX steps 0-1, JAX checkpoint; the port resumes for step 2 against
    JAX's own step 2, port checkpoint; JAX resumes for step 3 against the
    port's own step 3. The weights come from the port's init with
    randomized BN statistics, in f64; the frames are 32x32."""
    rng = np.random.RandomState(7)
    imgs = rng.randn(4, 2, 2, 32, 32, 3) * 0.5
    labels = rng.randint(0, 8, size=(4, 2))
    max_norm = 2.0
    cfg = small_model_cfg()
    init = build_recognizer(dict(cfg)).double()
    init.init_weights(torch.Generator().manual_seed(0), randomize_bn=True)
    variables = jax_variables_from_state_dict(init.state_dict())
    jsched = jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 6)
    tx = jax_optim.build_optimizer(
        variables['params'], RECIPE, jsched,
        grad_clip=dict(max_norm=max_norm, norm_type=2))
    jstep = jax_train_step(jax_build(cfg, test_cfg=dict(average_clips=None)),
                           tx, mesh=None, donate=False)

    def jax_steps(state, steps):
        rows = []
        for t in steps:
            state, m = jstep(state, jnp.asarray(imgs[t]),
                             jnp.asarray(labels[t]), jax.random.PRNGKey(t))
            rows.append((float(m['loss']), float(m['grad_norm'])))
        return state, rows

    def port_steps(step, steps):
        return [(m['loss'].item(), m['grad_norm'].item())
                for m in (step(imgs[t], labels[t]) for t in steps)]

    jstate, _ = jax_steps(TrainState.create(variables, tx), [0, 1])
    jpath = str(tmp_path / 'jax.msgpack')
    jax_save(jpath, jstate.variables(), opt_state=jstate.opt_state,
             meta={'epoch': 1, 'iter': 2})

    state_dict, opt_state, meta = load_checkpoint(jpath)
    port, opt, step = _port_step(state_dict, max_norm)
    load_optax_state(port, opt, opt_state, meta['iter'])
    step.state.step = meta['iter']
    assert len(opt.state) == sum(len(g['params']) for g in opt.param_groups)
    got = port_steps(step, [2])
    jstate, want = jax_steps(jstate, [2])
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # step 2's update used the momentum carried from JAX
    assert_state_close(port, jstate)

    ppath = str(tmp_path / 'port.msgpack')
    save_msgpack_checkpoint(ppath, port, opt, meta={'epoch': 2, 'iter': 3})
    variables_sd, opt_sd, meta = jax_load(ppath)
    resumed = TrainState(
        params=serialization.from_state_dict(jstate.params,
                                             variables_sd['params']),
        batch_stats=serialization.from_state_dict(
            jstate.batch_stats, variables_sd['batch_stats']),
        opt_state=serialization.from_state_dict(jstate.opt_state, opt_sd),
        step=jnp.asarray(meta['iter'], jnp.int32))
    resumed, want = jax_steps(resumed, [3])
    got = port_steps(step, [3])
    np.testing.assert_allclose(want, got, rtol=1e-9)
    # and step 3's, the momentum carried from the port
    assert_state_close(port, resumed)
    # what the port writes has the structure of the JAX chain's state
    assert jax.tree_util.tree_structure(
        serialization.to_state_dict(jstate.opt_state)) == \
        jax.tree_util.tree_structure(optax_state_from_optimizer(port, opt, 4))


@pytest.mark.parametrize('recipe', ['no_clip', 'no_decay', 'no_momentum',
                                    'norm_decay_0', 'frozen_stem'])
def test_optax_layout_follows_the_recipe(shapes, recipe):
    """The optax state the port writes has the JAX chain's structure for
    recipes that move or drop a state: no clip, no weight decay, no
    momentum, a label without decay, frozen parameters; and reads back."""
    optimizer = dict(RECIPE)
    grad_clip = dict(max_norm=2.0, norm_type=2)
    frozen = ()
    if recipe == 'no_clip':
        grad_clip = None
    elif recipe == 'no_decay':
        optimizer['weight_decay'] = 0.0
    elif recipe == 'no_momentum':
        optimizer.update(momentum=0.0, nesterov=False)
    elif recipe == 'norm_decay_0':
        optimizer['paramwise_options'] = dict(norm_decay_mult=0.0)
    else:
        frozen = ('backbone.conv1.', 'backbone.bn1.')
    variables = jax_template(shapes)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, 6)
    tx = jax_optim.build_optimizer(
        variables['params'], optimizer, sched, grad_clip=grad_clip,
        frozen_prefixes=tuple(p.replace('backbone.', 'backbone_mod/')
                              .rstrip('.') for p in frozen))
    want = serialization.to_state_dict(tx.init(variables['params']))

    port = build_recognizer(dict(small_model_cfg()))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    opt = build_optimizer(port, optimizer, sched, grad_clip=grad_clip,
                          frozen_prefixes=frozen)
    got = optax_state_from_optimizer(port, opt, 0)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    load_optax_state(port, opt, got, 0)
    momentum = optimizer.get('momentum', 0.0)
    assert len(opt.state) == (sum(len(g['params']) for g in opt.param_groups)
                              if momentum else 0)
    with pytest.raises(ValueError, match='counts 0 steps'):
        load_optax_state(port, opt, got, 3)
    other = optax_state_from_optimizer(
        port, build_optimizer(port, dict(optimizer, weight_decay=0.5
                                         if recipe == 'no_decay' else 0.0),
                              sched, grad_clip=grad_clip,
                              frozen_prefixes=frozen), 0)
    with pytest.raises(ValueError, match='layout'):
        load_optax_state(port, opt, other, 0)
