"""Port parity: the JAX package's Orbax step directories, read and written
without orbax.

- ``utils/zstd.py`` against ``zstandard`` at levels 1, 3, 9 and 19, with
  and without the content checksum, on float32 weights, text and random
  bytes, and on the chunks tensorstore itself wrote into a JAX checkpoint;
  its raw-block frames read back by ``zstandard``.
- ``utils/ocdbt.py`` against tensorstore's own reads of OCDBT stores with
  many commits, a B-tree of four levels, inline and out-of-line values and
  zstd-compressed nodes; its crc32c against ``google_crc32c``.
- The flagship's state (R50+MVF 8x8, 400 classes: its depth-50 tree of
  parameters and statistics, each dimension above 8 cut to an eighth, and
  the SGD momentum of two torch steps of the recipe: 956 leaves
  with the optax state): the JAX package's ``save_checkpoint_orbax``
  (OCDBT) read by the port's ``load_checkpoint_orbax``, the port's
  ``save_checkpoint_orbax`` read by the JAX package's
  ``load_checkpoint_orbax``, both bit for bit, weights and momentum, and
  both equal to what the ``.msgpack`` path gives.
- The committed fixture (``tests/golden/orbax/step_7`` written by the JAX
  package from R18+MVF's state at 1/32 of its width with two steps'
  momentum, and its ``.msgpack`` twin; ``chip_smoke.py`` phase 13 reads
  them on the card) is what ``write_golden`` writes today.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import google_crc32c
import tensorstore as ts
import zstandard

from mvfnet_tpu.utils import checkpoint as jax_ckpt
from mvfnet_tpu_torch.engine.optim import build_optimizer
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.utils import ocdbt, orbax_io, zstd
from mvfnet_tpu_torch.utils.checkpoint import (
    jax_variables_from_state_dict, load_checkpoint, load_checkpoint_orbax,
    load_optax_state, optax_state_from_optimizer, save_checkpoint_orbax,
    save_msgpack_checkpoint)

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
GOLDEN_STEP = 7
RECIPE = dict(type='SGD', lr=0.01, momentum=0.9, weight_decay=1e-4,
              nesterov=True)


def _samples():
    rs = np.random.RandomState(0)
    text = open(os.path.join(os.path.dirname(__file__), '..', 'README.md'),
                'rb').read()[:40000]
    return {'float32': (rs.randn(12000) * 0.05).astype(np.float32).tobytes(),
            'text': text, 'random': rs.bytes(30000)}


@pytest.mark.parametrize('checksum', [False, True])
@pytest.mark.parametrize('level', [1, 3, 9, 19])
@pytest.mark.parametrize('kind', ['float32', 'text', 'random'])
def test_zstd_matches_zstandard(kind, level, checksum):
    data = _samples()[kind]
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=level != 9
                                     ).compress(data)
    assert zstd.decompress(frame) == data
    raw = zstd.compress_raw(data)
    assert zstandard.ZstdDecompressor().decompress(raw) == data
    assert zstd.decompress(raw) == data
    if checksum:        # a damaged checksum is refused
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:-1] + bytes([frame[-1] ^ 1]))


def test_zstd_edge_frames():
    for data in (b'', b'x', bytes(300000), b'ab' * 70000):
        assert zstd.decompress(zstd.compress_raw(data)) == data
        assert zstd.decompress(zstandard.ZstdCompressor(level=3).compress(
            data)) == data
    two = (zstandard.ZstdCompressor().compress(b'first')
           + b'\x50\x2a\x4d\x18\x03\x00\x00\x00abc'           # skippable
           + zstd.compress_raw(b'second'))
    assert zstd.decompress(two) == b'firstsecond'
    for bad in (b'\x00\x01\x02\x03', zstd.compress_raw(b'abc')[:-1]):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bad)


def test_crc32c_matches_google():
    rs = np.random.RandomState(1)
    for n in (0, 1, 7, 100, 4097):
        data = rs.bytes(n)
        assert ocdbt.crc32c(data) == google_crc32c.value(data)


def _ts_reads(root):
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{root}/'}).result()
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


def test_ocdbt_reader_matches_tensorstore(tmp_path):
    """Stores whose B-trees grow past one node: small nodes, 20 commits
    (versions past the manifest's inline ones), values both inline and in
    data files, zstd and uncompressed nodes."""
    rs = np.random.RandomState(2)
    for name, config in (('zstd', {'max_decoded_node_bytes': 2000,
                                   'max_inline_value_bytes': 100}),
                         ('raw', {'max_decoded_node_bytes': 300,
                                  'max_inline_value_bytes': 20,
                                  'compression': None})):
        root = str(tmp_path / name)
        kv = ts.KvStore.open({'driver': 'ocdbt', 'base': f'file://{root}/',
                              'config': config}).result()
        for commit in range(20):
            with ts.Transaction() as txn:
                for i in range(50):
                    kv.with_transaction(txn).write(
                        f'params.layer{commit}.b{i}/0.0',
                        rs.bytes(rs.randint(1, 300))).result()
        store = ocdbt.Store(root)
        want = _ts_reads(root)
        assert len(want) == 1000
        assert {k: store.get(k) for k in store.keys()} == want
    with pytest.raises(ocdbt.OcdbtError, match='crc32c'):
        data = bytearray(open(os.path.join(root, 'manifest.ocdbt'),
                              'rb').read())
        data[20] ^= 1
        ocdbt.decode_file(bytes(data), ocdbt.MANIFEST_MAGIC)


def _narrow(model, by):
    """Every dimension of every parameter and buffer above ``by`` cut to
    1/``by`` of it: the model's tree at a narrow width (not a network that
    runs: its state alone is what the checkpoints carry)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if t.dim():
                t.data = t.data[tuple(slice(0, d // by if d > by else d)
                                      for d in t.shape)].clone()


def flagship_state(by=8, seed=0, depth=50):
    """The flagship's recognizer (R50+MVF 8x8, 400 classes; or at another
    ``depth``) narrowed by ``by``, and its recipe's SGD after two steps on
    seeded gradients."""
    model = build_recognizer(dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=depth, out_indices=(3,),
                      norm_eval=False),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=0.5,
                      in_channels=2048 if depth >= 50 else 512,
                      num_classes=400),
        module_cfg=dict(type='MVF', n_segment=8, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW')))
    model.init_weights(torch.Generator().manual_seed(seed),
                       randomize_bn=True)
    _narrow(model, by)
    opt = build_optimizer(model, dict(RECIPE), lambda step: RECIPE['lr'],
                          grad_clip=dict(max_norm=40.0))
    rs = np.random.RandomState(seed)
    for _ in range(2):
        for p in model.parameters():
            p.grad = torch.from_numpy(rs.randn(*p.shape).astype(np.float32))
        opt.step()
    return model, opt


def _assert_trees_equal(got, want, path='root'):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f'{path}/{k}')
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


def _count_leaves(tree):
    return sum(_count_leaves(v) if isinstance(v, dict) and v else 1
               for v in tree.values())


def _assert_state_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_orbax_both_ways_bit_for_bit(tmp_path):
    model, opt = flagship_state()
    meta = {'epoch': 1, 'iter': 2}
    variables = jax_variables_from_state_dict(model.state_dict())
    opt_state = optax_state_from_optimizer(model, opt, 2)
    assert _count_leaves(variables) + _count_leaves(opt_state) == 956

    # the JAX package writes (OCDBT), the port reads
    jdir = str(tmp_path / 'jax')
    jax_ckpt.save_checkpoint_orbax(jdir, variables, opt_state, meta, step=2)
    assert json.load(open(os.path.join(jdir, 'step_2', '_METADATA')))[
        'use_ocdbt']
    sd, got_opt, got_meta = load_checkpoint_orbax(jdir, 2)
    assert got_meta == meta
    want_sd = {k: v for k, v in model.state_dict().items()
               if not k.endswith('num_batches_tracked')}
    _assert_state_equal({k: sd[k] for k in want_sd}, want_sd)
    _assert_trees_equal(got_opt, opt_state)

    # the same tree through the .msgpack path
    msgpack = str(tmp_path / 'ckpt.msgpack')
    save_msgpack_checkpoint(msgpack, model, opt, meta)
    m_sd, m_opt, m_meta = load_checkpoint(msgpack)
    _assert_state_equal(sd, m_sd)
    _assert_trees_equal(got_opt, m_opt)
    assert m_meta == meta

    # the port writes (one file a key), the JAX package reads
    pdir = str(tmp_path / 'port')
    nbytes = save_checkpoint_orbax(pdir, model, opt, meta, step=2)
    assert nbytes == sum(v.nbytes for v in want_sd.values()) + sum(
        p.numel() * 4 for p in model.parameters()) \
        + 4 * len(opt.label_weight_decay)           # and each label's count
    assert not [f for f in os.listdir(pdir) if 'tmp' in f]
    j_vars, j_opt, j_meta = jax_ckpt.load_checkpoint_orbax(pdir, 2)
    assert j_meta == meta
    _assert_trees_equal(j_vars, variables)
    _assert_trees_equal(j_opt, opt_state)
    # and the port reads its own write, and resumes the momentum
    sd2, opt2, _ = load_checkpoint_orbax(pdir, 2)
    _assert_state_equal(sd2, sd)
    fresh, fresh_opt = flagship_state(seed=1)
    fresh.load_state_dict(sd2, strict=False)
    load_optax_state(fresh, fresh_opt, opt2, 2)
    for p, q in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(opt.state[p]['momentum_buffer'],
                           fresh_opt.state[q]['momentum_buffer'])
    # an empty optimizer state is saved as orbax saves an empty dict
    save_checkpoint_orbax(pdir, model, None, meta, step=3)
    tree = json.load(open(os.path.join(pdir, 'step_3', '_METADATA')))
    assert tree['tree_metadata']["('opt_state',)"]['value_metadata'] == {
        'value_type': 'Dict', 'skip_deserialize': True}
    assert jax_ckpt.load_checkpoint_orbax(pdir, 3)[1] is None
    assert load_checkpoint_orbax(pdir, 3)[1] is None


def write_golden(root, step=GOLDEN_STEP):
    """The committed fixture: the flagship's recognizer at depth 18 (a
    fixture under 1 MB: 40% of R50's keys) narrowed by 32,
    with two SGD steps' momentum, written by the JAX package as an Orbax step
    directory ``root/orbax/step_{step}`` and as its ``.msgpack`` twin
    ``root/orbax_twin.msgpack`` (each with its ``.meta.json``)."""
    model, opt = flagship_state(by=32, depth=18)
    meta = {'epoch': 1, 'iter': 2}
    variables = jax_variables_from_state_dict(model.state_dict())
    opt_state = optax_state_from_optimizer(model, opt, 2)
    jax_ckpt.save_checkpoint_orbax(os.path.join(root, 'orbax'), variables,
                                   opt_state, meta, step=step)
    jax_ckpt.save_checkpoint(os.path.join(root, 'orbax_twin.msgpack'),
                             variables, opt_state, meta)


def test_golden_fixture_is_current(tmp_path):
    write_golden(str(tmp_path))
    for root in (GOLDEN, str(tmp_path)):
        sd, opt_state, meta = load_checkpoint_orbax(
            os.path.join(root, 'orbax'), GOLDEN_STEP)
        t_sd, t_opt, t_meta = load_checkpoint(
            os.path.join(root, 'orbax_twin.msgpack'))
        _assert_state_equal(sd, t_sd)
        _assert_trees_equal(opt_state, t_opt)
        assert meta == t_meta == {'epoch': 1, 'iter': 2}
    new = load_checkpoint_orbax(os.path.join(str(tmp_path), 'orbax'),
                                GOLDEN_STEP)
    old = load_checkpoint_orbax(os.path.join(GOLDEN, 'orbax'), GOLDEN_STEP)
    _assert_state_equal(old[0], new[0])
    _assert_trees_equal(old[1], new[1])
    with open(os.path.join(GOLDEN, 'orbax_twin.msgpack'), 'rb') as a, \
            open(os.path.join(str(tmp_path), 'orbax_twin.msgpack'),
                 'rb') as b:
        assert a.read() == b.read()
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(GOLDEN) for f in fs
               if 'orbax' in d or f.startswith('orbax'))
    assert size < 1 << 20


def test_tensorstore_chunks_decode(tmp_path):
    """The zstd frames tensorstore wrote into a JAX checkpoint decode as
    ``zstandard`` decodes them."""
    store = ocdbt.Store(os.path.join(GOLDEN, 'orbax', f'step_{GOLDEN_STEP}'))
    chunks = [k for k in store.keys() if not k.endswith('.zarray')]
    assert len(chunks) > 200
    for k in chunks:
        data = store.get(k)
        assert data[:4] == b'\x28\xb5\x2f\xfd'          # a zstd frame
        assert zstd.decompress(data) == \
            zstandard.ZstdDecompressor().decompressobj().decompress(data)


def test_jax_array_leaves_read(tmp_path):
    """Leaves the JAX package saves as ``jax.Array`` (what its train loop
    holds) read as the numpy leaves do."""
    import jax.numpy as jnp
    variables = {'params': {'w': jnp.arange(6.).reshape(2, 3),
                            'b': jnp.ones((70, 33), jnp.float32)}}
    opt_state = {'count': jnp.asarray(3, jnp.int32), 'empty': {}}
    jax_ckpt.save_checkpoint_orbax(str(tmp_path), variables, opt_state,
                                   {'epoch': 1}, step=1)
    tree = orbax_io.load_pytree(str(tmp_path / 'step_1'))
    _assert_trees_equal(tree, {
        'variables': {k: {n: np.asarray(a) for n, a in v.items()}
                      for k, v in variables.items()},
        'opt_state': {'count': np.asarray(3, np.int32), 'empty': {}}})


def test_orbax_io_refuses_what_it_does_not_read(tmp_path):
    path = str(tmp_path / 'step_0')
    orbax_io.save_pytree(path, {'a': {'b': np.arange(3, dtype=np.int32)},
                                'c': {}})
    assert orbax_io.load_pytree(path)['c'] == {}
    meta = json.load(open(os.path.join(path, '_METADATA')))
    meta['use_zarr3'] = True
    json.dump(meta, open(os.path.join(path, '_METADATA'), 'w'))
    with pytest.raises(orbax_io.OrbaxError, match='zarr3'):
        orbax_io.load_pytree(path)
    with pytest.raises(orbax_io.OrbaxError, match='dtype'):
        orbax_io.save_pytree(path, {'s': np.array(['x'])})
    shutil.rmtree(path)
