"""Port parity: the train loop, its ``.pth`` checkpoints, the train CLI and
the non-strict weight importer.

The data are the JAX engine tests' (``tests/test_engine.py``): 4 rawframe
videos of 8 JPEGs of 48x48, 2 classes, ``RandomResizedCrop`` 32, two videos
a batch, so 2 iterations an epoch. The model is R18 + MVF at T=2, as the
JAX engine tests build it: the loop's semantics do not depend on the
depth. The importer cases build R50 + MVF, the vocabulary of the released
and torchvision checkpoints.

- The port's ``train_network(validate=True)`` against the JAX package's on
  one device, 2 epochs with the recipe (SGD nesterov, wd 1e-4, clip at 40,
  a linear warmup of 2 iterations, a milestone at epoch 1), dropout 0,
  evaluating after each epoch. Both start from the JAX loop's initial
  variables in f64: a hook before the run rebuilds the JAX loop's state
  with ``TrainState.create`` and loads the same variables into the port
  through ``state_dict_from_jax``. The loader's frames are float32 on both
  sides and both models compute in their parameters' dtype (``dtype=None``),
  so the first convolution of each promotes them to f64. Per-iteration
  losses, grad norms and LRs agree at rtol 1e-9, the evaluations' top-1/5
  are equal, and the final parameters and BN statistics agree at rtol 1e-7
  / atol 1e-9 (``tests/test_train_trajectory_parity.py``'s tolerances).
- A run resumed from ``epoch_1.pth`` equals the unbroken run exactly on the
  CPU, dropout 0.5 included: the masks come from ``(seed + 1, step)``; so
  does one resumed from the same state written as a ``.msgpack``.
- A saved ``.pth`` has mmcv's layout, imports into the JAX package with an
  empty report and the port's values, and the port's test CLI scores it.
- ``import_torch_state_dict`` gives ``import_torch_weights``'s report and
  weights, mapped through ``jax_entries``, on five kinds of state dict.
- The train CLI as a subprocess on the CPU, with a resume; the
  TensorBoard hook with and without ``torch.utils.tensorboard``.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mvfnet_tpu.data as jdata
from mvfnet_tpu.config import Config as JaxConfig
from mvfnet_tpu.engine.train_loop import Hook as JaxHook
from mvfnet_tpu.engine.train_loop import train_network as jax_train_network
from mvfnet_tpu.engine.train_step import TrainState
from mvfnet_tpu.models import build_recognizer as jax_build
from mvfnet_tpu.parallel import make_mesh
from mvfnet_tpu.parallel.mesh import replicate
from mvfnet_tpu.utils.checkpoint import import_torch_weights
from mvfnet_tpu.utils.checkpoint import save_checkpoint as jax_save
from mvfnet_tpu.utils.checkpoint import \
    load_torch_state_dict as jax_load_torch_state_dict
from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.data import build_dataset
from mvfnet_tpu_torch.engine.train_loop import (Hook, TensorboardLoggerHook,
                                                TrainLoop, train_network)
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.models.builder import build_backbone
from mvfnet_tpu_torch.tools import test_recognizer as test_cli
from mvfnet_tpu_torch.tools import train_recognizer as train_cli
from mvfnet_tpu_torch.utils.checkpoint import (
    import_torch_state_dict, jax_entries, jax_variables_from_state_dict,
    load_checkpoint, load_torch_state_dict, save_msgpack_checkpoint,
    state_dict_from_jax)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
T, CROP, NUM_CLASSES = 2, 32, 2
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)
LOG_LINE = re.compile(
    r'Epoch \[(\d+)\]\[(\d+)/(\d+)\] lr: \d+\.\d{5}, time: \d+\.\d{3}s/iter, '
    r'loss_cls: \d+\.\d{4}, loss: \d+\.\d{4}, grad_norm: \d+\.\d{4}$', re.M)


def model_cfg(dropout=0.0, modality='RGB', pretrained=None, depth=18):
    return dict(
        type='Recognizer2D', modality=modality,
        backbone=dict(type='ResNet', depth=depth, out_indices=(3,),
                      norm_eval=False, pretrained=pretrained,
                      norm_cfg=dict(type='BN', requires_grad=True)),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=dropout,
                      in_channels=512 if depth < 50 else 2048, init_std=0.01,
                      num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'))


def dataset_cfg(root, ann, test_mode):
    crop = (dict(type='CenterCrop', crop_size=CROP) if test_mode
            else dict(type='RandomResizedCrop', input_size=CROP))
    return dict(
        type='RawFramesDataset', ann_file=str(ann), data_root=str(root),
        test_mode=test_mode, modality='RGB', filename_tmpl='img_{:05}.jpg',
        pipeline=[
            dict(type='SampleFrames', clip_len=T, frame_interval=2,
                 num_clips=1),
            dict(type='FrameSelector'), crop,
            dict(type='Normalize', **NORM),
            dict(type='FormatShape', input_format='NHWC'),
            dict(type='Collect', keys=['img_group', 'label'], meta_keys=[]),
        ])


def config_text(root, ann, work_dir, dropout=0.0, pretrained=None,
                depth=18):
    """A config file for both packages: the recipe at the tiny geometry."""
    val = dataset_cfg(root, ann, True)
    return '\n'.join([
        f'model = {model_cfg(dropout, pretrained=pretrained, depth=depth)!r}',
        "test_cfg = dict(average_clips='prob')",
        f'data = dict(videos_per_gpu=2, workers_per_gpu=2, '
        f'train={dataset_cfg(root, ann, False)!r}, val={val!r}, '
        f'test={val!r})',
        'optimizer = dict(type="SGD", lr=0.01, momentum=0.9, '
        'weight_decay=1e-4, nesterov=True)',
        'optimizer_config = dict(grad_clip=dict(max_norm=40, norm_type=2))',
        'lr_config = dict(policy="step", step=[1], warmup="linear", '
        'warmup_iters=2, warmup_ratio=0.1)',
        'checkpoint_config = dict(interval=1)',
        'log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook")])',
        'total_epochs = 2', 'eval_interval = 1', "log_level = 'INFO'",
        f'work_dir = {str(work_dir)!r}', ''])


@pytest.fixture(scope='module')
def tiny_data(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp('train_loop_data')
    rng = np.random.RandomState(5)
    lines = []
    for v in range(4):
        d = root / f'v{v}'
        d.mkdir()
        for f in range(8):
            cv2.imwrite(str(d / f'img_{f + 1:05}.jpg'),
                        rng.randint(0, 255, (48, 48, 3), np.uint8))
        lines.append(f'v{v} 8 {v % 2}')
    ann = root / 'ann.txt'
    ann.write_text('\n'.join(lines) + '\n')
    return root, ann


def write_config(tmp_path, tiny_data, name='cfg.py', **kwargs):
    path = tmp_path / name
    path.write_text(config_text(*tiny_data, tmp_path / 'work', **kwargs))
    return str(path)


@pytest.fixture
def f64():
    jax.config.update('jax_enable_x64', True)
    yield
    jax.config.update('jax_enable_x64', False)


class Record(Hook):
    """Per-iteration (loss, grad norm, lr) of the port's loop."""

    def __init__(self):
        self.rows = []

    def after_iter(self, loop, metrics):
        self.rows.append((metrics['loss'].item(),
                          metrics['grad_norm'].item(), metrics['lr']))


def test_train_loop_matches_jax(f64, tiny_data, tmp_path):
    config = write_config(tmp_path, tiny_data)
    jcfg = JaxConfig.fromfile(config)
    jcfg.work_dir = str(tmp_path / 'jax')
    variables, want = {}, []

    class F64State(JaxHook):
        def before_run(self, loop):
            variables.update(jax.tree_util.tree_map(
                lambda v: np.asarray(v, np.float64), loop.state.variables()))
            loop.state = replicate(TrainState.create(variables, loop.tx),
                                   loop.mesh)

    class JaxRecord(JaxHook):
        def after_iter(self, loop, metrics):
            want.append((float(metrics['loss']), float(metrics['grad_norm']),
                         float(loop.lr_schedule(loop.state.step - 1))))

    jmodel = jax_build(dict(jcfg.model, dtype=None),
                       test_cfg=dict(jcfg.test_cfg))
    jloop = jax_train_network(
        jmodel, jdata.build_dataset(dict(jcfg.data['train'])), jcfg,
        validate=True, mesh=make_mesh(jax.devices()[:1]),
        extra_hooks=[F64State(), JaxRecord()])

    cfg = Config.fromfile(config)
    cfg.work_dir = str(tmp_path / 'port')

    class LoadF64(Hook):
        def before_run(self, loop):
            loop.model.load_state_dict(state_dict_from_jax(variables),
                                       strict=True)

    record = Record()
    model = build_recognizer(dict(cfg.model, dtype=None),
                             test_cfg=cfg.test_cfg).double()
    loop = train_network(model, build_dataset(dict(cfg.data['train'])), cfg,
                         validate=True, device='cpu',
                         extra_hooks=[LoadF64(), record])

    assert len(want) == 4 and loop.step == 4
    np.testing.assert_allclose(record.rows, want, rtol=1e-9)
    lrs = [r[2] for r in want]
    assert lrs[0] < lrs[1] and lrs[2] < lrs[1]      # warmup, then milestone
    assert [{k: e[k] for k in ('epoch', 'top1', 'top5')}
            for e in loop.eval_history] == jloop.eval_history
    assert [e['epoch'] for e in loop.eval_history] == [1, 2]
    ref = state_dict_from_jax(jloop.state.variables())
    ours = loop.model.state_dict()
    assert set(ref) == set(ours)
    for k, v in ref.items():
        if not k.endswith('num_batches_tracked'):
            np.testing.assert_allclose(ours[k].numpy(), v.numpy(), rtol=1e-7,
                                       atol=1e-9, err_msg=k)


@pytest.fixture(scope='module')
def trained(tiny_data, tmp_path_factory):
    """The port's loop in float32 on the CPU, dropout 0.5, 2 epochs with a
    checkpoint after each; its config file, per-iteration metrics, final
    state and SGD momentum buffers."""
    tmp = tmp_path_factory.mktemp('trained')
    config = write_config(tmp, tiny_data, dropout=0.5)
    cfg = Config.fromfile(config)
    record = Record()
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    loop = train_network(model, build_dataset(dict(cfg.data['train'])), cfg,
                         device='cpu', extra_hooks=[record])
    momentum = [loop.optimizer.state[p]['momentum_buffer'].clone()
                for g in loop.optimizer.param_groups for p in g['params']]
    return dict(config=config, work_dir=cfg.work_dir, rows=record.rows,
                state=model.state_dict(), momentum=momentum, loop=loop)


def test_resume_equals_unbroken_run(trained, tmp_path):
    for name in ('epoch_1.pth', 'epoch_2.pth', 'latest.pth'):
        assert os.path.exists(os.path.join(trained['work_dir'], name)), name
    cfg = Config.fromfile(trained['config'])
    cfg.work_dir = str(tmp_path / 'resumed')
    cfg.resume_from = os.path.join(trained['work_dir'], 'epoch_1.pth')
    record = Record()
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train'])), cfg,
                     device='cpu')
    assert (loop.epoch, loop.step, loop.iter) == (1, 2, 2)
    loop.register_hook(record)
    loop.run()
    assert record.rows == trained['rows'][2:]
    assert trained['rows'][0][0] != trained['rows'][2][0]
    state = model.state_dict()
    for k, v in trained['state'].items():
        assert torch.equal(state[k], v), k
    momentum = [loop.optimizer.state[p]['momentum_buffer']
                for g in loop.optimizer.param_groups for p in g['params']]
    assert len(momentum) == len(trained['momentum'])
    assert all(torch.equal(a, b) for a, b in zip(momentum,
                                                 trained['momentum']))


def test_resume_from_msgpack_equals_unbroken_run(trained, tmp_path):
    """The state after epoch 1, written as the JAX package's ``.msgpack``
    (weights, optax momentum traces, the sidecar's epoch and iter),
    resumes the loop to the unbroken run's epoch 2 exactly; ``load_from``
    takes the weights alone."""
    cfg = Config.fromfile(trained['config'])
    cfg.resume_from = os.path.join(trained['work_dir'], 'epoch_1.pth')
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train'])), cfg,
                     device='cpu')
    path = str(tmp_path / 'epoch_1.msgpack')
    save_msgpack_checkpoint(path, loop.model, loop.optimizer,
                            meta={'epoch': loop.epoch, 'iter': loop.step})

    cfg.resume_from = path
    cfg.work_dir = str(tmp_path / 'resumed')
    record = Record()
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train'])), cfg,
                     device='cpu')
    assert (loop.epoch, loop.step, loop.iter) == (1, 2, 2)
    loop.register_hook(record)
    loop.run()
    assert record.rows == trained['rows'][2:]
    state = model.state_dict()
    # the JAX layout keeps no num_batches_tracked (BN uses its momentum)
    for k, v in trained['state'].items():
        assert torch.equal(state[k], v) or k.endswith(
            'num_batches_tracked'), k
    momentum = [loop.optimizer.state[p]['momentum_buffer']
                for g in loop.optimizer.param_groups for p in g['params']]
    assert all(torch.equal(a, b) for a, b in zip(momentum,
                                                 trained['momentum']))

    cfg.resume_from = None
    cfg.load_from = path
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train'])), cfg,
                     device='cpu')
    assert (loop.epoch, loop.step) == (0, 0) and not loop.optimizer.state
    want = load_checkpoint(path)[0]
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items()
               if not k.endswith('num_batches_tracked'))


def test_dropout_masks_follow_the_step():
    """With dropout 0.5 the per-step generator matters: two steps of one
    batch from one state but different step counts draw different masks."""
    from mvfnet_tpu_torch.engine.train_step import dropout_seed
    assert dropout_seed(0, 3) == dropout_seed(0, 3)
    assert len({dropout_seed(s, t) for s in range(3) for t in range(3)}) == 9
    x = torch.ones(64)
    masks = [torch.rand(x.shape, generator=torch.Generator().manual_seed(
        dropout_seed(0, t))) for t in (0, 1)]
    assert not torch.equal(*masks)


def jax_template(modality='RGB', depth=18):
    """The JAX recognizer's variables, shaped by ``eval_shape`` and filled
    with seeded numbers."""
    jmodel = jax_build(dict(model_cfg(modality=modality, depth=depth),
                            dtype=None))
    c = 10 if modality == 'Flow' else 3
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, T, CROP, CROP, c), jnp.float32),
                            None, return_loss=False))
    rng = np.random.RandomState(0)
    return jax.tree_util.tree_map(
        lambda s: (rng.rand(*s.shape) + 0.5).astype(np.float32),
        dict(shapes))


def test_saved_pth_layout_imports_into_jax_and_scores(trained, tmp_path):
    path = os.path.join(trained['work_dir'], 'latest.pth')
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    assert set(ckpt) == {'meta', 'state_dict', 'optimizer'}
    assert ckpt['meta'] == {'epoch': 2, 'iter': 4}
    state = trained['state']
    assert list(ckpt['state_dict']) == list(state)
    assert all(torch.equal(ckpt['state_dict'][k], v)
               for k, v in state.items())
    opt = trained['loop'].optimizer
    assert set(ckpt['optimizer']) == {'state', 'param_groups'}
    assert len(ckpt['optimizer']['state']) == sum(
        len(g['params']) for g in opt.param_groups)
    assert [g['label'] for g in ckpt['optimizer']['param_groups']] == \
        [g['label'] for g in opt.param_groups]

    back, report = import_torch_weights(jax_load_torch_state_dict(path),
                                        jax_template(), return_report=True)
    assert (report['missing'], report['unexpected'],
            report['mismatched']) == ([], [], [])
    entries = list(jax_entries(back))
    assert len(entries) == sum(not k.endswith('num_batches_tracked')
                               for k in state)
    for _, jpath, name, value in entries:
        np.testing.assert_array_equal(value, state[name].numpy(),
                                      err_msg=jpath)

    out = tmp_path / 'scores.pkl'
    result = test_cli.main([trained['config'], path, '--device', 'cpu',
                            '--out', str(out)])
    assert out.exists() and result['scores'].shape == (4, NUM_CLASSES)
    np.testing.assert_allclose(result['scores'].sum(1), 1.0, rtol=1e-5)


def _random_like(named_shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
            if not k.endswith('num_batches_tracked')
            else torch.tensor(7) for k, s in named_shapes.items()}


def _torchvision_r50(seed):
    """A torchvision ResNet-50 state dict: the port's plain ResNet-50 names
    without ``backbone.``, num_batches_tracked, and ``fc.*``."""
    names = {k: tuple(v.shape) for k, v in build_backbone(
        dict(type='ResNet', depth=50)).state_dict().items()}
    names.update({'fc.weight': (1000, 2048), 'fc.bias': (1000,)})
    return _random_like(names, seed)


def _source(case):
    port = build_recognizer(dict(model_cfg(depth=50), dtype=None))
    shapes = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    if case == 'reference_module_prefix':
        sd = _random_like(shapes, 1)
        return {'module.' + k: v for k, v in sd.items()
                if not k.endswith('num_batches_tracked')}
    if case == 'head_aliases':
        sd = _random_like({k: s for k, s in shapes.items()
                           if k.startswith('backbone.layer4.')}, 2)
        sd['cls_head.new_cls.weight'] = torch.full((NUM_CLASSES, 2048), 0.5)
        sd['cls_head.fc_cls.bias'] = torch.full((NUM_CLASSES,), -0.25)
        return sd
    if case in ('torchvision', 'flow_inflation'):
        return _torchvision_r50(3)
    assert case == 'mismatch_and_unknown'
    sd = _random_like({k: s for k, s in shapes.items()
                       if k.startswith('backbone.layer1.')}, 4)
    sd['backbone.layer1.0.conv2.weight'] = torch.zeros(64, 64, 1, 1)
    sd['backbone.layer9.0.conv1.weight'] = torch.zeros(8, 8, 1, 1)
    sd['cls_head.segmental_consensus.classifier.1.weight'] = torch.zeros(2)
    return sd


@pytest.mark.parametrize('case', ['reference_module_prefix', 'head_aliases',
                                  'torchvision', 'mismatch_and_unknown',
                                  'flow_inflation'])
def test_importer_matches_jax(case, tmp_path):
    flow = case == 'flow_inflation'
    inflate = 10 if flow else None
    path = str(tmp_path / 'source.pth')
    torch.save({'state_dict': _source(case)}, path)
    variables = jax_template('Flow' if flow else 'RGB', depth=50)
    back, want = import_torch_weights(jax_load_torch_state_dict(path),
                                      variables, inflate_in_channels=inflate,
                                      return_report=True)

    port = build_recognizer(dict(model_cfg(modality='Flow' if flow
                                           else 'RGB', depth=50),
                                 dtype=None))
    port.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = import_torch_state_dict(port, load_torch_state_dict(path),
                                  inflate_in_channels=inflate)
    names = {f'{coll}:{p}': name for coll, p, name, _ in
             jax_entries(variables)}
    names.update({p: name for coll, p, name, _ in jax_entries(variables)})
    assert sorted(got['applied']) == sorted(names[p] for p in want['applied'])
    assert sorted(got['missing']) == sorted(names[p] for p in want['missing'])
    assert sorted(got['unexpected']) == sorted(want['unexpected'])
    assert sorted(m.split(':')[0] for m in got['mismatched']) == sorted(
        names[m.split(':')[0]] for m in want['mismatched'])
    state = port.state_dict()
    for _, jpath, name, value in jax_entries(back):
        np.testing.assert_array_equal(state[name].numpy(), value,
                                      err_msg=jpath)

    expect_unexpected = {
        'reference_module_prefix': [], 'head_aliases': [],
        'torchvision': [], 'flow_inflation': [],
        'mismatch_and_unknown': ['backbone.layer1.0.conv2.weight',
                                 'backbone.layer9.0.conv1.weight',
                                 'cls_head.segmental_consensus.classifier.1.'
                                 'weight']}[case]
    assert sorted(got['unexpected']) == expect_unexpected
    if case == 'reference_module_prefix':
        assert got['missing'] == []
    if case in ('torchvision', 'flow_inflation'):
        # the head keeps its init, and so does MVF, which ImageNet lacks
        mvf = re.compile(r'\.conv1\.(shift_conv|h_conv|w_conv|bn)\.')
        assert {n for n in got['missing'] if not mvf.search(n)} == {
            'cls_head.new_fc.bias', 'cls_head.new_fc.weight'}
        assert 'backbone.layer3.0.conv1.net.weight' in got['applied']
    if case == 'head_aliases':
        assert torch.equal(state['cls_head.new_fc.weight'],
                           torch.full((NUM_CLASSES, 2048), 0.5))
    if flow:
        assert state['backbone.conv1.weight'].shape[1] == 10
    assert (got['mismatched'] != []) == (case == 'mismatch_and_unknown')


def test_pretrained_torchvision_backbone_loads_in_the_loop(tiny_data,
                                                           tmp_path):
    pretrained = tmp_path / 'resnet50.pth'
    sd = _torchvision_r50(11)
    torch.save(sd, pretrained)
    cfg = Config.fromfile(write_config(tmp_path, tiny_data,
                                       pretrained=str(pretrained), depth=50))
    model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    TrainLoop(model, build_dataset(dict(cfg.data['train'])), cfg,
              device='cpu')
    state = model.state_dict()
    assert torch.equal(state['backbone.conv1.weight'], sd['conv1.weight'])
    assert torch.equal(state['backbone.layer3.0.conv1.net.weight'],
                       sd['layer3.0.conv1.weight'])
    assert torch.equal(state['backbone.layer4.2.bn3.running_var'],
                       sd['layer4.2.bn3.running_var'])
    fresh = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
    fresh.init_weights(torch.Generator().manual_seed(0))
    for k in ('cls_head.new_fc.weight', 'cls_head.new_fc.bias',
              'backbone.layer3.0.conv1.shift_conv.weight'):
        assert torch.equal(state[k], fresh.state_dict()[k]), k


def run_train_cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, '-m', 'mvfnet_tpu_torch.tools.train_recognizer']
        + [str(a) for a in args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)


def test_train_cli_trains_checkpoints_and_resumes(tiny_data, tmp_path):
    config = write_config(tmp_path, tiny_data)
    work = tmp_path / 'cli'
    proc = run_train_cli(config, '--work_dir', work, '--device', 'cpu',
                         '--validate', '--profile', 1)
    assert proc.returncode == 0, proc.stderr
    for name in ('epoch_1.pth', 'epoch_2.pth', 'latest.pth', 'train.log',
                 'profile/trace.json'):
        assert (work / name).exists(), name
    log = (work / 'train.log').read_text()
    assert [m.groups() for m in LOG_LINE.finditer(log)] == [
        ('1', '1', '2'), ('1', '2', '2'), ('2', '1', '2'), ('2', '2', '2')]
    assert len(re.findall(r'Eval epoch \d: top-[15] acc: \d\.\d{4}$', log,
                          re.M)) == 4

    again = tmp_path / 'cli_resumed'
    proc = run_train_cli(config, '--work_dir', again, '--device', 'cpu',
                         '--resume_from', work / 'epoch_1.pth')
    assert proc.returncode == 0, proc.stderr
    log = (again / 'train.log').read_text()
    assert 'resumed from' in log and 'epoch 1, iter 2' in log
    assert [m.groups() for m in LOG_LINE.finditer(log)] == [
        ('2', '1', '2'), ('2', '2', '2')]
    a = torch.load(work / 'epoch_2.pth', weights_only=False)
    b = torch.load(again / 'epoch_2.pth', weights_only=False)
    assert a['meta'] == b['meta'] == {'epoch': 2, 'iter': 4}
    for k, v in a['state_dict'].items():
        assert torch.equal(v, b['state_dict'][k]), k


def test_train_cli_refuses_what_is_not_ported(tiny_data, tmp_path,
                                              monkeypatch):
    config = write_config(tmp_path, tiny_data)
    # more than one process (tests/test_torch_dist.py runs them): the
    # launcher needs torchrun's variables, and --gpus N needs N cards
    # unless the ranks run on the CPU
    for k in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',
              'LOCAL_RANK'):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(KeyError, match='MASTER_ADDR'):
        train_cli.main([config, '--device', 'cpu', '--launcher', 'env'])
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match='--gpus 2'):
            train_cli.main([config, '--gpus', '2'])
    cfg = Config.fromfile(config)
    model = build_recognizer(dict(cfg.model))
    # a .msgpack with a quant_stats collection resumes as without it: the
    # JAX TrainLoop restores params and batch_stats alone
    calibrated = str(tmp_path / 'latest.msgpack')
    trained = build_recognizer(dict(cfg.model))
    trained.init_weights(torch.Generator().manual_seed(5),
                         randomize_bn=True)
    variables = jax_variables_from_state_dict(trained.state_dict())
    stats = {'backbone_mod': {'layer1_0': {'conv1': {
        'act_amax': np.float32(2.5), 'act_amax_calibrated': np.float32(1)}}}}
    jax_save(calibrated, dict(variables, quant_stats=stats),
             meta={'epoch': 1, 'iter': 2})
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train'])), cfg,
                     device='cpu')
    loop.resume(calibrated)
    assert (loop.epoch, loop.iter) == (1, 2)
    for k, v in trained.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(model.state_dict()[k], v), k
    del loop
    # with_cp is ported: the loop hands it to the step as remat, and the
    # backbone checkpoints its stages
    cp = Config.fromfile(config)
    cp.model = dict(cfg.model, backbone=dict(cfg.model['backbone'],
                                             with_cp=True))
    loop = TrainLoop(model, build_dataset(dict(cfg.data['train'])), cp,
                     device='cpu')
    assert model.backbone.with_cp is True
    del loop
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            train_cli.main([config])


class _Logger:
    def __init__(self):
        self.warnings = []

    def warning(self, msg, *args):
        self.warnings.append(msg % args)


def test_tensorboard_hook_writes_events_or_disables(tmp_path, monkeypatch):
    loop = types.SimpleNamespace(logger=_Logger(), work_dir=str(tmp_path),
                                 iter=1, step=1)
    hook = TensorboardLoggerHook(interval=1)
    hook.before_run(loop)
    metrics = dict(loss=torch.tensor(0.5), grad_norm=torch.tensor(2.0),
                   lr=0.01)
    hook.after_iter(loop, metrics)
    hook.after_run(loop)
    events = [f for f in os.listdir(tmp_path / 'tf_logs')
              if f.startswith('events.out.tfevents')]
    assert len(events) == 1 and loop.logger.warnings == []

    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    loop = types.SimpleNamespace(logger=_Logger(),
                                 work_dir=str(tmp_path / 'off'), iter=1,
                                 step=1)
    hook = TensorboardLoggerHook(interval=1)
    hook.before_run(loop)
    hook.after_iter(loop, metrics)
    hook.after_run(loop)
    assert loop.logger.warnings == ['torch.utils.tensorboard unavailable; '
                                    'TensorboardLoggerHook disabled']
    assert not os.path.exists(tmp_path / 'off')
