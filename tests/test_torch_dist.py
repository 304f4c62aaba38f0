"""The port's multi-process engine on the CPU, over gloo.

Ranks run in processes spawned by ``parallel.spawn_local`` (one spawn of
2 ranks and one of 3 for the whole file, each rank running every check of
its world in turn and writing its results to files), and the CLIs as
subprocesses (torchrun, and the train CLI's ``--gpus``); all of them start
together when the first test asks for them, with a thread that compiles
and runs the JAX package's 2-device mesh steps; the port's world-1
references are computed here meanwhile. Every
process group has a 60 s timeout and every spawn or subprocess a deadline,
so a rank that dies fails the tests instead of hanging them.

- Launcher parsing: torchrun's and SLURM's variables (``scontrol``
  stubbed), missing variables, a process alone.
- Synced BatchNorm (worlds 2 and 3, f64, equal and unequal rows a rank,
  the MVF module's ``bn`` too): output, running statistics and the
  gradients of input, weight and bias against one process on the
  concatenated batch at rtol 1e-10.
- The model of every check is ResNet-18 + MVF THW (``mvf_freq=(0, 0, 1,
  1)``), T = 2, 4 classes: the engine's semantics do not depend on the
  depth, as in ``tests/test_torch_train_loop.py``.
- The train step: f64, 3 steps of the recipe (SGD nesterov, clip at 40, a
  warm-up), 2 videos a rank. World 2 with dropout 0.5 against world 1 on
  the concatenated batch; world 2 with dropout 0, global and per-rank
  BatchNorm, against the JAX package's step on a 2-device mesh (``local_bn``
  too). Losses and grad norms at rtol 1e-9, final parameters and BN
  statistics at rtol 1e-7 / atol 1e-9 (``tests/test_torch_train_step.py``'s
  tolerances). The frames are 64², not the 16² of the other checks: at 16²
  layer3-4 are 1×1, each rank's BatchNorm sees 4 values a channel, many
  of them zeros of a ReLU, and the gradient norms reach 1e5-1e6 with
  ``local_bn`` (1e4 with global statistics), so that rounding in the
  order of a sum, 1e-16, grows to 1e-6 by step 2 in the JAX package's
  trajectory against itself as much as in the port's; at 64² (16 values)
  the port meets JAX far inside the tolerances.
- The dry run of ``__graft_entry__.py::dryrun_multichip`` at world 2: 3
  steps, a ``.pth`` and a ``.msgpack`` round trip, one more finite step.
- Sharded evaluation, worlds 2 and 3, 1, 4, 5 and 7 videos: scores and
  features equal world 1's per video at rtol 1e-12.
- ``TrainLoop`` at world 2: rank 0 alone writes the checkpoints, the
  parameters are bit-equal across ranks, a resumed run repeats the
  unbroken one exactly, ``EvalHook``'s top-k is equal on both ranks.
- The CLIs: the test and feature CLIs under torchrun against world 1, the
  train CLI with ``--gpus 2`` (one set of checkpoints, ``--autoscale-lr``).
- ``spawn_local`` kills the other ranks when one fails, or all at its
  deadline, and raises.
"""

import os
import pickle
import re
import shutil
import subprocess
import sys
import threading
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
T, HW, NUM_CLASSES = 2, 16, 4
STEPS, PER_RANK, TRAIN_HW = 3, 2, 64
RECIPE = dict(type='SGD', lr=0.02, momentum=0.9, weight_decay=1e-4,
              nesterov=True)
LR_CONFIG = dict(policy='step', step=[5], warmup='linear', warmup_iters=3,
                 warmup_ratio=0.1)
GRAD_CLIP = dict(max_norm=40, norm_type=2)
EVAL_SIZES = (1, 4, 5, 7)
TASKS = {2: ('bn', 'gather', 'train_dropout', 'train_global',
             'train_local_bn', 'dryrun', 'eval', 'loop'),
         3: ('bn', 'eval')}
SPAWN_TIMEOUT = 240
CLI_TIMEOUT = 240
NORM = dict(mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375],
            to_rgb=True)


# ---------------------------------------------------- shared by every rank
def mvf_cfg(dropout):
    return dict(
        type='Recognizer2D',
        backbone=dict(type='ResNet', depth=18, out_indices=(3,),
                      norm_eval=False,
                      norm_cfg=dict(type='BN', requires_grad=True)),
        cls_head=dict(type='TSNClsHead', spatial_size=-1, spatial_type='avg',
                      dropout_ratio=dropout, in_channels=512,
                      init_std=0.01, num_classes=NUM_CLASSES),
        module_cfg=dict(type='MVF', n_segment=T, alpha=0.125,
                        mvf_freq=(0, 0, 1, 1), mode='THW'),
        dtype=None)


def port_model(dropout=0.0, randomize_bn=False, dtype=torch.float64):
    """The seeded model, f64 unless asked; the same on every rank."""
    from mvfnet_tpu_torch.models import build_recognizer
    model = build_recognizer(mvf_cfg(dropout),
                             test_cfg=dict(average_clips='prob'))
    model.init_weights(torch.Generator().manual_seed(0), randomize_bn)
    return model.to(dtype)


def train_data():
    """(STEPS, global batch, T, HW, HW, 3) frames and their labels; rank r
    takes videos r*PER_RANK.. of each step."""
    rng = np.random.RandomState(11)
    n = 2 * PER_RANK
    return (rng.randn(STEPS, n, T, TRAIN_HW, TRAIN_HW, 3) * 0.5,
            rng.randint(0, NUM_CLASSES, size=(STEPS, n)))


def port_trajectory(world, rank, dropout, local_bn=False):
    """Per-step loss and grad norm and the final state of the port's step
    on this rank's share of ``train_data``."""
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    model = port_model(dropout)
    sched = build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, STEPS)
    opt = build_optimizer(model, RECIPE, sched, grad_clip=GRAD_CLIP)
    step = make_train_step(model, opt, sched, device='cpu', seed=0,
                           local_bn=local_bn)
    imgs, labels = train_data()
    b = imgs.shape[1] // world
    rows = slice(rank * b, (rank + 1) * b)
    out = dict(loss=[], grad_norm=[])
    for t in range(STEPS):
        m = step(imgs[t, rows], labels[t, rows])
        out['loss'].append(m['loss'].item())
        out['grad_norm'].append(m['grad_norm'].item())
    out['state'] = {k: v.clone() for k, v in model.state_dict().items()}
    return out


BN_ROWS = {'equal': (3, 3, 3), 'unequal': (2, 5, 1)}


def bn_case(world, rows_kind, mvf):
    """The rows of each rank, a module and its f64 input and upstream
    gradient: a ``BatchNorm`` over (rows, 5, 3, 2), or an MVF module (its
    ``bn`` in train mode) over (videos * T, 4, 3, 8), rows in videos."""
    from mvfnet_tpu_torch.models.common import BatchNorm
    from mvfnet_tpu_torch.models.modules.mvf import MVF
    rows = BN_ROWS[rows_kind][:world]
    rng = np.random.RandomState(3 + world)
    torch.manual_seed(1)
    if mvf:
        module = MVF(torch.nn.Identity(), T, 8, alpha=0.5).double()
        shape = (sum(rows) * T, 4, 3, 8)
        bn = module.bn
    else:
        module = bn = BatchNorm(5).double()
        shape = (sum(rows), 5, 3, 2)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
        bn.running_mean.uniform_(-0.1, 0.1)
    module.train()
    per = T if mvf else 1
    bounds = np.cumsum((0,) + rows) * per
    return (module, bn, torch.from_numpy(rng.randn(*shape)),
            torch.from_numpy(rng.randn(*shape)), bounds)


def run_bn(module, bn, x, g, mvf):
    x = x.clone().requires_grad_()
    y = module.mvf(x) if mvf else module(x)
    (y * g).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=bn.weight.grad,
                db=bn.bias.grad, running_mean=bn.running_mean.clone(),
                running_var=bn.running_var.clone())


class Videos:
    """``n`` seeded videos of 2 clips x T frames of HW^2, f64."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(100 + i)
        return {'img_group': rng.randn(2 * T, HW, HW, 3)}


def evaluate_sizes():
    """Scores and features of ``evaluate_dataset`` for every size."""
    from mvfnet_tpu_torch.engine.eval import evaluate_dataset
    model = port_model(randomize_bn=True)
    return {(n, feat): evaluate_dataset(model, Videos(n), videos_per_gpu=2,
                                        workers_per_gpu=1, extract_feat=feat,
                                        device='cpu')
            for n in EVAL_SIZES for feat in (False, True)}


# --------------------------------------------------------- the ranks' work
def _task_bn(world, rank, out):
    import torch.distributed as dist
    from mvfnet_tpu_torch.models.common import set_sync_group
    res = {}
    for kind in BN_ROWS:
        for mvf in (False, True):
            module, bn, x, g, bounds = bn_case(world, kind, mvf)
            assert set_sync_group(module, dist.group.WORLD) == 1
            rows = slice(bounds[rank], bounds[rank + 1])
            res[kind, mvf] = run_bn(module, bn, x[rows], g[rows], mvf)
    return res


def _task_gather(world, rank, out):
    from mvfnet_tpu_torch.parallel import all_gather_rows
    rows = all_gather_rows(torch.full((2, 3), float(rank)))
    try:
        all_gather_rows(torch.zeros(1 + rank, 3))
    except ValueError as e:
        return dict(rows=rows, error=str(e))
    return dict(rows=rows, error=None)


def _task_train_dropout(world, rank, out):
    return port_trajectory(world, rank, 0.5)


def _task_train_global(world, rank, out):
    return port_trajectory(world, rank, 0.0)


def _task_train_local_bn(world, rank, out):
    return port_trajectory(world, rank, 0.0, local_bn=True)


def _task_dryrun(world, rank, out):
    """``dryrun_multichip``: 3 steps, a ``.pth`` and a ``.msgpack`` written
    by rank 0 and read back by every rank, one more step from each."""
    from mvfnet_tpu_torch.engine.optim import (build_lr_schedule,
                                               build_optimizer)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    from mvfnet_tpu_torch.parallel import barrier
    from mvfnet_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                   load_optax_state,
                                                   save_checkpoint,
                                                   save_msgpack_checkpoint)
    recipe = dict(RECIPE, lr=0.01)
    lr_cfg = dict(policy='step', step=[2], warmup='linear', warmup_iters=5,
                  warmup_ratio=0.01)

    def fresh():
        model = port_model(0.5, dtype=torch.float32)
        sched = build_lr_schedule(lr_cfg, recipe['lr'], 10, 4)
        opt = build_optimizer(model, recipe, sched, grad_clip=GRAD_CLIP)
        return model, opt, make_train_step(model, opt, sched, device='cpu',
                                           seed=1)

    rng = np.random.RandomState(0)
    imgs = rng.randn(world, T, 32, 32, 3).astype(np.float32)[rank:rank + 1]
    labels = (np.arange(world) % NUM_CLASSES)[rank:rank + 1]
    model, opt, step = fresh()
    losses = [step(imgs, labels)['loss'].item() for _ in range(3)]
    paths = {'pth': os.path.join(out, 'dryrun.pth'),
             'msgpack': os.path.join(out, 'dryrun.msgpack')}
    meta = dict(epoch=1, iter=step.state.step)
    if rank == 0:
        save_checkpoint(paths['pth'], model, opt, meta)
        save_msgpack_checkpoint(paths['msgpack'], model, opt, meta)
    barrier()
    res = dict(losses=losses, after={})
    for fmt, path in paths.items():
        again, opt2, step2 = fresh()
        sd, opt_state, meta2 = load_checkpoint(path)
        again.load_state_dict(sd)
        if fmt == 'msgpack':
            load_optax_state(again, opt2, opt_state, meta2['iter'])
        else:
            opt2.load_state_dict(opt_state)
        step2.state.step = meta2['iter']
        trained = model.state_dict()
        restored = all(torch.equal(trained[k], v) for k, v in sd.items()
                       if not k.endswith('num_batches_tracked'))
        ms = [step2(imgs, labels) for _ in range(2)]
        res['after'][fmt] = dict(
            meta=meta2, restored=restored, keys=len(sd),
            loss=[m['loss'].item() for m in ms],
            grad_norm=[m['grad_norm'].item() for m in ms])
    res['unbroken'] = [step(imgs, labels)['loss'].item() for _ in range(2)]
    return res


def _task_eval(world, rank, out):
    return evaluate_sizes()


def _task_loop(world, rank, out):
    """Two epochs with an evaluation after each, then a run resumed from
    ``epoch_1.pth``; which ranks wrote checkpoints."""
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.data import build_dataset
    from mvfnet_tpu_torch.engine import train_loop
    from mvfnet_tpu_torch.models import build_recognizer
    writes = []
    save = train_loop.save_checkpoint

    def counted(path, *args, **kwargs):
        writes.append(os.path.basename(path))
        return save(path, *args, **kwargs)

    train_loop.save_checkpoint = counted
    cfg = Config.fromfile(os.path.join(out, 'loop_cfg.py'))
    res = {}
    for name, resume in (('unbroken', None), ('resumed', 'epoch_1.pth')):
        cfg.work_dir = os.path.join(out, name)
        cfg.resume_from = (os.path.join(out, 'unbroken', resume)
                           if resume else None)
        model = build_recognizer(dict(cfg.model), test_cfg=cfg.test_cfg)
        loop = train_loop.train_network(
            model, build_dataset(dict(cfg.data['train'])), cfg,
            validate=True, seed=0, device='cpu')
        res[name] = dict(
            state={k: v.clone() for k, v in model.state_dict().items()},
            evals=[{k: v for k, v in e.items()}
                   for e in loop.eval_history],
            step=loop.step, iters_per_epoch=loop.iters_per_epoch)
    res['writes'] = writes
    return res


def rank_main(world, out, tasks):
    """One rank: join the group and run ``tasks`` in order, each result to
    ``out/{task}_{rank}.pt``; a failed task writes its traceback to
    ``out/{task}_{rank}.err`` and ends the rank."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mvfnet_tpu_torch.parallel import init_distributed
    init_distributed('env', timeout=timedelta(seconds=60), device='cpu')
    rank = dist.get_rank()
    try:
        for name in tasks:
            try:
                res = globals()[f'_task_{name}'](world, rank, out)
            except BaseException:
                with open(os.path.join(out, f'{name}_{rank}.err'), 'w') as f:
                    f.write(traceback.format_exc())
                raise
            torch.save(res, os.path.join(out, f'{name}_{rank}.pt'))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the launches
def write_rawframes(root, n):
    import cv2
    rng = np.random.RandomState(5)
    lines = []
    for v in range(n):
        d = os.path.join(root, f'v{v}')
        os.makedirs(d)
        for f in range(8):
            cv2.imwrite(os.path.join(d, f'img_{f + 1:05}.jpg'),
                        rng.randint(0, 255, (40, 40, 3), np.uint8))
        lines.append(f'v{v} 8 {v % NUM_CLASSES}')
    ann = os.path.join(root, 'ann.txt')
    with open(ann, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return ann


def split(root, ann, test_mode):
    crop = (dict(type='CenterCrop', crop_size=32) if test_mode
            else dict(type='RandomResizedCrop', input_size=32))
    return dict(
        type='RawFramesDataset', ann_file=ann, data_root=root,
        test_mode=test_mode, modality='RGB', filename_tmpl='img_{:05}.jpg',
        pipeline=[
            dict(type='SampleFrames', clip_len=T, frame_interval=2,
                 num_clips=1),
            dict(type='FrameSelector'), crop,
            dict(type='Normalize', **NORM),
            dict(type='FormatShape', input_format='NHWC'),
            dict(type='Collect', keys=['img_group', 'label'], meta_keys=[]),
        ])


def config_text(root, ann, dropout, lr_config):
    train = split(root, ann, False)
    val = split(root, ann, True)
    model = dict(mvf_cfg(dropout), dtype='float32')
    return '\n'.join([
        f'model = {model!r}', "test_cfg = dict(average_clips='prob')",
        f'data = dict(videos_per_gpu=1, workers_per_gpu=1, train={train!r}, '
        f'val={val!r}, test={val!r})',
        f'optimizer = {dict(RECIPE, lr=0.01)!r}',
        f'optimizer_config = dict(grad_clip={GRAD_CLIP!r})',
        f'lr_config = {lr_config!r}', 'checkpoint_config = dict(interval=1)',
        'log_config = dict(interval=1, hooks=[dict(type="TextLoggerHook")])',
        'total_epochs = 2', 'eval_interval = 1', "log_level = 'INFO'", ''])


class Launches:
    """The spawns and CLI subprocesses of this file, started together."""

    def __init__(self, root):
        self.root = root
        self.errors, self.threads, self.procs = {}, {}, {}
        for world in TASKS:
            out = os.path.join(root, f'world{world}')
            os.makedirs(out)
            if world == 2:
                self._loop_config(out)
            self.threads[world] = threading.Thread(
                target=self._spawn, args=(world, out), daemon=True)
            self.threads[world].start()
        self._clis()

    def _loop_config(self, out):
        data = os.path.join(out, 'loop_data')
        os.makedirs(data)
        ann = write_rawframes(data, 4)
        with open(os.path.join(out, 'loop_cfg.py'), 'w') as f:
            f.write(config_text(data, ann, 0.5, dict(
                policy='step', step=[1], warmup='linear', warmup_iters=2,
                warmup_ratio=0.1)))

    def _spawn(self, world, out):
        from mvfnet_tpu_torch.parallel import spawn_local
        try:
            spawn_local(rank_main, world, (world, out, TASKS[world]),
                        timeout=SPAWN_TIMEOUT)
        except BaseException as e:   # reported by the tests that wait
            self.errors[world] = e

    def _clis(self):
        from mvfnet_tpu_torch.parallel import free_port
        from mvfnet_tpu_torch.tools.test_recognizer import build_model
        from mvfnet_tpu_torch.config import Config
        data = os.path.join(self.root, 'cli_data')
        os.makedirs(data)
        ann = write_rawframes(data, 5)
        self.config = os.path.join(self.root, 'cli_cfg.py')
        with open(self.config, 'w') as f:
            f.write(config_text(data, ann, 0.5,
                                dict(policy='step', step=[10])))
        model = build_model(Config.fromfile(self.config), False, 'prob')
        model.init_weights(torch.Generator().manual_seed(0),
                           randomize_bn=True)
        self.ckpt = os.path.join(self.root, 'model.pth')
        torch.save(model.state_dict(), self.ckpt)
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1')
        for name in ('test_recognizer', 'feature_extractor'):
            out = os.path.join(self.root, f'{name}_world2.out')
            cmd = [sys.executable, '-m', 'torch.distributed.run',
                   '--nnodes', '1', '--nproc_per_node', '2',
                   '--master_addr', '127.0.0.1',
                   '--master_port', str(free_port()),
                   '-m', f'mvfnet_tpu_torch.tools.{name}', self.config,
                   self.ckpt, '--launcher', 'env', '--device', 'cpu',
                   '--out', out]
            self.procs[name] = (subprocess.Popen(
                cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), out)
        work = os.path.join(self.root, 'train_world2')
        self.procs['train_recognizer'] = (subprocess.Popen(
            [sys.executable, '-m', 'mvfnet_tpu_torch.tools.train_recognizer',
             self.config, '--work_dir', work, '--gpus', '2', '--device',
             'cpu', '--autoscale-lr'], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), work)

    def results(self, world, task):
        """Every rank's result of ``task`` at ``world``."""
        self.threads[world].join(SPAWN_TIMEOUT + 30)
        out = os.path.join(self.root, f'world{world}')
        errs = [open(os.path.join(out, n)).read()
                for n in sorted(os.listdir(out)) if n.endswith('.err')]
        assert not self.threads[world].is_alive(), f'world {world} hangs'
        assert world not in self.errors and not errs, (
            self.errors.get(world), errs)
        return [torch.load(os.path.join(out, f'{task}_{r}.pt'),
                           weights_only=False) for r in range(world)]

    def cli(self, name):
        """``(returncode, stdout, stderr, output path)`` of a CLI run."""
        proc, out = self.procs[name]
        stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
        return proc.returncode, stdout, stderr, out

    def close(self):
        for proc, _ in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        for t in self.threads.values():
            t.join(SPAWN_TIMEOUT + 30)
        # the CLIs' and the loop's checkpoints
        shutil.rmtree(self.root, ignore_errors=True)


@pytest.fixture(scope='module')
def launches(tmp_path_factory):
    run = Launches(str(tmp_path_factory.mktemp('dist')))
    # the JAX package's mesh steps compile here while the ranks run
    run.jax_runs = {}
    run.jax_thread = threading.Thread(target=jax_mesh_runs_in,
                                      args=(run.jax_runs,), daemon=True)
    run.jax_thread.start()
    yield run
    run.close()
    run.jax_thread.join(CLI_TIMEOUT)


# ------------------------------------------------------------------- tests
def test_launches_start(launches):
    """Starts the ranks and CLIs first, so that they run while the tests
    below parse and compute their references (the JAX package's mesh
    steps first, the longest)."""
    assert set(launches.threads) == {2, 3}
    assert set(launches.procs) == {'test_recognizer', 'feature_extractor',
                                   'train_recognizer'}


def fail_or_sleep(failing_rank):
    """A rank that raises (``failing_rank``) or sleeps a minute."""
    import time
    if int(os.environ['RANK']) == failing_rank:
        raise RuntimeError(f'rank {failing_rank} fails on purpose')
    time.sleep(60)


def test_spawn_local_kills_survivors_and_raises():
    import time
    from torch.multiprocessing import ProcessRaisedException
    from mvfnet_tpu_torch.parallel import spawn_local
    t0 = time.monotonic()
    with pytest.raises(ProcessRaisedException, match='rank 1 fails on'):
        spawn_local(fail_or_sleep, 2, (1,), timeout=50)
    # the survivor was killed, not waited for
    assert time.monotonic() - t0 < 40
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match='2 local ranks'):
        spawn_local(fail_or_sleep, 2, (-1,), timeout=5)
    assert time.monotonic() - t0 < 40


def jax_trajectory(local_bn):
    """Per-step loss and grad norm and the final state (in the port's
    names) of the JAX package's step on a 2-device mesh from the port's
    seeded weights, dropout 0."""
    import jax
    from mvfnet_tpu.engine import optim as jax_optim
    from mvfnet_tpu.engine.train_step import TrainState
    from mvfnet_tpu.engine.train_step import make_train_step as jax_step
    from mvfnet_tpu.models import build_recognizer as jax_build
    from mvfnet_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from mvfnet_tpu_torch.utils.checkpoint import (
        jax_variables_from_state_dict, state_dict_from_jax)
    variables = jax_variables_from_state_dict(port_model().state_dict())
    sched = jax_optim.build_lr_schedule(LR_CONFIG, RECIPE['lr'], 1, STEPS)
    tx = jax_optim.build_optimizer(variables['params'], RECIPE, sched,
                                   grad_clip=GRAD_CLIP)
    mesh = make_mesh(jax.devices()[:2])
    step = jax_step(jax_build(mvf_cfg(0.0),
                              test_cfg=dict(average_clips=None)),
                    tx, mesh=mesh, donate=False, local_bn=local_bn)
    state = replicate(TrainState.create(variables, tx), mesh)
    imgs, labels = train_data()
    out = dict(loss=[], grad_norm=[])
    for t in range(STEPS):
        batch = shard_batch({'img_group': imgs[t], 'label': labels[t]},
                            mesh)
        state, m = step(state, batch['img_group'], batch['label'],
                        jax.random.PRNGKey(t))
        out['loss'].append(float(m['loss']))
        out['grad_norm'].append(float(m['grad_norm']))
    out['state'] = state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, state.variables()))
    return out


def jax_mesh_runs_in(out):
    """Both BatchNorm modes of the JAX step, compiled side by side, into
    ``out``."""
    from concurrent.futures import ThreadPoolExecutor
    import jax
    jax.config.update('jax_enable_x64', True)
    try:
        with ThreadPoolExecutor(2) as pool:
            out.update(zip((False, True),
                           pool.map(jax_trajectory, (False, True))))
    except BaseException:      # reported by the test that waits
        out['error'] = traceback.format_exc()
    finally:
        jax.config.update('jax_enable_x64', False)


@pytest.fixture(scope='module')
def jax_mesh_runs(launches):
    launches.jax_thread.join(CLI_TIMEOUT)
    assert set(launches.jax_runs) == {False, True}, launches.jax_runs.get(
        'error', 'the JAX runs did not end')
    return launches.jax_runs


@pytest.mark.parametrize('local_bn', [False, True])
def test_train_step_world2_matches_jax_mesh(launches, jax_mesh_runs,
                                            local_bn):
    want = jax_mesh_runs[local_bn]
    task = 'train_local_bn' if local_bn else 'train_global'
    for r in launches.results(2, task):
        _assert_trajectory(r, want['loss'], want['grad_norm'],
                           want['state'])


TORCHRUN = dict(MASTER_ADDR='10.0.0.1', MASTER_PORT='1234', WORLD_SIZE='4',
                RANK='3', LOCAL_RANK='1')


def test_dist_env_reads_torchrun_variables():
    from mvfnet_tpu_torch.parallel import dist_env
    want = dict(master_addr='10.0.0.1', master_port=1234, world_size=4,
                rank=3, local_rank=1)
    assert dist_env('env', TORCHRUN) == want
    assert dist_env(None, TORCHRUN) == want
    assert dist_env('none', TORCHRUN) is None
    assert dist_env(None, dict(TORCHRUN, WORLD_SIZE='1', RANK='0')) is None
    assert dist_env(None, {}) is None


def test_dist_env_reads_slurm_variables(tmp_path, monkeypatch):
    from mvfnet_tpu_torch.parallel import dist
    slurm = dict(SLURM_PROCID='5', SLURM_NTASKS='8', SLURM_LOCALID='1',
                 SLURM_NODELIST='gpu[07-08]')
    got = dist.dist_env('slurm', dict(slurm, MASTER_ADDR='10.1.1.1'))
    assert got == dict(master_addr='10.1.1.1',
                       master_port=dist.DEFAULT_MASTER_PORT, world_size=8,
                       rank=5, local_rank=1)
    # without MASTER_ADDR: the first host scontrol lists
    stub = tmp_path / 'scontrol'
    stub.write_text('#!/bin/sh\n[ "$1 $2 $3" = "show hostnames gpu[07-08]" ]'
                    ' || exit 3\necho gpu07\necho gpu08\n')
    stub.chmod(0o755)
    monkeypatch.setenv('PATH', f'{tmp_path}{os.pathsep}{os.environ["PATH"]}')
    got = dist.dist_env(None, dict(slurm, MASTER_PORT='2222'))
    assert got == dict(master_addr='gpu07', master_port=2222, world_size=8,
                       rank=5, local_rank=1)
    # one task: a process alone, unless the launcher is named
    assert dist.dist_env(None, dict(slurm, SLURM_NTASKS='1')) is None


@pytest.mark.parametrize('missing', sorted(TORCHRUN))
def test_dist_env_raises_on_missing_variables(missing):
    from mvfnet_tpu_torch.parallel import dist_env
    env = {k: v for k, v in TORCHRUN.items() if k != missing}
    with pytest.raises(KeyError, match=missing):
        dist_env('env', env)
    with pytest.raises(KeyError, match='SLURM_'):
        dist_env('slurm', {'SLURM_PROCID': '0'})
    with pytest.raises(ValueError, match='rank 4'):
        dist_env('env', dict(TORCHRUN, RANK='4'))
    with pytest.raises(ValueError, match='launcher'):
        dist_env('mpi', TORCHRUN)


def test_init_distributed_alone_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    from mvfnet_tpu_torch.parallel import (all_gather_rows, barrier,
                                           get_dist_info, init_distributed,
                                           is_main_process, process_group)
    for k in TORCHRUN:
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device='cpu') == torch.device('cpu')
    with process_group('none', 'cpu') as device:
        assert device == torch.device('cpu')
    assert not dist.is_initialized()
    assert get_dist_info() == dict(rank=0, world_size=1, local_rank=0,
                                   local_device_count=1,
                                   global_device_count=1)
    assert is_main_process()
    barrier()
    t = torch.ones(2, 3)
    assert all_gather_rows(t) is t
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            init_distributed()


@pytest.mark.parametrize('world', [2, 3])
def test_synced_bn_matches_one_process(launches, world):
    ranks = launches.results(world, 'bn')
    for kind in BN_ROWS:
        for mvf in (False, True):
            module, bn, x, g, _ = bn_case(world, kind, mvf)
            want = run_bn(module, bn, x, g, mvf)
            got = [r[kind, mvf] for r in ranks]
            for key in ('y', 'dx'):
                np.testing.assert_allclose(
                    torch.cat([r[key] for r in got]).numpy(),
                    want[key].numpy(), rtol=1e-10, atol=1e-12,
                    err_msg=f'{kind} mvf={mvf} {key}')
            for key in ('dw', 'db'):       # each rank's own sums
                np.testing.assert_allclose(
                    sum(r[key] for r in got).numpy(), want[key].numpy(),
                    rtol=1e-10, atol=1e-12, err_msg=f'{kind} {mvf} {key}')
            for key in ('running_mean', 'running_var'):
                for r in got:
                    np.testing.assert_allclose(
                        r[key].numpy(), want[key].numpy(), rtol=1e-10,
                        err_msg=f'{kind} {mvf} {key}')


def test_all_gather_rows_checks_shapes(launches):
    for r in launches.results(2, 'gather'):
        assert torch.equal(r['rows'], torch.tensor([[0.] * 3] * 2
                                                   + [[1.] * 3] * 2))
        assert r['error'] and 'different shapes' in r['error']


def _assert_trajectory(got, want_loss, want_norm, want_state):
    np.testing.assert_allclose(got['loss'], want_loss, rtol=1e-9)
    np.testing.assert_allclose(got['grad_norm'], want_norm, rtol=1e-9)
    assert set(got['state']) == set(want_state)
    for k, v in want_state.items():
        if k.endswith('num_batches_tracked'):
            continue
        np.testing.assert_allclose(got['state'][k].numpy(), v.numpy(),
                                   rtol=1e-7, atol=1e-9, err_msg=k)


def test_train_step_world2_matches_world1(launches):
    want = port_trajectory(1, 0, 0.5)
    ranks = launches.results(2, 'train_dropout')
    for r in ranks:
        _assert_trajectory(r, want['loss'], want['grad_norm'], want['state'])
    assert want['loss'][0] != want['loss'][-1]
    for k, v in ranks[0]['state'].items():
        assert torch.equal(v, ranks[1]['state'][k]), k


def test_dry_run_world2(launches):
    ranks = launches.results(2, 'dryrun')
    for r in ranks:
        assert all(np.isfinite(r['losses']))
        assert r['losses'][0] != r['losses'][-1]
        for fmt, after in r['after'].items():
            assert after['restored'] and after['keys'] == len(
                port_model().state_dict()), fmt
            assert after['meta']['epoch'] == 1 and after['meta']['iter'] == 3
            assert np.isfinite(after['loss'] + after['grad_norm']).all()
            # the restored run, SGD state included, takes the unbroken
            # run's next two steps
            np.testing.assert_allclose(after['loss'], r['unbroken'],
                                       rtol=1e-9, err_msg=fmt)
    assert ranks[0]['losses'] == ranks[1]['losses']


@pytest.mark.parametrize('world', [2, 3])
def test_sharded_eval_matches_world1(launches, world):
    want = evaluate_sizes()
    for r in launches.results(world, 'eval'):
        for (n, feat), v in want.items():
            assert r[n, feat].shape == v.shape == (
                (n, 4 * 512) if feat else (n, NUM_CLASSES))
            np.testing.assert_allclose(r[n, feat], v, rtol=1e-12,
                                       err_msg=f'n={n} features={feat}')


def test_train_loop_world2(launches):
    ranks = launches.results(2, 'loop')
    assert ranks[0]['writes'] == ['epoch_1.pth', 'latest.pth',
                                  'epoch_2.pth', 'latest.pth',
                                  'epoch_2.pth', 'latest.pth']
    assert ranks[1]['writes'] == []
    out = os.path.join(launches.root, 'world2')
    assert sorted(os.listdir(os.path.join(out, 'unbroken'))) == [
        'epoch_1.pth', 'epoch_2.pth', 'latest.pth']
    for name in ('unbroken', 'resumed'):
        a, b = ranks[0][name], ranks[1][name]
        # 4 videos, 1 a rank a step: 2 steps an epoch
        assert a['iters_per_epoch'] == 2 and a['step'] == b['step'] == 4
        for k, v in a['state'].items():
            assert torch.equal(v, b['state'][k]), (name, k)
        assert [e['epoch'] for e in a['evals']] == (
            [1, 2] if name == 'unbroken' else [2])
        for ea, eb in zip(a['evals'], b['evals']):
            assert (ea['top1'], ea['top5']) == (eb['top1'], eb['top5'])
            np.testing.assert_array_equal(ea['scores'], eb['scores'])
            assert ea['scores'].shape == (4, NUM_CLASSES)
    for k, v in ranks[0]['unbroken']['state'].items():
        assert torch.equal(v, ranks[0]['resumed']['state'][k]), k
    assert ranks[0]['unbroken']['evals'][1]['top1'] == \
        ranks[0]['resumed']['evals'][0]['top1']
    saved = torch.load(os.path.join(out, 'unbroken', 'epoch_2.pth'),
                       weights_only=False)
    assert saved['meta'] == {'epoch': 2, 'iter': 4}
    assert not any(k.startswith('module.') for k in saved['state_dict'])


def _world1(launches, module):
    import contextlib
    import io
    from mvfnet_tpu_torch.tools import feature_extractor, test_recognizer
    cli = {'test_recognizer': test_recognizer,
           'feature_extractor': feature_extractor}[module]
    out = os.path.join(launches.root, f'{module}_world1.out')
    buf = io.StringIO()
    # one thread, as the ranks run: float32 convolutions on 8 threads
    # differ from 1 by a few 1e-6
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(buf):
            cli.main([launches.config, launches.ckpt, '--device', 'cpu',
                      '--out', out])
    finally:
        torch.set_num_threads(threads)
    return out, buf.getvalue()


def test_test_cli_under_torchrun(launches):
    want, text = _world1(launches, 'test_recognizer')
    rc, stdout, stderr, out = launches.cli('test_recognizer')
    assert rc == 0, stderr
    with open(out, 'rb') as f:
        got = pickle.load(f)
    with open(want, 'rb') as f:
        want = pickle.load(f)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=1e-6)
    # rank 0 alone prints the accuracies, and they are world 1's
    assert stdout.count('Top-1 Accuracy') == 1
    assert re.findall(r'^.*Accuracy = .*$', stdout, re.M) == \
        re.findall(r'^.*Accuracy = .*$', text, re.M)
    assert stderr.count('scores written to') == 1


def test_feature_cli_under_torchrun(launches):
    import json
    want, _ = _world1(launches, 'feature_extractor')
    rc, _, stderr, out = launches.cli('feature_extractor')
    assert rc == 0, stderr
    with open(out) as f:
        got = json.load(f)
    with open(want) as f:
        want = json.load(f)
    assert list(got) == list(want) == [f'v{i}' for i in range(5)]
    np.testing.assert_allclose(np.array(list(got.values())),
                               np.array(list(want.values())), rtol=1e-6,
                               atol=1e-7)
    assert stderr.count('wrote 5 features') == 1


def test_train_cli_spawns_gpus_ranks(launches):
    from mvfnet_tpu_torch.config import Config
    from mvfnet_tpu_torch.models import build_recognizer
    from mvfnet_tpu_torch.utils.checkpoint import (import_torch_state_dict,
                                                   load_torch_state_dict)
    rc, _, stderr, work = launches.cli('train_recognizer')
    assert rc == 0, stderr
    assert sorted(os.listdir(work)) == ['epoch_1.pth', 'epoch_2.pth',
                                        'latest.pth', 'train.log']
    log = open(os.path.join(work, 'train.log')).read()
    assert "'world_size': 2" in log
    # 5 videos over 2 ranks (a shard of 3), 1 a step: 3 steps an epoch;
    # lr 0.01 * 2 / 8
    lrs = re.findall(r'Epoch \[(\d)\]\[(\d)/3\] lr: (\S+),', log)
    assert lrs == [(e, i, '0.00250') for e in '12' for i in '123']
    assert stderr.count('saved checkpoint') == 2
    model = build_recognizer(dict(Config.fromfile(launches.config).model))
    report = import_torch_state_dict(model, load_torch_state_dict(
        os.path.join(work, 'latest.pth')))
    assert report['missing'] == report['unexpected'] \
        == report['mismatched'] == []
