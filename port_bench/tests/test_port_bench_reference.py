"""The plain reference models agree with the port's plain path on the CPU
in float64 at a small size: the dense test of both configurations, and
the first train steps (loss, clipped gradient, parameters) of the
flagship. Only this test imports both the reference and the port."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from port_bench.lib import harness, weights  # noqa: E402
from port_bench.lib.port import build_model, device_norm  # noqa: E402
from port_bench.reference import models as ref  # noqa: E402
from port_bench.reference.train import train_steps  # noqa: E402

SEED = 2 ** 33 + 17


def config(name, dtype='float64'):
    cfg = harness.load_json(os.path.join(harness.HERE, 'configs',
                                         name + '.json'))
    return dict(cfg, compute_dtype=dtype)


def state64(cfg):
    state = weights.make_state(ref.spec(cfg['model']), SEED, 'cpu')
    return {k: v.double() if v.is_floating_point() else v
            for k, v in state.items()}


@pytest.mark.parametrize('name,shape', [
    ('mvf_r50_8x8', (1, 16, 32, 32, 3)),
    ('i3d_r50_32x2', (1, 2, 8, 32, 32, 3)),
])
def test_dense_matches_port_in_float64(name, shape):
    from mvfnet_tpu_torch.engine.train_step import make_eval_step
    cfg = config(name)
    state = state64(cfg)
    model = build_model(cfg, state, 'cpu')
    model.double()
    step = make_eval_step(model, norm_cfg=device_norm(cfg), device='cpu')
    video = weights.uint8_frames(shape, 1, SEED, 2, 'cpu')[0]
    got = step(model, video)[0]
    logits = ref.dense_clip_logits(state, torch.from_numpy(video[0]),
                                   cfg['model'], cfg['img_norm_cfg'])
    want = ref.prob_average(logits)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-9,
                               atol=1e-12)
    # the answer is not near uniform: the comparison has something to see
    assert float(want.max() / want.min()) > 2


def test_train_steps_match_port_in_float64():
    from mvfnet_tpu_torch.engine.optim import (
        build_lr_schedule, build_optimizer, frozen_prefixes_from_backbone)
    from mvfnet_tpu_torch.engine.train_step import make_train_step
    cfg = config('mvf_r50_8x8')
    state = state64(cfg)
    model = build_model(cfg, state, 'cpu')
    model.double()
    schedule = build_lr_schedule(cfg['lr_config'], cfg['optimizer']['lr'],
                                 cfg['iters_per_epoch'],
                                 cfg['total_epochs'])
    opt = build_optimizer(model, cfg['optimizer'], schedule,
                          grad_clip=cfg['optimizer_config']['grad_clip'],
                          frozen_prefixes=frozen_prefixes_from_backbone(
                              cfg['model']['backbone']))
    step = make_train_step(model, opt, schedule, norm_cfg=device_norm(cfg),
                           device='cpu')
    shape = (2, 8, 32, 32, 3)
    imgs = weights.uint8_frames(shape, 3, SEED, 2, 'cpu')
    labels = weights.labels(3, 2, 400, SEED, 3)
    names = {p: n for n, p in model.named_parameters()}
    losses, buffers = [], None
    keeps = []
    for t in range(3):
        g = torch.Generator().manual_seed(100 + t)
        keeps.append(torch.rand((16, 2048), generator=g) >= 0.5)
        m = step(imgs[t], labels[t], torch.Generator().manual_seed(100 + t))
        losses.append(float(m['loss']))
        if t == 0:
            buffers = {names[p]: s['momentum_buffer'].clone()
                       for p, s in opt.state.items()}
    ref_losses, ref_grads, ref_final, _ = train_steps(
        state, weights.kinds(ref.spec(cfg['model'])),
        [(torch.from_numpy(i), torch.from_numpy(lb))
         for i, lb in zip(imgs, labels)], keeps,
        [schedule(t) for t in range(3)], cfg['model'], cfg['img_norm_cfg'],
        cfg['optimizer'], cfg['optimizer_config']['grad_clip']['max_norm'])
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-9)
    wd = cfg['optimizer']['weight_decay']
    for name, g in ref_grads.items():
        got = buffers[name] - wd * state[name]
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=1e-6,
                                   atol=1e-12 + 1e-6 * float(g.abs().max()))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   ref_final[name].numpy(), rtol=1e-9,
                                   atol=1e-12)


def test_pipeline_matches_the_ports_dataset_on_cv2_frames(tmp_path):
    """The reference's sampling, decode, resize and three crops give the
    frames the port's test pipeline gives, byte for byte (cv2 decode on
    the CPU, a scale that resizes)."""
    from mvfnet_tpu_torch.data import build_dataset
    from port_bench.drivers.dataset_eval import _pipeline, synthetic_frames
    from port_bench.reference.pipeline import dense_test_frames
    import cv2
    cfg = config('mvf_r50_8x8')
    pipeline = [dict(op) for op in cfg['test_pipeline']]
    for op in pipeline:
        if op['type'] == 'Resize':
            op['scale'] = ['inf', 40]
        if op['type'] == 'ThreeCrop':
            op['crop_size'] = 40
    video = tmp_path / 'v'
    video.mkdir()
    rng = np.random.default_rng(3)
    for t, img in enumerate(synthetic_frames(rng, 90, 36, 64)):
        cv2.imwrite(str(video / f'img_{t + 1:05}.jpg'), img)
    (tmp_path / 'ann.txt').write_text('v 90 1\n')
    dataset = build_dataset(dict(
        type='RawFramesDataset', ann_file=str(tmp_path / 'ann.txt'),
        data_root=str(tmp_path), pipeline=_pipeline(dict(
            cfg, test_pipeline=pipeline)), test_mode=True))
    got = np.asarray(dataset[0]['img_group'])
    want = dense_test_frames(str(video), 90, pipeline)
    assert got.dtype == np.uint8 and got.shape == want.shape == (
        240, 40, 40, 3)
    assert np.array_equal(got, want)
