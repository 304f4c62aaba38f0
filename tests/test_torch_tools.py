"""Port parity: the host tools ``count_flops`` and ``report_accuracy``.

- ``count_flops`` on the flagship config (MVFNet-R50 8x8, 400 classes) at
  its default input ``(1, 8, 224, 224, 3)``, counted on the ``meta``
  device: 24,342,416 parameters (README.md) and 32.704 GMACs, which equal
  the convolution and FC multiply-adds worked out from each layer's weight
  shape and output size; at a small input the CPU count equals the meta
  count and the worked-out one.
- ``report_accuracy`` prints the root CLI's three lines on the same score
  pickles, with and without a softmax (in both spellings of the flag).
"""

import contextlib
import io
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from mvfnet_tpu_torch.config import Config
from mvfnet_tpu_torch.models import build_recognizer
from mvfnet_tpu_torch.tools import count_flops, report_accuracy
from mvfnet_tpu_torch.utils.flops import get_flop_stats

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
FLAGSHIP = os.path.join(REPO, 'configs', 'mvf', 'k400',
                        'mvf_kinetics400_r50_8x8_dense.py')


def flagship_model():
    cfg = Config.fromfile(FLAGSHIP)
    return build_recognizer(dict(cfg.model, dtype=cfg.compute_dtype),
                            test_cfg=dict(average_clips=None))


def worked_out_macs(shape):
    """Convolution and FC multiply-adds of the flagship's test forward at
    ``shape``: each convolution's output elements times its weight's
    per-output fan-in (``in / groups * kH * kW``), read with forward hooks
    in train mode (where every block calls its convolutions as modules) on
    the meta device, and the FC's frames x in x out (the MVF taps are
    elementwise in the port and not counted)."""
    model = flagship_model().to('meta').train()
    macs = []

    def hook(module, _, out):
        w = module.weight
        macs.append(out.numel() * w.shape[1] * int(np.prod(w.shape[2:])))

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(shape, device='meta'), None, return_loss=False)
    fc = model.cls_head.new_fc
    frames = shape[0] * shape[1]
    return sum(macs) + frames * fc.in_features * fc.out_features


def test_count_flops_cli_on_the_flagship():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        stats = count_flops.main([FLAGSHIP])
    assert stats['shape'] == (1, 8, 224, 224, 3)
    assert stats['params'] == 24342416
    assert stats['macs'] == worked_out_macs(stats['shape'])
    assert stats['flops'] == 2 * stats['macs']
    assert out.getvalue().splitlines()[:3] == [
        'input shape: (1, 8, 224, 224, 3)', 'params: 24.34 M',
        'GFLOPs (MAC convention, vs reference): 32.704']
    assert 'bytes accessed: unavailable' in out.getvalue()


def test_flop_count_on_cpu_equals_meta_and_worked_out():
    shape = (1, 8, 64, 64, 3)
    cpu = get_flop_stats(flagship_model(), shape, device='cpu')
    meta = get_flop_stats(flagship_model(), shape)
    assert cpu == meta
    assert meta['macs'] == worked_out_macs(shape)
    with pytest.raises(ValueError, match='meta device or the CPU'):
        get_flop_stats(flagship_model(), shape, device='cuda')


def _write_scores(tmp_path):
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 7, size=12)
    paths = []
    for i in range(2):
        path = tmp_path / f'scores_{i}.pkl'
        with open(path, 'wb') as f:
            pickle.dump(list(rng.randn(12, 7) * 3), f)
        paths.append(str(path))
    datalist = tmp_path / 'ann.txt'
    datalist.write_text(''.join(f'video_{i} 30 {lab}\n'
                                for i, lab in enumerate(labels)))
    return paths, str(datalist)


@pytest.mark.parametrize('flag', [None, '--apply_softmax',
                                  '--apply-softmax'])
def test_report_accuracy_prints_the_root_cli_lines(tmp_path, monkeypatch,
                                                    flag):
    paths, datalist = _write_scores(tmp_path)
    args = ['--scores', *paths, '--coefficients', '1', '0.5',
            '--datalist', datalist] + ([flag] if flag else [])
    root = io.StringIO()
    monkeypatch.setattr(sys, 'argv', ['report_accuracy.py'] + args)
    with contextlib.redirect_stdout(root):
        runpy.run_path(os.path.join(REPO, 'report_accuracy.py'),
                       run_name='__main__')
    port = io.StringIO()
    with contextlib.redirect_stdout(port):
        result = report_accuracy.main(args)
    lines = port.getvalue().splitlines()
    assert lines == root.getvalue().splitlines()
    assert [line.split(' = ')[0] for line in lines] == [
        'Top-1 Accuracy', 'Top-5 Accuracy', 'Mean Class Accuracy']
    assert lines[0] == f'Top-1 Accuracy = {result["top1"] * 100:.02f}'
    with pytest.raises(ValueError, match='coefficients'):
        report_accuracy.main(args[:4] + args[5:])
