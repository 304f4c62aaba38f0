"""The stage-timing tool of the port's fused kernel, on the CPU.

``mvfnet_tpu_torch/tools/kernel_stages.py`` times the tiled kernel on the
card with timing hooks put in at fixed places of its source. These tests
check what needs no card: every place is found once in the committed
source, variant specs parse, and a trace sums to the stage times it holds.
"""

import os

import numpy as np
import pytest

from mvfnet_tpu_torch.ops import _cuda
from mvfnet_tpu_torch.tools import kernel_stages as ks


def _source():
    with open(os.path.join(_cuda.SRC_DIR, 'fused_bottleneck.cu')) as f:
        return f.read()


@pytest.mark.parametrize('i', range(len(ks.GUARDS)))
def test_every_hook_has_one_place_in_the_kernel(i):
    assert _source().count(ks.GUARDS[i][0]) == 1


def test_hooks_are_empty_without_definitions():
    src = _source()
    out = ks.guarded(src)
    for macro in ('FB_STAGES', 'FB_NO_RESIDUAL', 'FB_NO_STORE', 'FB_TRACE'):
        assert macro in out and macro not in src
    # what the hooks add outside #if blocks is TRACE(...) (empty unless
    # FB_TRACE) and the step's trace slot
    kept, depth = [], 0
    for line in out.splitlines():
        if line.startswith('#if'):
            depth += 1
        elif line.startswith('#endif'):
            depth -= 1
        elif depth == 0 and not line.startswith('#else'):
            kept.append(line)
    added = [ln.strip() for ln in kept if ln not in src.splitlines()]
    assert added and all(ln.startswith(('TRACE(', 'const int tb ='))
                         for ln in added)


def test_variant_specs():
    assert ks._parse('full=', 'k.cu') == ('full', os.path.abspath('k.cu'), [])
    assert ks._parse('old=@o.cu,FB_STAGES=1', 'k.cu') == (
        'old', os.path.abspath('o.cu'), ['FB_STAGES=1'])


def test_trace_summary_sums_the_stamps():
    # 2 SMs, one block each, 3 steps of conv1 100 ns, conv2 300 ns and 4
    # conv3 passes of 50 ns products + 20 ns store
    slots = ks.TRACE_SLOTS
    a = np.zeros((4, slots), np.int64)
    for b in range(2):
        a[b, 0], a[b, 1] = b, 1000
        t = 2000
        for step in range(3):
            s = 2 + 16 * step
            a[b, s], a[b, s + 1], a[b, s + 2] = t, t + 100, t + 400
            t += 400
            for p in range(4):
                a[b, s + 3 + 2 * p], a[b, s + 4 + 2 * p] = t + 50, t + 70
                t += 70
    got = ks.trace_summary(a)
    assert (got['blocks'], got['sms'], got['steps']) == (2, 2, 6)
    us = got['us_per_step']
    assert us['conv1'] == pytest.approx(0.1)
    assert us['conv2'] == pytest.approx(0.3)
    assert us['conv3 products'] == pytest.approx(0.2)
    assert us['conv3 store'] == pytest.approx(0.08)
    assert us['step'] == pytest.approx(0.68)
    assert got['block_us'] == pytest.approx(1 + 3 * 0.68)
    share = got['share_of_sms_by_twentieth']
    total = np.sum([share[k] for k in share], axis=0)
    # from the first step on, every SM is in some stage
    assert total[-1] == pytest.approx(1.0)
