"""The ``ycc_to_bgr`` kernel's device time on a decode call's frames, on
the card.

    python -m mvfnet_tpu_torch.tools.ycc_bench [--frames 80] \\
        [--hw 256 455] [--runs 50] [--variant NAME=@FILE.cu]... \\
        [--out OUT.json]

Makes ``--frames`` frames' 4:2:0 planes at ``--hw`` (random, seeded; a
decode call of the test CLI: 10 clips x 8 frames of 455x256) on the card
and converts them as a decode call does, with the committed
``csrc/nvjpeg_decode.cu`` and with each ``--variant`` (another build of
that source, such as an older commit's from ``git archive``): a source
with ``mvf_ycc_launch`` converts them in one launch from a device table of
frames, an older one (``mvf_ycc_to_bgr`` on one frame's planes) in one
launch a frame, as its decode calls did. For each it prints a
``ycc bench:`` line: whether every frame equals ``ycc_to_bgr_plain`` bit
for bit; ``device_ms``, the kernels' own device time a call from
``torch.profiler`` (the mean kernel's, times the call's launches), and
``device_span_ms``, the profiled window's first kernel start to its last
kernel end over the number of calls; ``event_ms``, CUDA events around
``--runs`` calls queued back to back from Python, over the count (the
host's launch work included where it is longer than the kernel);
``graph_ms``, the same with one call captured in a CUDA graph and replayed
(no Python between launches); the bound (each plane read once, BGR written
once, over 3.35 TB/s) and ``device_ms``'s share of it. Then the card's
name and power limit; ``--out`` gets the records as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from ..data import native_io
from ..ops import _cuda

PEAK_BYTES = 3.35e12        # H100 SXM HBM3

_P = ctypes.c_void_p
_OLD_SIGNATURE = ([_P, ctypes.c_int, _P, _P] + [ctypes.c_int] * 7
                  + [_P, _P], ctypes.c_int)


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def planes(n, h, w, seed=15):
    """n frames' (Y, Cb, Cr) uint8 planes at 4:2:0 on the card."""
    g = torch.Generator(device='cuda').manual_seed(seed)
    ch, cw = -(-h // 2), -(-w // 2)
    return [tuple(torch.randint(0, 256, s, generator=g, device='cuda',
                                dtype=torch.uint8)
                  for s in ((h, w), (ch, cw), (ch, cw)))
            for _ in range(n)]


def bound_ms(frames) -> float:
    nbytes = sum(y.numel() * 4 + cb.numel() + cr.numel()
                 for y, cb, cr in frames)
    return nbytes / PEAK_BYTES * 1e3


def converter(lib, frames, outs):
    """A function that converts ``frames`` into ``outs`` as one decode call
    of ``lib``'s design does, the design's name and its launches a call."""
    if hasattr(lib, 'mvf_ycc_launch'):
        table, tiles = native_io.frame_table(
            lib, [(y, cb, cr, 2, 2) for y, cb, cr in frames], outs)
        table = table.cuda()

        def call():
            _cuda.check(lib.mvf_ycc_launch(
                table.data_ptr(), len(frames), tiles,
                torch.cuda.current_stream().cuda_stream), 'ycc_to_bgr')
        return call, 'one launch a call', 1
    fn = lib.mvf_ycc_to_bgr
    args = []
    for (y, cb, cr), out in zip(frames, outs):
        (h, w), (ch, cw) = y.shape, cb.shape
        args.append((y.data_ptr(), w, cb.data_ptr(), cr.data_ptr(), cw, w,
                     h, cw, ch, 2, 2, out.data_ptr()))

    def call():
        s = torch.cuda.current_stream().cuda_stream
        for a in args:
            _cuda.check(fn(*a, s), 'ycc_to_bgr')
    return call, 'one launch a frame', len(frames)


def kernel_spans(call, runs, match, launches, tries=3):
    """The (start, end) in us of the kernels whose names hold ``match``
    over ``runs`` calls queued back to back, from torch.profiler. The
    profiler can miss a few of a window's ``runs * launches`` kernels (on
    the H100, 47 of 50 after other profiles in the process); a window that
    shows fewer than half of them is profiled again, up to ``tries``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                call()
            torch.cuda.synchronize()
        spans = [(e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and match in e.name]
        if 2 * len(spans) >= runs * launches:
            return spans
    raise RuntimeError(f'torch.profiler saw {len(spans)} {match} kernels of '
                       f'{runs * launches} in each of {tries} windows')


def profile_ms(call, runs, launches):
    """A call's device time (the mean kernel's time the call's launches),
    the window's first kernel start to its last kernel end over the calls,
    and the kernels seen a call, from torch.profiler."""
    spans = kernel_spans(call, runs, 'ycc_to_bgr', launches)
    return (sum(e - s for s, e in spans) / len(spans) * launches / 1e3,
            (max(e for _, e in spans) - min(s for s, _ in spans)) / 1e3
            / runs, len(spans) / runs)


def event_ms(call, runs):
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def graph_ms(call, runs):
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def record(name, lib, frames, runs):
    want = [native_io.ycc_to_bgr_plain(y, cb, cr, 2, 2)
            for y, cb, cr in frames]
    # every byte starts wrong, so that a byte left unwritten shows
    outs = [w ^ 255 for w in want]
    call, design, launches = converter(lib, frames, outs)
    call()
    torch.cuda.synchronize()
    equal = all(torch.equal(o, w) for o, w in zip(outs, want))
    device, span, kernels = profile_ms(call, runs, launches)
    rec = dict(source=name, design=design, frames=len(frames),
               shape=list(frames[0][0].shape) + [2, 2], equal=equal,
               kernels_per_call=kernels, device_ms=device,
               device_span_ms=span, event_ms=event_ms(call, runs),
               graph_ms=graph_ms(call, runs), bound_ms=bound_ms(frames))
    rec['share_of_bound'] = rec['bound_ms'] / device
    return rec


def bind(lib):
    """``lib`` with the argument types of the kernel's entry points it has:
    ``native_io``'s, or the one-frame ``mvf_ycc_to_bgr`` of older sources."""
    for fn, (argtypes, restype) in native_io._SIGNATURES.items():
        if fn.startswith('mvf_ycc') and hasattr(lib, fn):
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
    if hasattr(lib, 'mvf_ycc_to_bgr'):
        lib.mvf_ycc_to_bgr.argtypes, lib.mvf_ycc_to_bgr.restype = \
            _OLD_SIGNATURE
    return lib


def build_variants(specs, out_dir):
    """``{name: library}`` of ``NAME=@FILE.cu`` specs, compiled at once
    with the committed source's flags."""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _cuda._nvcc()
    procs = {}
    for i, spec in enumerate(specs):
        name, _, src = spec.partition('=')
        path = os.path.join(out_dir, f'libycc_variant{i}.so')
        procs[name] = (path, subprocess.Popen(
            [nvcc] + _cuda._flags('nvjpeg_decode', nvcc) + [
                '-o', path, os.path.abspath(src.lstrip('@'))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if any(w in line for w in ('registers', 'spill', 'warning')):
                print(f'nvcc [{name}]: {line.strip()}')
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for variant {name}:\n{log}')
        libs[name] = bind(ctypes.CDLL(path))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--frames', type=int, default=80)
    ap.add_argument('--hw', type=int, nargs=2, default=(256, 455))
    ap.add_argument('--runs', type=int, default=50)
    ap.add_argument('--variant', action='append', default=[])
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('ycc_bench: no CUDA device', file=sys.stderr)
        return 2
    card = card_line()
    libs = {'committed': native_io.library()}
    for line in _cuda.build_logs.get('nvjpeg_decode', '').splitlines():
        if any(w in line for w in ('registers', 'spill', 'warning')):
            print(f'nvcc [committed]: {line.strip()}')
    variants = build_variants(args.variant, os.path.join(
        _cuda.BUILD_DIR, 'ycc_variants'))
    frames = planes(args.frames, *args.hw)
    # variants and the committed source in turns: v..., c, c, ...v
    order = (list(variants) + ['committed', 'committed']
             + list(reversed(list(variants))))
    records = []
    for name in order:
        lib = libs.get(name) or variants[name]
        rec = record(name, lib, frames, args.runs)
        records.append(rec)
        print('ycc bench: ' + json.dumps(rec), flush=True)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(card=card, records=records), f, indent=1)
    bad = [r['source'] for r in records if not r['equal']]
    if bad:
        print(f'ycc_bench: differs from the plain version in {bad}',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
