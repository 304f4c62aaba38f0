"""Where a fused-bottleneck launch spends its time, by stage, on the card.

    python -m mvfnet_tpu_torch.tools.kernel_stages \\
        [--source FILE.cu] [--variant NAME=[@FILE.cu,]DEF[,DEF...]]... \\
        [--sass OUT.txt] [--out OUT.json]

Without ``--source`` it times ``csrc/fused_bottleneck.cu`` with timing hooks
added at its tiled kernel's step loop (``guarded``): ``FB_STAGES=1`` keeps
conv1 only, ``FB_STAGES=2`` conv1 and conv2, ``FB_NO_RESIDUAL=1`` adds what
is in the residual stage in place of x, ``FB_NO_STORE=1`` leaves out the
output stores, and ``FB_TRACE=1`` stamps ``%globaltimer`` at every stage
boundary (slot 0 of a block's record is its SM, slot 1 its start, then 16
slots per step of its run: the step's start, conv1's end, conv2's end, and
for each conv3 pass the end of its products and of its store). Built
without definitions the hooks are empty and the kernel is the committed one.
``--source`` takes any other source (an older kernel with hooks of its own),
and a variant's ``@FILE.cu`` its own, to compare versions in one run.

All variants compile at once, then each is timed at the dense-test path's
two bf16 shapes with CUDA events around launches queued back to back, in
the order of the variants and then in reverse, on the same inputs. Each
variant without definitions is held against the plain version. A traced
variant is launched once more per shape, and its stamps are summed into
microseconds per stage and step and into the share of SMs in each stage
over twentieths of the launch. Prints one JSON line per shape and the
card's name and power limit; ``--sass`` writes ``cuobjdump -sass`` of the
first variant without definitions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import _cuda
from ..ops import fused_block as fb

SHAPES = [('layer1', (240, 64, 64, 256), 64),
          ('layer2', (240, 32, 32, 512), 128)]
DEFAULT_VARIANTS = ['full=', 'conv1=FB_STAGES=1', 'conv1+conv2=FB_STAGES=2',
                    'residual 0=FB_NO_RESIDUAL=1', 'no store=FB_NO_STORE=1',
                    'traced=FB_TRACE=1']
TRACE_SLOTS = 2 + 16 * 32   # a block's record: 32 steps at most

# (anchor in the tiled kernel, text put in its place); the anchors are
# checked to occur once (tests/test_torch_kernel_stages.py)
_TRACE_PRELUDE = """#ifdef FB_TRACE
constexpr int kTraceSlots = %d;
__device__ unsigned long long g_trace[1 << 20];
__device__ __forceinline__ void trace_at(int slot, unsigned long long v) {
  const size_t i = (size_t)blockIdx.x * kTraceSlots + slot;
  if (threadIdx.x == 0 && i < (1u << 20)) g_trace[i] = v;
}
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid() {
  unsigned r;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(r));
  return r;
}
#define TRACE(slot) trace_at(slot, gtime())
#else
#define TRACE(slot) do {} while (0)
#endif
""" % TRACE_SLOTS
GUARDS = [
    ('__global__ void __launch_bounds__(kTileThreads, 1)\n',
     _TRACE_PRELUDE + '__global__ void __launch_bounds__(kTileThreads, 1)\n'),
    ('  const int cpt = Cm / kKC;\n',
     '  const int cpt = Cm / kKC;\n#ifdef FB_TRACE\n  trace_at(0, smid());\n'
     '#endif\n  TRACE(1);\n'),
    ('    conv1(2, r0 + 1, TH);\n',
     '    const int tb = 2 + 16 * (int)(g - g0);\n    TRACE(tb);\n'
     '    conv1(2, r0 + 1, TH);\n    TRACE(tb + 1);\n'
     '#if defined(FB_STAGES) && FB_STAGES < 2\n    continue;\n#endif\n'),
    ("    // 3. out = relu(h2.W3 + b3 + x) for the step's pixels",
     '    TRACE(tb + 2);\n#if defined(FB_STAGES) && FB_STAGES < 3\n'
     '    continue;\n#endif\n'
     "    // 3. out = relu(h2.W3 + b3 + x) for the step's pixels"),
    ('              cp_async16(res + res_at(p, k, width),\n'
     '                         xt + (size_t)p * Cin + n0 + k, true);\n',
     '#ifndef FB_NO_RESIDUAL\n'
     '              cp_async16(res + res_at(p, k, width),\n'
     '                         xt + (size_t)p * Cin + n0 + k, true);\n'
     '#endif\n'),
    ('      __syncthreads();\n'
     '      for (int i = threadIdx.x; i < npx * kpr; i += kTileThreads) {\n'
     '        const int p = i / kpr, k = (i % kpr) * 8;\n'
     '        *reinterpret_cast<int4*>(ot + (size_t)p * Cin + n0 + k) =\n'
     '            *reinterpret_cast<const int4*>(res + res_at(p, k, width));\n'
     '      }\n'
     '      __syncthreads();\n',
     '      TRACE(tb + 3 + 2 * (n0 / pl.ng3));\n'
     '      __syncthreads();\n'
     '      for (int i = threadIdx.x; i < npx * kpr; i += kTileThreads) {\n'
     '        const int p = i / kpr, k = (i % kpr) * 8;\n'
     '#ifndef FB_NO_STORE\n'
     '        *reinterpret_cast<int4*>(ot + (size_t)p * Cin + n0 + k) =\n'
     '            *reinterpret_cast<const int4*>(res + res_at(p, k, width));\n'
     '#endif\n'
     '      }\n'
     '      __syncthreads();\n'
     '      TRACE(tb + 4 + 2 * (n0 / pl.ng3));\n'),
    ('extern "C" {\n',
     'extern "C" {\n#ifdef FB_TRACE\n'
     'int fused_bottleneck_trace(unsigned long long* host, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(host, g_trace, (size_t)n * 8);\n}\n'
     'int fused_bottleneck_trace_slots() { return kTraceSlots; }\n'
     'int fused_bottleneck_trace_reset() {\n  void* p = nullptr;\n'
     '  cudaGetSymbolAddress(&p, g_trace);\n'
     '  return (int)cudaMemset(p, 0, sizeof(g_trace));\n}\n#endif\n'),
]


def guarded(src: str) -> str:
    """The kernel source with the timing hooks added (see the module doc)."""
    for anchor, text in GUARDS:
        if src.count(anchor) != 1:
            raise ValueError(f'kernel_stages: anchor found '
                             f'{src.count(anchor)} times: {anchor!r}')
        src = src.replace(anchor, text)
    return src


def _median_ms(fn, runs=25, warmup=3):
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _parse(spec, source):
    """(name, source, definitions) of NAME=[@FILE.cu,]DEF,..."""
    name, _, rest = spec.partition('=')
    defs = [d for d in rest.split(',') if d]
    files = [d[1:] for d in defs if d.startswith('@')]
    return (name, os.path.abspath(files[0] if files else source),
            [d for d in defs if not d.startswith('@')])


def build_all(variants, out_dir):
    """Compile every variant at once; {name: (loaded library, path)}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, source, defs) in enumerate(variants):
        path = os.path.join(out_dir, f'libstage{i}.so')
        cmd = ([_cuda._nvcc()] + _cuda.NVCC_FLAGS + [f'-D{d}' for d in defs]
               + ['-o', path, source])
        procs[name] = (path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log = proc.communicate()[0]
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'nvcc [{name}]: {line.strip()}')
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for variant {name}:\n{log}')
        lib = ctypes.CDLL(path)
        sigs = dict(fb._SIGNATURES)
        if hasattr(lib, 'fused_bottleneck_trace'):
            sigs.update(fused_bottleneck_trace=(
                [ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
                fused_bottleneck_trace_slots=([], ctypes.c_int),
                fused_bottleneck_trace_reset=([], ctypes.c_int))
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = (lib, path)
    return libs


def trace_summary(a):
    """Stage times from one traced launch; a is (blocks, slots) int64 ns."""
    a = a[a[:, 1] > 0]
    t = a[:, 1:]
    stages = {'conv1': [], 'conv2': [], 'conv3 products': [],
              'conv3 store': [], 'step': []}
    spans = []  # (starts, ends, stage) of one step of every block
    last = np.zeros(len(a))
    for step in range((a.shape[1] - 2) // 16):
        b = 1 + 16 * step
        ok = t[:, b] > 0
        if not ok.any():
            break
        rows = t[ok]
        stages['conv1'] += list(rows[:, b + 1] - rows[:, b])
        stages['conv2'] += list(rows[:, b + 2] - rows[:, b + 1])
        spans += [(rows[:, b], rows[:, b + 1], 'conv1'),
                  (rows[:, b + 1], rows[:, b + 2], 'conv2')]
        prev = end = rows[:, b + 2]
        prod = store = 0
        for p in range(6):
            g, e = rows[:, b + 3 + 2 * p], rows[:, b + 4 + 2 * p]
            if not (g > 0).all():
                break
            prod, store = prod + (g - prev), store + (e - g)
            spans += [(prev, g, 'conv3 products'), (g, e, 'conv3 store')]
            prev = end = e
        stages['conv3 products'] += list(prod)
        stages['conv3 store'] += list(store)
        stages['step'] += list(end - rows[:, b])
        last[ok] = np.maximum(last[ok], end)
    t0, t1 = t[:, 0].min(), last.max()
    edges = np.linspace(t0, t1, 21)
    sms = len(np.unique(a[:, 0]))
    share = {}
    for name in ('conv1', 'conv2', 'conv3 products', 'conv3 store'):
        occ = np.zeros(20)
        for s0, s1, kind in spans:
            if kind == name:
                lo = np.clip(s0[:, None], edges[None, :-1], edges[None, 1:])
                hi = np.clip(s1[:, None], edges[None, :-1], edges[None, 1:])
                occ += (hi - lo).sum(0)
        share[name] = [round(float(v), 3) for v in occ / (np.diff(edges) * sms)]
    return dict(
        blocks=int(len(a)), sms=int(sms), launch_us=float(t1 - t0) / 1e3,
        block_us=float(np.mean(last - t[:, 0])) / 1e3,
        steps=len(stages['step']),
        us_per_step={k: float(np.mean(v)) / 1e3 for k, v in stages.items()},
        share_of_sms_by_twentieth=share)


def _trace(lib, launch):
    slots = lib.fused_bottleneck_trace_slots()
    _cuda.check(lib.fused_bottleneck_trace_reset(), 'trace reset')
    launch()
    torch.cuda.synchronize()
    n = 1 << 20
    buf = (ctypes.c_ulonglong * n)()
    _cuda.check(lib.fused_bottleneck_trace(buf, n), 'trace read')
    a = np.frombuffer(buf, dtype=np.uint64).astype(np.int64)
    return trace_summary(a[:n // slots * slots].reshape(-1, slots))


def _launcher(lib, args, out):
    x, w1, b1, w2, b2, w3, b3 = args
    n, h, w, cin = x.shape
    cm = w1.shape[-1]
    w1t, w2t, w3t = w1.t(), w2.permute(0, 1, 3, 2), w3.t()
    assert all(t.is_contiguous() for t in (w1t, w2t, w3t))
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        err = lib.fused_bottleneck_launch(
            1, x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(),
            b2.data_ptr(), w3t.data_ptr(), b3.data_ptr(), out.data_ptr(),
            n, h, w, cin, cm, stream)
        _cuda.check(err, 'fused_bottleneck (stage variant)')
    return launch


def _inputs(shape, cm, seed):
    g = torch.Generator(device='cuda').manual_seed(seed)
    n, h, w, cin = shape

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device='cuda') * scale
    bf = torch.bfloat16
    return (rnd(n, h, w, cin).to(bf),
            fb.out_major(rnd(cin, cm, scale=cin ** -0.5).to(bf)),
            rnd(cm, scale=0.1),
            fb.out_major(rnd(3, 3, cm, cm, scale=(9 * cm) ** -0.5).to(bf)),
            rnd(cm, scale=0.1),
            fb.out_major(rnd(cm, cin, scale=cm ** -0.5).to(bf)),
            rnd(cin, scale=0.1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--source', default=None)
    p.add_argument('--variant', action='append', default=None,
                   help='NAME=[@FILE.cu,]DEF[,DEF...]; default: ' +
                        '; '.join(DEFAULT_VARIANTS))
    p.add_argument('--sass', default=None)
    p.add_argument('--out', default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('kernel_stages: no CUDA device', file=sys.stderr)
        return 2
    out_dir = os.path.join(_cuda.BUILD_DIR, 'stages')
    source = a.source
    if source is None:
        os.makedirs(out_dir, exist_ok=True)
        source = os.path.join(out_dir, 'fused_bottleneck_guarded.cu')
        with open(os.path.join(_cuda.SRC_DIR, 'fused_bottleneck.cu')) as f:
            text = guarded(f.read())
        with open(source, 'w') as f:
            f.write(text)
    variants = [_parse(s, source) for s in (a.variant or DEFAULT_VARIANTS)]
    libs = build_all(variants, out_dir)
    fulls = [name for name, _, defs in variants if not defs]
    if a.sass and fulls:
        tool = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
        sass = subprocess.run([tool, '-sass', libs[fulls[0]][1]],
                              capture_output=True, text=True).stdout
        with open(a.sass, 'w') as f:
            f.write(sass)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    rows = []
    with torch.inference_mode():
        for i, (case, shape, cm) in enumerate(SHAPES):
            args = _inputs(shape, cm, seed=200 + i)
            out = torch.empty_like(args[0])
            launch = {name: _launcher(lib, args, out)
                      for name, (lib, _) in libs.items()}
            want = fb.bottleneck_eval_plain(*args)
            ref = want.float().abs().max().item()
            errs = {}
            for name in fulls:
                out.zero_()
                launch[name]()
                errs[name] = (out.float() - want.float()).abs().max().item()
            order = [name for name, _, _ in variants]
            fwd = {name: _median_ms(launch[name]) for name in order}
            bwd = {name: _median_ms(launch[name]) for name in order[::-1]}
            row = dict(case=case, shape=list(shape) + [cm], card=card,
                       max_abs_err=errs, tol=1e-2 * ref,
                       ms={name: (fwd[name] + bwd[name]) / 2
                           for name in order},
                       ms_forward=fwd, ms_reverse=bwd)
            for name, (lib, _) in libs.items():
                if hasattr(lib, 'fused_bottleneck_trace'):
                    row.setdefault('trace', {})[name] = _trace(
                        lib, launch[name])
            print('stages: ' + json.dumps(row))
            rows.append(row)
            if any(e > 1e-2 * ref for e in errs.values()):
                print(f'kernel_stages: a variant disagrees with the plain '
                      f'version at {case}: {errs}', file=sys.stderr)
                return 1
            del args, out, want
    if a.out:
        with open(a.out, 'w') as f:
            json.dump(rows, f, indent=1)
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
