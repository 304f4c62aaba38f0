"""The int8 convolution kernel at the int8 path's shapes, on the card.

    python -m mvfnet_tpu_torch.tools.int8_bench \\
        [--variant NAME=@FILE.cu]... [--gather] [--check-n N] \\
        [--shapes I,J,...] [--out OUT.json]

For each shape of ``PHASE12_SHAPES`` (every shape phase 12 of
``chip_smoke.py`` launches, as ``ops.int8_conv.int8_conv_key`` gives them)
``shape_record`` measures the committed kernel: its plan (variant, tile
width); its bare launch on operands prepared in its layouts (``ms``, the
shape's own epilogue) and with the int32 epilogue (``ms_int32``); the
wrapper's call as the quantized modules make it, from int8 x and a packed
weight (``wrapper_ms``: padding, scale and bias, the output, the launch);
one ``torch._int_mm`` where it computes the same 1x1 stride-1 product
(``library_ms``, int32 out); cuDNN's bf16 ``channels_last`` convolution
at the same shape, the op the int8 conv replaces (``bf16_ms``); the bound
(bytes each input read once and each output written once over 3.35 TB/s,
or 2 MACs over 1979 TOPS, whichever is larger; a strided 1x1 reads only
the pixels it samples); and whether the kernel equals the plain version
bit for bit in int32, bf16 + bias and f32, at N cut to ``--check-n``.
``chip_smoke.py`` builds its ``int8 kernel:`` lines from the same function.

Each ``--variant`` (another build of a kernel source, such as an older
commit's ``int8_conv.cu`` unpacked from ``git archive``) is checked and
timed beside the committed kernel on the same operands; a source without
``int8_conv_abi`` (the first kernel, which gathered any Cin) takes them
unpadded, one that refuses the plan's path of x gathers x. ``--gather``
times the committed kernel with x gathered where its plan takes x by
TMA. Every variant is compiled at once, before the first shape. Medians
of CUDA events around launches queued back to back. Prints one compact
``int8 bench:`` line per shape and the card's name and power limit, and
writes the full records to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops import int8_conv as q8

INT8_PEAK_OPS = 1979e12     # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12        # H100 SXM HBM3

# (N, T, H, W, Cin, Cout, (kt, kh, kw), stride, padding before each axis,
# dilation, epilogue): the flagship's dense test under phase 12's five
# cases (N = 240 frames of 256^2), then the shipped I3D and X3D configs'
# dense tests (30 views); tests/test_torch_int8_plan.py derives the list
# again from the models on the meta device
PHASE12_SHAPES = [
    (240, 1, 16, 16, 1024, 2048, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 16, 16, 128, 256, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 16, 16, 128, 512, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 16, 16, 256, 1024, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 16, 16, 256, 256, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (240, 1, 16, 16, 512, 512, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (240, 1, 16, 16, 896, 256, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 16, 16, 896, 512, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 32, 32, 128, 128, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (240, 1, 32, 32, 128, 128, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'int32'),
    (240, 1, 32, 32, 128, 512, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 32, 32, 256, 256, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (240, 1, 32, 32, 448, 256, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 32, 32, 512, 1024, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 32, 32, 512, 128, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 32, 32, 512, 128, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'int32'),
    (240, 1, 32, 32, 64, 256, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 64, 64, 128, 128, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 128, 128, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'int32'),
    (240, 1, 64, 64, 256, 128, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 256, 128, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'int32'),
    (240, 1, 64, 64, 256, 512, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 256, 64, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 256, 64, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'int32'),
    (240, 1, 64, 64, 64, 256, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 64, 64, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 64, 64, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'int32'),
    (240, 1, 64, 64, 64, 64, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (240, 1, 64, 64, 64, 64, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'int32'),
    (240, 1, 8, 8, 1792, 512, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 8, 8, 256, 512, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'float32'),
    (240, 1, 8, 8, 512, 2048, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (240, 1, 8, 8, 512, 512, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 4, 128, 128, 24, 108, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 128, 128, 24, 48, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 16, 16, 192, 432, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 16, 16, 256, 256, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 4, 16, 16, 432, 192, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 16, 16, 512, 512, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 4, 32, 32, 128, 128, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 4, 32, 32, 216, 96, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 32, 32, 256, 256, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 4, 32, 32, 96, 192, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 32, 32, 96, 216, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 32, 32, 96, 432, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 64, 64, 108, 48, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 64, 64, 128, 128, (1, 3, 3), (1, 2, 2),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 4, 64, 64, 48, 108, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 64, 64, 48, 216, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 64, 64, 48, 96, (1, 1, 1), (1, 2, 2),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 4, 8, 8, 512, 512, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
    (30, 8, 128, 128, 24, 54, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 8, 128, 128, 54, 24, (1, 1, 1), (1, 1, 1),
     (0, 0, 0), (1, 1, 1), 'bfloat16'),
    (30, 8, 64, 64, 64, 64, (1, 3, 3), (1, 1, 1),
     (0, 1, 1), (1, 1, 1), 'bfloat16'),
]


def median_ms(fn, runs=10, warmup=2):
    """Median of per-call CUDA-event times, calls queued back to back."""
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


def key_str(key) -> str:
    return '/'.join(map(str, key))


def _geometry(key):
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    padding = tuple((p, p) for p in pad)
    out = tuple((size + 2 * p - d * (k - 1) - 1) // s + 1 for size, k, s,
                p, d in zip((t, h, w), kernel, stride, pad, dil))
    return padding, out


def _read_along(size, k, s, p, d, out) -> int:
    """Input positions along one axis that some output position reads."""
    return len({o * s - p + i * d for o in range(out) for i in range(k)}
               & set(range(size)))


def bound(key):
    """``(bound_ms, bound_by, ops, bytes)`` of one launch."""
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    _, out = _geometry(key)
    m = nb * out[0] * out[1] * out[2]
    k = kernel[0] * kernel[1] * kernel[2] * cin
    ops = 2 * m * k * cout
    read = nb * cin
    for size, kk, s, p, d, o in zip((t, h, w), kernel, stride, pad, dil,
                                    out):
        read *= _read_along(size, kk, s, p, d, o)
    nbytes = read + k * cout + m * cout * (
        4 if epi in ('int32', 'float32') else 2) + (
            0 if epi == 'int32' else 4 * cout)
    t_ops = ops / INT8_PEAK_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), 'bytes' if t_bytes >= t_ops else
            'operations', ops, nbytes)


def operands(key, seed):
    """Random int8 x and w (the JAX layouts), scale and bias on the card,
    and the epilogue's dtype (None for int32)."""
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    g = torch.Generator(device='cuda').manual_seed(seed)
    x = torch.randint(-127, 128, (nb, t, h, w, cin), generator=g,
                      device='cuda', dtype=torch.int8)
    wq = torch.randint(-127, 128, tuple(kernel) + (cin, cout), generator=g,
                       device='cuda', dtype=torch.int8)
    scale = torch.rand(cout, generator=g, device='cuda') * 1e-4 + 1e-6
    bias = torch.randn(cout, generator=g, device='cuda')
    return x, wq, scale, bias, None if epi == 'int32' else getattr(torch,
                                                                    epi)


def is_legacy(lib) -> bool:
    """A build of the first kernel's source (no ``int8_conv_abi``)."""
    return not hasattr(lib, 'int8_conv_abi')


def _legacy_launch(x, wp, key, scale, bias, out_dtype):
    """The first kernel's launch: unpadded operands, 21 dims."""
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    _, out = _geometry(key)
    epi = out_dtype if scale is not None else None
    sc = bi = None
    if scale is not None:
        sc = scale.float().contiguous()
        bi = None if bias is None else bias.float().contiguous()
    dims = (ctypes.c_int * 21)(*x.shape, *out, cout, *kernel, *stride,
                               *pad, *dil)
    return q8.Launch(x.contiguous(), wp, torch.empty(
        (x.shape[0],) + out + (cout,), device=x.device,
        dtype=torch.int32 if epi is None else epi), sc, bi, dims,
        q8._EPILOGUE[epi], None)


def prepared(lib, x, wq, key, scale=None, bias=None, out_dtype=None,
             gather=False):
    """One launch's operands for ``lib`` (None: the committed kernel),
    x gathered if ``gather``."""
    wp = q8.pack_weight(wq)
    if lib is not None and is_legacy(lib):
        return _legacy_launch(x, wp, key, scale, bias, out_dtype)
    padding, _ = _geometry(key)
    op = q8.prepare(x, wp, key[7], padding, key[9], scale, bias, out_dtype)
    if gather:
        op.dims[22] = q8.A_PATH['gather']
    return op


def equal_to_plain(lib, x, wq, key, scale, bias, gather=False):
    """``(equal, max abs int32 error)``: int32, bf16 + bias and f32 (no
    bias) against the plain version."""
    padding, _ = _geometry(key)
    args = (key[7], padding, key[9])
    equal, err = True, 0.0
    for sc, bi, dt in ((None, None, None), (scale, bias, torch.bfloat16),
                       (scale, None, torch.float32)):
        got = q8.launch(prepared(lib, x, wq, key, sc, bi, dt, gather), lib)
        want = q8.int8_conv_plain(x, wq, *args, sc, bi, dt)
        equal &= torch.equal(got, want)
        if dt is None:
            err = float((got.double() - want.double()).abs().max())
    torch.cuda.synchronize()
    return bool(equal), err


def library_ms(key, x, wq):
    """One ``torch._int_mm`` computing a 1x1 stride-1 conv's int32 product,
    or ``(None, why)``."""
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    if tuple(kernel) != (1, 1, 1) or tuple(stride) != (1, 1, 1):
        return None, None
    a = x.reshape(-1, cin)
    b = wq.reshape(cin, cout).t().contiguous().t()
    try:
        return median_ms(lambda: torch._int_mm(a, b)), None
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]


def bf16_ms(key):
    """cuDNN's bf16 ``channels_last`` convolution at the same shape."""
    nb, t, h, w, cin, cout, kernel, stride, pad, dil, epi = key
    g = torch.Generator(device='cuda').manual_seed(0)
    if t == 1 and kernel[0] == 1:
        xb = torch.randn(nb, cin, h, w, generator=g, device='cuda',
                         dtype=torch.bfloat16).to(
                             memory_format=torch.channels_last)
        wb = torch.randn(cout, cin, *kernel[1:], generator=g, device='cuda',
                         dtype=torch.bfloat16).to(
                             memory_format=torch.channels_last)
        return median_ms(lambda: F.conv2d(xb, wb, None, stride[1:], pad[1:],
                                          dil[1:]))
    xb = torch.randn(nb, cin, t, h, w, generator=g, device='cuda',
                     dtype=torch.bfloat16).to(
                         memory_format=torch.channels_last_3d)
    wb = torch.randn(cout, cin, *kernel, generator=g, device='cuda',
                     dtype=torch.bfloat16).to(
                         memory_format=torch.channels_last_3d)
    return median_ms(lambda: F.conv3d(xb, wb, None, stride, pad, dil))


def shape_record(key, seed, variants=None, check_n=16, plain=False,
                 gather=False):
    """The committed kernel at one shape (and each of ``variants``,
    ``{name: library}``); see the module's docstring. ``plain`` adds the
    plain version's time at the full shape; ``gather`` the kernel's time
    with x gathered where the plan takes it by TMA (``gather_ms``)."""
    variants = variants or {}
    x, wq, scale, bias, out_dtype = operands(key, seed)
    padding, _ = _geometry(key)
    args = (key[7], padding, key[9])
    eargs = (scale, None, out_dtype) if out_dtype else (None, None, None)
    op = prepared(None, x, wq, key, *eargs)
    rec = dict(case=key_str(key), variant=op.plan.variant,
               tile_n=op.plan.tile_n, check_n=min(key[0], check_n))
    bound_ms, bound_by, ops, nbytes = bound(key)
    with torch.inference_mode():
        rec['equal'], rec['max_abs_err'] = equal_to_plain(
            None, x[:check_n], wq, key, scale, bias)
        rec['ms'] = median_ms(lambda: q8.launch(op))
        op32 = prepared(None, x, wq, key)
        rec['ms_int32'] = median_ms(lambda: q8.launch(op32))
        del op32
        wp = q8.pack_weight(wq)
        rec['wrapper_ms'] = median_ms(lambda: q8.launch(q8.prepare(
            x, wp, *args, *eargs)))
        if gather and 'tma' in op.plan.variant:
            og = prepared(None, x, wq, key, *eargs, gather=True)
            rec['gather_ms'] = median_ms(lambda: q8.launch(og))
            del og
        for name, lib in variants.items():
            # an older build refuses a path of x it does not have: gather
            gathered = False
            try:
                eq, _ = equal_to_plain(lib, x[:check_n], wq, key, scale,
                                       bias)
            except RuntimeError:
                gathered = True
                eq, _ = equal_to_plain(lib, x[:check_n], wq, key, scale,
                                       bias, gather=True)
            vop = prepared(lib, x, wq, key, *eargs, gather=gathered)
            rec.setdefault('variants', {})[name] = dict(
                equal=eq, gathered=gathered,
                ms=median_ms(lambda: q8.launch(vop, lib)),
                wrapper_ms=median_ms(lambda: q8.launch(prepared(
                    lib, x, wq, key, *eargs, gather=gathered), lib)))
            del vop
        del op
        rec['library_ms'], note = library_ms(key, x, wq)
        if note:
            rec['library_note'] = note
        rec['bf16_ms'] = bf16_ms(key)
        if plain:
            rec['plain_ms'] = median_ms(lambda: q8.int8_conv_plain(
                x, wq, *args, *eargs), runs=3, warmup=1)
    rec.update(bound_ms=bound_ms, bound_by=bound_by, ops=ops, bytes=nbytes,
               share_of_bound=bound_ms / rec['ms'])
    del x, wq
    torch.cuda.empty_cache()
    return rec


def build_variants(specs, out_dir):
    """``{name: library}`` of ``NAME=@FILE.cu`` specs, compiled at once."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, spec in enumerate(specs):
        name, _, src = spec.partition('=')
        path = os.path.join(out_dir, f'libint8_variant{i}.so')
        procs[name] = (path, subprocess.Popen(
            [_cuda._nvcc()] + _cuda.NVCC_FLAGS + [
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
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in q8._SIGNATURES.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variant', action='append', default=[])
    ap.add_argument('--check-n', type=int, default=16)
    ap.add_argument('--gather', action='store_true',
                    help='also time the TMA shapes with x gathered')
    ap.add_argument('--shapes', default=None,
                    help='indices into PHASE12_SHAPES, comma-separated')
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('int8_bench: no CUDA device', file=sys.stderr)
        return 2
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip()
    lib = q8.library()
    for line in _cuda.build_logs.get('int8_conv', '').splitlines():
        if any(w in line for w in ('registers', 'spill', 'warning')):
            print(f'nvcc [committed]: {line.strip()}')
    del lib
    variants = build_variants(args.variant, os.path.join(
        _cuda.BUILD_DIR, 'int8_variants'))
    picks = (range(len(PHASE12_SHAPES)) if args.shapes is None else
             [int(i) for i in args.shapes.split(',')])
    records = []
    for i in picks:
        key = PHASE12_SHAPES[i]
        rec = shape_record(key, 1000 + i, variants, args.check_n,
                           gather=args.gather)
        records.append(rec)
        short = {k: rec[k] for k in ('case', 'variant', 'tile_n', 'equal',
                                     'ms', 'ms_int32', 'wrapper_ms',
                                     'library_ms', 'bf16_ms', 'bound_ms',
                                     'share_of_bound')}
        if 'gather_ms' in rec:
            short['gather_ms'] = rec['gather_ms']
        short['variants'] = {n: [v['equal'], v['ms'], v['wrapper_ms']]
                             for n, v in rec.get('variants', {}).items()}
        print('int8 bench: ' + json.dumps(short), flush=True)
    print(card)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(dict(card=card, records=records), f, indent=1)
    bad = [r['case'] for r in records if not r['equal'] or not all(
        v['equal'] for v in r.get('variants', {}).values())]
    if bad:
        print(f'int8_bench: differs from the plain version at {bad}',
              file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    sys.exit(main())
