"""Fused eval-time ResNet bottleneck.

Counterpart of ``mvfnet_tpu/ops/fused_block.py``. A stride-1 residual
bottleneck with BatchNorm folded into the conv weights,

    out = relu(x + relu(conv3x3(relu(x.W1 + b1)) + b2).W3 + b3)

runs as one hand-written CUDA kernel (``csrc/fused_bottleneck.cu``) on the
card: x is read once, h1 and h2 stay in shared memory, out is written once.
At the flagship's shapes the block is bound by memory on an H100, and that
is what fusion buys (see the kernel source).

Layouts follow the JAX package: x NHWC ``(N, H, W, Cin)``, ``w1 (Cin, Cm)``,
``w2 (3, 3, Cm, Cm)`` HWIO, ``w3 (Cm, Cin)`` in x's dtype, biases fp32
``(1, C)``. The kernel reads the weights output-channel-major: weights that
are views of such storage (``out_major``, as ``Bottleneck`` caches them)
reach it without a copy, others are copied at each call.
``bottleneck_eval`` takes the plain version for a CPU tensor (or a meta
one, which only counts shapes and FLOPs) and the kernel for a CUDA tensor;
it never falls back on failure.
"""

from __future__ import annotations

import collections
import ctypes

import torch
import torch.nn.functional as F

from . import _cuda

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_SIGNATURES = {
    'fused_bottleneck_launch': (
        [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
        + [ctypes.c_void_p], ctypes.c_int),
    'fused_bottleneck_path': ([ctypes.c_int] * 5, ctypes.c_int),
}


def library():
    """The kernel's library, built from ``csrc/fused_bottleneck.cu`` on
    first use."""
    return _cuda.library('fused_bottleneck', _SIGNATURES)


def fold_bn(kernel: torch.Tensor, scale, bias, mean, var,
            eps: float = 1e-5):
    """Fold eval-time BatchNorm into the preceding conv.

    ``kernel`` has its output channel last. ``bn(conv(x)) == conv'(x) + b'``
    with ``W' = W * s/sqrt(v+eps)`` and ``b' = b - m * s/sqrt(v+eps)``.
    Computed in the parameters' dtype (fp32); the caller casts.
    """
    inv = scale * torch.rsqrt(var + eps)
    return kernel * inv, bias - mean * inv


def bottleneck_eval_plain(x, w1, b1, w2, b2, w3, b3):
    """The same math with ``F.conv2d`` (mirrors ``bottleneck_eval_jnp``)."""
    xc = x.permute(0, 3, 1, 2)                      # NCHW view of NHWC
    h = F.conv2d(xc, w1.t()[:, :, None, None])
    h = torch.relu(h + b1.reshape(1, -1, 1, 1).to(h.dtype)).to(x.dtype)
    h = F.conv2d(h, w2.permute(3, 2, 0, 1), padding=1)
    h = torch.relu(h + b2.reshape(1, -1, 1, 1).to(h.dtype)).to(x.dtype)
    h = F.conv2d(h, w3.t()[:, :, None, None])
    out = h + b3.reshape(1, -1, 1, 1).to(h.dtype) + xc.to(h.dtype)
    return torch.relu(out).to(x.dtype).permute(0, 2, 3, 1)


def out_major(w: torch.Tensor) -> torch.Tensor:
    """``w`` (output channel last) as a view of output-channel-major
    storage, the layout the kernel reads without a copy."""
    return w.transpose(-2, -1).contiguous().transpose(-2, -1)


def kernel_path(dtype: torch.dtype, h: int, w: int, cin: int, cm: int
                ) -> str:
    """Which CUDA kernel serves a shape: 'tiled' (bf16, Cin and Cm
    multiples of 64), 'general', or 'none' (does not fit shared memory)."""
    code = library().fused_bottleneck_path(
        _DTYPE_CODE[dtype], h, w, cin, cm)
    return {2: 'tiled', 1: 'general', 0: 'none'}[code]


def bottleneck_eval_cuda(x, w1, b1, w2, b2, w3, b3):
    """Launch the fused kernel on x's current CUDA stream (no sync).

    Counts each launch in ``launches`` and, by ``(dtype, N, H, W, Cin,
    Cm)``, in ``launches_by_shape``."""
    if x.device.type != 'cuda':
        raise ValueError(f'bottleneck_eval_cuda needs a CUDA tensor, got '
                         f'{x.device}')
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f'fused bottleneck takes bfloat16 or float32, got '
                        f'{x.dtype}')
    if x.ndim != 4 or not x.is_contiguous():
        raise ValueError('fused bottleneck needs a contiguous NHWC tensor '
                         '(the permute(0, 2, 3, 1) of a channels_last one)')
    n, h, w, cin = x.shape
    cm = w1.shape[-1]
    if cin % 8 or cm % 8:
        raise ValueError(f'fused bottleneck needs Cin and Cm divisible by 8, '
                         f'got Cin={cin} Cm={cm}')
    if (tuple(w1.shape) != (cin, cm) or tuple(w2.shape) != (3, 3, cm, cm)
            or tuple(w3.shape) != (cm, cin)):
        raise ValueError('fused bottleneck weight shapes: w1 (Cin,Cm), '
                         'w2 (3,3,Cm,Cm), w3 (Cm,Cin)')
    for name, b, c in (('b1', b1, cm), ('b2', b2, cm), ('b3', b3, cin)):
        if b.numel() != c or b.dtype != torch.float32:
            raise ValueError(f'{name} must hold {c} float32 values')
    for t in (w1, w2, w3):
        if t.dtype != x.dtype:
            raise TypeError('fused bottleneck weights must be in x.dtype')
    for t in (w1, w2, w3, b1, b2, b3):
        if t.device != x.device:
            raise ValueError('fused bottleneck operands must share x.device')
    if x.data_ptr() % 16:
        raise ValueError('fused bottleneck needs a 16-byte aligned x')
    code = _DTYPE_CODE[x.dtype]
    lib = library()
    if lib.fused_bottleneck_path(code, h, w, cin, cm) == 0:
        raise ValueError(f'fused bottleneck: a row of width {w} with '
                         f'Cin={cin} Cm={cm} does not fit shared memory')
    # output-channel-major weights, each B fragment row contiguous in K; a
    # no-op for views of out_major storage
    w1t = w1.t().contiguous()                   # (Cm, Cin)
    w2t = w2.permute(0, 1, 3, 2).contiguous()   # (3, 3, Cm_out, Cm_in)
    w3t = w3.t().contiguous()                   # (Cin, Cm)
    b1c, b2c, b3c = (b.reshape(-1).contiguous() for b in (b1, b2, b3))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_bottleneck_launch(
            code, x.data_ptr(), w1t.data_ptr(), b1c.data_ptr(),
            w2t.data_ptr(), b2c.data_ptr(), w3t.data_ptr(), b3c.data_ptr(),
            out.data_ptr(), n, h, w, cin, cm, stream)
    _cuda.check(err, 'fused_bottleneck')
    bottleneck_eval_cuda.launches += 1
    bottleneck_eval_cuda.launches_by_shape[
        (str(x.dtype).split('.')[-1], n, h, w, cin, cm)] += 1
    return out


bottleneck_eval_cuda.launches = 0
bottleneck_eval_cuda.launches_by_shape = collections.Counter()


def bottleneck_eval(x, w1, b1, w2, b2, w3, b3):
    """Dispatch: the plain version for a CPU or meta tensor, the kernel for
    a CUDA tensor."""
    if x.device.type in ('cpu', 'meta'):
        return bottleneck_eval_plain(x, w1, b1, w2, b2, w3, b3)
    return bottleneck_eval_cuda(x, w1, b1, w2, b2, w3, b3)
