"""Int8 convolution with exact int32 accumulation, and the quantize passes
around it.

The JAX package's eval-only int8 path convolves int8 activations with int8
weights through ``lax.conv_general_dilated(..., preferred_element_type=
int32)`` (``mvfnet_tpu/models/common.py`` ``QuantConv2d`` / ``QuantConv3d``,
the split conv1 and the space-to-depth stem of
``mvfnet_tpu/models/backbones/resnet.py``). PyTorch has no int8 convolution
on CUDA, so the port computes it in a hand-written kernel,
``csrc/int8_conv.cu`` (an implicit GEMM on ``mma.sync`` s8 tensor cores).

Layouts: x int8 ``(N, T, H, W, Cin)`` channels last, w int8 ``(kt, kh, kw,
Cin, Cout)``; a 2-D conv is T = kt = 1. ``stride``, ``dilation`` are per
axis (T, H, W) and ``padding`` a ``(before, after)`` pair per axis. The
result is int32 ``(N, To, Ho, Wo, Cout)``, or, with ``scale`` (and
``bias``), ``acc`` as float32 times ``scale[c]`` plus ``bias[c]`` cast to
``out_dtype``.

``int8_conv`` takes the plain version for a CPU (or meta) tensor and the
kernel for a CUDA tensor; a failed build or launch raises, nothing falls
back. The plain version convolves the int8 values in float64, exact while
|acc| < 2^53 (K * 127^2 is far below), and rounds the epilogue as the kernel
does: float32 product, then the bias added, then one cast.

The activation quantize pass (``quantize_activation``), the weight quantize
pass (``quantize_weight``) and the integer carry's requantize pass
(``requantize_carry``) are PyTorch ops, as XLA computes them outside any
kernel in the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

# |acc| <= K * 127^2 must stay below 2^31
MAX_K = (2 ** 31 - 1) // (127 * 127)

_EPILOGUE = {None: 0, torch.float32: 1, torch.bfloat16: 2}

_SIGNATURES = {
    'int8_conv_launch': (
        [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                 ctypes.c_void_p], ctypes.c_int),
}

Triple = Tuple[int, int, int]


def library():
    """The kernel's library, built from ``csrc/int8_conv.cu`` on first
    use."""
    return _cuda.library('int8_conv', _SIGNATURES)


def quantize_weight(w: torch.Tensor, channel_dim: int = 0):
    """Per-output-channel symmetric int8 weights: ``(wq, sw)`` with ``sw =
    max(max|w| / 127, 1e-12)`` over every axis but ``channel_dim``, in w's
    dtype, and ``wq = clip(round(w / sw), -127, 127)`` (round half to even,
    as ``jnp.round``)."""
    dims = [d for d in range(w.ndim) if d != channel_dim]
    sw = (w.abs().amax(dim=dims) / 127.0).clamp(min=1e-12)
    shape = [1] * w.ndim
    shape[channel_dim] = -1
    wq = torch.round(w / sw.reshape(shape)).clamp(-127, 127).to(torch.int8)
    return wq, sw


def activation_scale(amax: torch.Tensor) -> torch.Tensor:
    """The per-tensor scale of an abs-max: ``max(amax / 127, 1e-12)``."""
    return (amax / 127.0).clamp(min=1e-12)


def quantize_activation(xf: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(round(xf / sx), -127, 127)`` as int8; ``xf`` float32."""
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8)


def requantize_carry(acc: torch.Tensor, scale: torch.Tensor,
                     a: torch.Tensor, b: torch.Tensor,
                     sx: torch.Tensor) -> torch.Tensor:
    """The integer carry's one pass from a conv's int32 accumulator to the
    next conv's int8 input, channels on the last axis: the BN affine
    ``(a, b)`` and the ReLU folded into ``clip(round(acc * (a * scale /
    sx) + b / sx), 0, 127)``."""
    m = (a * scale) / sx
    z = acc.to(torch.float32) * m + (b / sx)
    return torch.round(z).clamp(0, 127).to(torch.int8)


def _out_size(size: int, k: int, s: int, pad: Tuple[int, int],
              d: int) -> int:
    return (size + pad[0] + pad[1] - d * (k - 1) - 1) // s + 1


def _check(x: torch.Tensor, w: torch.Tensor, stride: Triple,
           padding: Sequence[Tuple[int, int]], dilation: Triple):
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f'int8 conv takes int8 operands, got {x.dtype} and '
                        f'{w.dtype}')
    if x.ndim != 5 or w.ndim != 5 or x.shape[-1] != w.shape[3]:
        raise ValueError(f'int8 conv: x (N, T, H, W, Cin) {tuple(x.shape)} '
                         f'and w (kt, kh, kw, Cin, Cout) {tuple(w.shape)}')
    if len(stride) != 3 or len(padding) != 3 or len(dilation) != 3:
        raise ValueError('int8 conv: one stride, padding pair and dilation '
                         'per axis (T, H, W)')
    k = w.shape[0] * w.shape[1] * w.shape[2] * w.shape[3]
    if k > MAX_K:
        raise ValueError(f'int8 conv: K = {k} could overflow the int32 '
                         f'accumulator (K * 127^2 >= 2^31)')
    out = [_out_size(x.shape[1 + i], w.shape[i], stride[i], padding[i],
                     dilation[i]) for i in range(3)]
    if min(out) < 1:
        raise ValueError(f'int8 conv: empty output {out}')
    return out


def _epilogue_plain(acc: torch.Tensor, scale, bias, out_dtype):
    if scale is None:
        return acc
    out = acc.to(torch.float32) * scale
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def int8_conv_plain(x: torch.Tensor, w: torch.Tensor, stride: Triple,
                    padding: Sequence[Tuple[int, int]], dilation: Triple,
                    scale: Optional[torch.Tensor] = None,
                    bias: Optional[torch.Tensor] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The same function with ``F.conv2d`` / ``F.conv3d`` on the int8 values
    in float64. ``scale`` and ``bias`` may be of any float dtype: the
    product is taken as ``acc.float() * scale``, as the JAX package does."""
    _check(x, w, stride, padding, dilation)
    xd = x.to(torch.float64).permute(0, 4, 1, 2, 3)        # N C T H W
    wd = w.to(torch.float64).permute(4, 3, 0, 1, 2)        # O I kt kh kw
    (pt0, pt1), (ph0, ph1), (pw0, pw1) = padding
    xd = F.pad(xd, (pw0, pw1, ph0, ph1, pt0, pt1))
    if x.shape[1] == 1 and w.shape[0] == 1:
        acc = F.conv2d(xd[:, :, 0], wd[:, :, 0], stride=stride[1:],
                       dilation=dilation[1:])[:, :, None]
    else:
        acc = F.conv3d(xd, wd, stride=stride, dilation=dilation)
    acc = acc.permute(0, 2, 3, 4, 1).to(torch.int32)
    return _epilogue_plain(acc, scale, bias, out_dtype)


def int8_conv_cuda(x: torch.Tensor, w: torch.Tensor, stride: Triple,
                   padding: Sequence[Tuple[int, int]], dilation: Triple,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel on x's current CUDA stream (no sync). Counts each
    launch in ``launches`` and, by ``int8_conv_key``, in
    ``launches_by_shape``."""
    if x.device.type != 'cuda':
        raise ValueError(f'int8_conv_cuda needs a CUDA tensor, got '
                         f'{x.device}')
    to, ho, wo = _check(x, w, stride, padding, dilation)
    if w.device != x.device:
        raise ValueError('int8 conv operands must share x.device')
    epi = out_dtype if scale is not None else None
    if epi not in _EPILOGUE:
        raise TypeError(f'int8 conv epilogue writes float32 or bfloat16, '
                        f'not {out_dtype}')
    n, cout = x.shape[0], w.shape[-1]
    xc = x.contiguous()
    wt = w.permute(4, 0, 1, 2, 3).contiguous()     # (Cout, kt, kh, kw, Cin)
    sc = bi = None
    if scale is not None:
        sc = scale.to(device=x.device, dtype=torch.float32).reshape(-1)
        sc = sc.expand(cout).contiguous()
        if bias is not None:
            bi = bias.to(device=x.device, dtype=torch.float32).reshape(-1)
            bi = bi.expand(cout).contiguous()
    out = torch.empty((n, to, ho, wo, cout), device=x.device,
                      dtype=torch.int32 if epi is None else epi)
    dims = (ctypes.c_int * 21)(
        *x.shape, to, ho, wo, cout, *w.shape[:3], *stride,
        *(p[0] for p in padding), *dilation)
    lib = library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_conv_launch(
            xc.data_ptr(), wt.data_ptr(), out.data_ptr(),
            sc.data_ptr() if sc is not None else None,
            bi.data_ptr() if bi is not None else None, dims, _EPILOGUE[epi],
            stream)
    _cuda.check(err, 'int8_conv')
    int8_conv_cuda.launches += 1
    int8_conv_cuda.launches_by_shape[int8_conv_key(
        x, w, stride, padding, dilation, epi)] += 1
    return out


int8_conv_cuda.launches = 0
int8_conv_cuda.launches_by_shape = collections.Counter()


def int8_conv_key(x, w, stride, padding, dilation, epilogue) -> tuple:
    """A launch's shape: ``(N, T, H, W, Cin, Cout, (kt, kh, kw), stride,
    padding before each axis, dilation, epilogue dtype name or 'int32')``."""
    return (tuple(x.shape) + (w.shape[-1], tuple(w.shape[:3]), tuple(stride),
                              tuple(p[0] for p in padding), tuple(dilation),
                              str(epilogue).split('.')[-1]
                              if epilogue is not None else 'int32'))


def int8_conv(x: torch.Tensor, w: torch.Tensor, stride: Triple,
              padding: Sequence[Tuple[int, int]], dilation: Triple,
              scale: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Dispatch: the plain version for a CPU or meta tensor, the kernel for a
    CUDA tensor."""
    if x.device.type in ('cpu', 'meta'):
        return int8_conv_plain(x, w, stride, padding, dilation, scale, bias,
                               out_dtype)
    return int8_conv_cuda(x, w, stride, padding, dilation, scale, bias,
                          out_dtype)
