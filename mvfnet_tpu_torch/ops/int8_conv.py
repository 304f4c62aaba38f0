"""Int8 convolution with exact int32 accumulation, and the quantize passes
around it.

The JAX package's eval-only int8 path convolves int8 activations with int8
weights through ``lax.conv_general_dilated(..., preferred_element_type=
int32)`` (``mvfnet_tpu/models/common.py`` ``QuantConv2d`` / ``QuantConv3d``,
the split conv1 and the space-to-depth stem of
``mvfnet_tpu/models/backbones/resnet.py``). PyTorch has no int8 convolution
on CUDA, so the port computes it in a hand-written kernel,
``csrc/int8_conv.cu`` (an implicit GEMM on ``wgmma`` s8 tensor cores: x by
TMA where it is the im2col matrix, a 1x1 stride-1 conv, or where a box of
it a tap makes a tile, else gathered).
``plan`` chooses the kernel's variant and tile width per shape and
zero-pads Cin to a multiple of 16; the quantized modules hand the weight
over in the kernel's layout (``int8_conv_packed``).

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
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _cuda

# |acc| <= K * 127^2 must stay below 2^31
MAX_K = (2 ** 31 - 1) // (127 * 127)

_EPILOGUE = {None: 0, torch.float32: 1, torch.bfloat16: 2}
# the kernel's tile widths (output channels a block), and the multiple of
# Cin it takes (a 16-byte piece of K lies in one tap)
TILE_WIDTHS = (64, 128, 256)
CIN_ALIGN = 16

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


class Plan(NamedTuple):
    """How the kernel runs one shape: ``variant`` (``'tma'`` where x's
    im2col matrix is x itself, a 1x1 stride-1 unpadded conv; ``'tma_taps'``
    where each 128-row tile of it is one box of x a tap, see
    ``taps_box``; both by TMA; ``'gather'`` where x's rows are gathered;
    any of them with ``'padded_'`` in front where Cin is zero-padded to
    ``cin``, a multiple of 16, first), ``cin`` and ``tile_n``, the output
    channels a block computes (the kernel's BN)."""
    variant: str
    cin: int
    tile_n: int


# the kernel's A path for each variant (dims[22] of its C interface)
A_PATH = {'gather': 0, 'tma': 1, 'tma_taps': 2}


def taps_box(cin: int, kernel: Triple, stride: Triple,
             padding: Sequence[Tuple[int, int]],
             out: Sequence[int]) -> Optional[Tuple[int, int]]:
    """``(rows, images)`` of the box of x (channels last, frames as images)
    that holds one tap's stage of Cin (128 bytes, or 64 where Cin is an odd
    multiple of 64) for 128 consecutive output pixels, ``rows`` output
    rows of ``images`` images, or None where there is none: the conv must
    move in H and W only (kt = 1, no temporal stride or padding), Cin a
    multiple of 64 (a stage in one tap), and 128 pixels whole rows of one
    image or whole images; a box spans at most 256 elements of x along an
    axis."""
    to, ho, wo = out
    if (kernel[0] != 1 or stride[0] != 1 or tuple(padding[0]) != (0, 0)
            or cin % 64):
        return None
    if ho * wo % 128 == 0 and 128 % wo == 0:
        rows, images = 128 // wo, 1
    elif 128 % (ho * wo) == 0:
        rows, images = ho, 128 // (ho * wo)
    else:
        return None
    if wo * stride[2] > 256 or rows * stride[1] > 256:
        return None
    return rows, images


def plan(x_shape: Sequence[int], cout: int, kernel: Triple, stride: Triple,
         padding: Sequence[Tuple[int, int]], dilation: Triple) -> Plan:
    """The kernel's plan for a conv of x ``(N, T, H, W, Cin)``: Cin rounded
    up to a multiple of 16 (16-byte pieces of one tap); x's tiles by TMA
    where ``taps_box`` or the 1x1 stride-1 case allows, else gathered; and
    the narrowest tile width that covers Cout, or the widest (256) above
    it, so that x is read once for Cout <= 256."""
    cin = x_shape[-1]
    cin16 = -(-cin // CIN_ALIGN) * CIN_ALIGN
    out = [_out_size(x_shape[1 + i], kernel[i], stride[i], padding[i],
                     dilation[i]) for i in range(3)]
    if (tuple(kernel) == (1, 1, 1) and tuple(stride) == (1, 1, 1)
            and all(tuple(p) == (0, 0) for p in padding)):
        path = 'tma'
    elif taps_box(cin16, kernel, stride, padding, out):
        path = 'tma_taps'
    else:
        path = 'gather'
    tile_n = next((b for b in TILE_WIDTHS if b >= cout), TILE_WIDTHS[-1])
    return Plan(('padded_' if cin16 != cin else '') + path, cin16, tile_n)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``(kt, kh, kw, Cin, Cout)`` (the JAX layout) as the kernel's
    ``(Cout, kt, kh, kw, Cin)``, each output channel's K contiguous."""
    return w.permute(4, 0, 1, 2, 3).contiguous()


def unpack_weight(wp: torch.Tensor) -> torch.Tensor:
    """The kernel's ``(Cout, kt, kh, kw, Cin)`` as a ``(kt, kh, kw, Cin,
    Cout)`` view."""
    return wp.permute(1, 2, 3, 4, 0)


class Launch(NamedTuple):
    """One launch's operands in the kernel's layouts, its output and its
    arguments (``prepare``)."""
    x: torch.Tensor
    w: torch.Tensor
    out: torch.Tensor
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    dims: ctypes.Array
    epilogue: int
    plan: Plan


def _channel_vector(v, cout, device):
    return v.to(device=device, dtype=torch.float32).reshape(-1).expand(
        cout).contiguous()


def prepare(x: torch.Tensor, wp: torch.Tensor, stride: Triple,
            padding: Sequence[Tuple[int, int]], dilation: Triple,
            scale: Optional[torch.Tensor] = None,
            bias: Optional[torch.Tensor] = None,
            out_dtype: Optional[torch.dtype] = None) -> Launch:
    """Check a call with a packed weight ``wp`` ``(Cout, kt, kh, kw,
    Cin)``, zero-pad Cin where the plan says so, make scale and bias
    contiguous float32 of length Cout (once), and allocate the output."""
    if x.device.type != 'cuda':
        raise ValueError(f'int8_conv_cuda needs a CUDA tensor, got '
                         f'{x.device}')
    to, ho, wo = _check(x, unpack_weight(wp), stride, padding, dilation)
    if wp.device != x.device:
        raise ValueError('int8 conv operands must share x.device')
    epi = out_dtype if scale is not None else None
    if epi not in _EPILOGUE:
        raise TypeError(f'int8 conv epilogue writes float32 or bfloat16, '
                        f'not {out_dtype}')
    n, cin, cout = x.shape[0], x.shape[-1], wp.shape[0]
    p = plan(x.shape, cout, wp.shape[1:4], stride, padding, dilation)
    if p.cin != cin:
        x = F.pad(x, (0, p.cin - cin))
        wp = F.pad(wp, (0, p.cin - cin))
    xc, wc = x.contiguous(), wp.contiguous()
    sc = bi = None
    if scale is not None:
        sc = _channel_vector(scale, cout, x.device)
        if bias is not None:
            bi = _channel_vector(bias, cout, x.device)
    out = torch.empty((n, to, ho, wo, cout), device=x.device,
                      dtype=torch.int32 if epi is None else epi)
    dims = (ctypes.c_int * 23)(
        *xc.shape, to, ho, wo, cout, *wc.shape[1:4], *stride,
        *(q[0] for q in padding), *dilation, p.tile_n,
        A_PATH[p.variant.replace('padded_', '')])
    return Launch(xc, wc, out, sc, bi, dims, _EPILOGUE[epi], p)


def launch(op: Launch, lib=None) -> torch.Tensor:
    """Launch the prepared call on x's current CUDA stream (no sync), with
    ``lib`` (another build of the kernel's source) or the committed one;
    a failed launch raises. Counts nothing."""
    lib = lib or library()
    with torch.cuda.device(op.x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.int8_conv_launch(
            op.x.data_ptr(), op.w.data_ptr(), op.out.data_ptr(),
            op.scale.data_ptr() if op.scale is not None else None,
            op.bias.data_ptr() if op.bias is not None else None, op.dims,
            op.epilogue, stream)
    _cuda.check(err, 'int8_conv')
    return op.out


def int8_conv_packed_cuda(x: torch.Tensor, wp: torch.Tensor, stride: Triple,
                          padding: Sequence[Tuple[int, int]],
                          dilation: Triple,
                          scale: Optional[torch.Tensor] = None,
                          bias: Optional[torch.Tensor] = None,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """The kernel on a packed weight: ``prepare``, then ``launch``. Counts
    each launch in ``int8_conv_cuda.launches``, by ``int8_conv_key`` in
    ``launches_by_shape`` and by plan variant in ``launches_by_variant``."""
    op = prepare(x, wp, stride, padding, dilation, scale, bias, out_dtype)
    out = launch(op)
    int8_conv_cuda.launches += 1
    int8_conv_cuda.launches_by_shape[int8_conv_key(
        x, unpack_weight(wp), stride, padding, dilation,
        out_dtype if scale is not None else None)] += 1
    int8_conv_cuda.launches_by_variant[op.plan.variant] += 1
    return out


def int8_conv_cuda(x: torch.Tensor, w: torch.Tensor, stride: Triple,
                   padding: Sequence[Tuple[int, int]], dilation: Triple,
                   scale: Optional[torch.Tensor] = None,
                   bias: Optional[torch.Tensor] = None,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the kernel on x's current CUDA stream (no sync), w in the JAX
    layout. Counts each launch in ``launches``, by ``int8_conv_key`` in
    ``launches_by_shape`` and by plan variant in ``launches_by_variant``."""
    _check(x, w, stride, padding, dilation)
    return int8_conv_packed_cuda(x, pack_weight(w), stride, padding,
                                 dilation, scale, bias, out_dtype)


int8_conv_cuda.launches = 0
int8_conv_cuda.launches_by_shape = collections.Counter()
int8_conv_cuda.launches_by_variant = collections.Counter()


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


def int8_conv_packed_plain(x: torch.Tensor, wp: torch.Tensor,
                           stride: Triple,
                           padding: Sequence[Tuple[int, int]],
                           dilation: Triple,
                           scale: Optional[torch.Tensor] = None,
                           bias: Optional[torch.Tensor] = None,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """``int8_conv_plain`` on a packed weight ``(Cout, kt, kh, kw, Cin)``."""
    return int8_conv_plain(x, unpack_weight(wp), stride, padding, dilation,
                           scale, bias, out_dtype)


def int8_conv_packed(x: torch.Tensor, wp: torch.Tensor, stride: Triple,
                     padding: Sequence[Tuple[int, int]], dilation: Triple,
                     scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """``int8_conv`` with the weight in the kernel's layout ``(Cout, kt, kh,
    kw, Cin)``, as the quantized modules hand it over: the plain version
    for a CPU or meta tensor, the kernel for a CUDA tensor."""
    if x.device.type in ('cpu', 'meta'):
        return int8_conv_packed_plain(x, wp, stride, padding, dilation,
                                      scale, bias, out_dtype)
    return int8_conv_packed_cuda(x, wp, stride, padding, dilation, scale,
                                 bias, out_dtype)
