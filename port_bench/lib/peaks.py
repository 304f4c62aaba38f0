"""The card's peaks and the hand kernels' least times.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside the tensor
cores, 3.35 TB/s of HBM. A kernel's bound is the larger of its operations
over the peak rate and its bytes over the bandwidth, each input byte read
once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

PEAK_FLOPS = {'bfloat16': 989e12, 'float16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12
ITEM = {'bfloat16': 2, 'float16': 2, 'float32': 4}


def fused_bottleneck_work(dtype: str, n: int, h: int, w: int, cin: int,
                          cm: int) -> Tuple[int, int]:
    """FLOPs and bytes of one fused eval bottleneck, ``relu(x + conv1x1(
    relu(conv3x3(relu(conv1x1(x) + b1)) + b2)) + b3)`` on NHWC ``x``
    (n, h, w, cin) with ``cm`` middle channels: three convs' multiply-adds;
    x read and the output written once, the three weights in ``dtype`` and
    the three fp32 biases read once."""
    item = ITEM[dtype]
    flops = 2 * n * h * w * (cin * cm + 9 * cm * cm + cm * cin)
    nbytes = (2 * n * h * w * cin * item + (2 * cin * cm + 9 * cm * cm) * item
              + (2 * cm + cin) * 4)
    return flops, nbytes


def ycc_to_bgr_bytes(frames: int, h: int, w: int) -> int:
    """Bytes of one ``ycc_to_bgr`` call on 4:2:0 JPEG planes: Y and the
    two half-size chroma planes read once, the BGR frames written once."""
    ch, cw = (h + 1) // 2, (w + 1) // 2
    return frames * (h * w + 2 * ch * cw + 3 * h * w)


def bound_s(flops: int, nbytes: int, dtype: str = 'bfloat16') -> float:
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES)


def fused_bottleneck_bound_s(launches: Dict[tuple, int]) -> float:
    """Summed bound of launches counted by ``(dtype, N, H, W, Cin, Cm)``,
    the key of the program's ``launches_by_shape`` counter."""
    total = 0.0
    for (dtype, n, h, w, cin, cm), count in launches.items():
        total += count * bound_s(*fused_bottleneck_work(
            dtype, n, h, w, cin, cm), dtype)
    return total
