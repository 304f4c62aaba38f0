"""Seeded weights and inputs, made on the device in a few large draws.

A state dict in the reference names (``reference.models.spec``), drawn
from one generator on the device: one normal draw for every weight and
BatchNorm affine and mean, one uniform draw for the running variances.
Convolutions and FCs have standard deviation 1/sqrt(fan_in), the MVF
taps 1/3 (the three views' sum keeps the variance of its input);
BatchNorm weights are 1 + N(0, 0.1^2), biases and running means
N(0, 0.1^2), running variances U(0.75, 1.25): eval-mode normalization is
not the identity.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Spec = List[Tuple[str, tuple, str]]
_NORMAL = ('conv', 'tap', 'fc', 'bn_weight', 'bn_bias', 'bn_mean',
           'fc_bias')


def derived_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (any integer)."""
    entropy = [seed % 2 ** 64, seed // 2 ** 64] + list(path)
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0]) >> 1


def generator(device, seed: int, *path: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, *path))


def _std(shape: tuple, kind: str) -> float:
    if kind in ('conv', 'fc'):
        return float(np.prod(shape[1:])) ** -0.5
    if kind == 'tap':
        return 1.0 / 3.0
    if kind == 'fc_bias':
        return 0.0
    return 0.1                                  # bn weight, bias, mean


def make_state(spec: Spec, seed: int, device,
               residual_gamma: float = 1.0) -> Dict[str, torch.Tensor]:
    """The state dict of ``spec``, float32 (``num_batches_tracked``
    int64 zeros), on ``device``. The weight of the BatchNorm that ends
    each residual branch (``bn3``) is scaled by ``residual_gamma``."""
    g = generator(device, seed, 1)
    normal = [(n, s, k) for n, s, k in spec if k in _NORMAL]
    sizes = [int(np.prod(s)) for _, s, _ in normal]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    state = {}
    for (name, shape, kind), part in zip(normal, flat.split(sizes)):
        t = part.view(shape) * _std(shape, kind)
        if kind == 'bn_weight':
            t = t + 1.0
            if name.endswith('.bn3.weight'):
                t = t * residual_gamma
        state[name] = t
    var = [(n, s) for n, s, k in spec if k == 'bn_var']
    vsizes = [int(np.prod(s)) for _, s in var]
    vflat = torch.rand(sum(vsizes), generator=g, device=device) * 0.5 + 0.75
    for (name, shape), part in zip(var, vflat.split(vsizes)):
        state[name] = part.view(shape)
    for name, shape, kind in spec:
        if kind == 'count':
            state[name] = torch.zeros(shape, dtype=torch.int64, device=device)
    return {name: state[name].contiguous() for name, _, _ in spec}


def kinds(spec: Spec) -> Dict[str, str]:
    return {name: kind for name, _, kind in spec}


def uint8_frames(shape: tuple, count: int, seed: int, path: int,
                 device) -> List[np.ndarray]:
    """``count`` uint8 frame arrays of ``shape`` (``(..., H, W, 3)``)
    drawn on ``device`` and kept in host memory, as a loader hands them to
    the entry. Each array has colours, contrast and smooth content of its
    own that change over its frames (a per-channel base and a spread that
    drift from one end to the other, noise at 1/16 of the size upsampled,
    and pixel noise): different arrays get different answers, and so do
    the clips of one array."""
    import torch.nn.functional as F
    g = generator(device, seed, path)
    *lead, h, w, c = shape
    n = int(np.prod(lead))
    t = torch.linspace(0, 1, n, device=device).view(n, 1, 1, 1)
    out = []
    for _ in range(count):
        base0, base1 = (torch.rand(c, generator=g, device=device) * 175 + 40
                        for _ in range(2))
        spread0, spread1 = (torch.rand(1, generator=g, device=device) * 40
                            + 20 for _ in range(2))
        base = base0.view(1, c, 1, 1) * (1 - t) + base1.view(1, c, 1, 1) * t
        spread = spread0 * (1 - t) + spread1 * t
        low = torch.randn(n, c, max(h // 16, 1), max(w // 16, 1),
                          generator=g, device=device)
        low = F.interpolate(low, size=(h, w), mode='bilinear',
                            align_corners=False)
        noise = torch.randn(n, c, h, w, generator=g, device=device)
        x = base + spread * (0.8 * low + 0.6 * noise)
        x = x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
        out.append(x.reshape(shape).cpu().numpy())
        del low, noise, x
    return out


def labels(count: int, batch: int, classes: int, seed: int,
           path: int) -> List[np.ndarray]:
    rng = np.random.default_rng(derived_seed(seed, path))
    return [rng.integers(0, classes, batch).astype(np.int64)
            for _ in range(count)]
