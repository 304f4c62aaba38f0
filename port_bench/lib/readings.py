"""Arithmetic shared by the per-layer metrics' readers, over the dict a
driver's ``traced`` returns: ``items_unprofiled`` requests or steps in
``wall_unprofiled_s`` of an unprofiled stretch, ``items_profiled`` of
them in a profiled one whose device was busy ``busy_s``, and
``flops_per_item`` from the reference model's shapes."""

from __future__ import annotations

from typing import Optional

from .peaks import PEAK_FLOPS


def wall_per_item_s(t: dict) -> float:
    return t['wall_unprofiled_s'] / t['items_unprofiled']


def busy_per_item_s(t: dict) -> float:
    return t['busy_s'] / t['items_profiled']


def idle_share_pct(t: dict, kind: str) -> Optional[float]:
    if t.get('kind') != kind:
        return None
    return 100.0 * (1.0 - busy_per_item_s(t) / wall_per_item_s(t))


def mfu_pct(t: dict, kind: str, dtype: str = 'bfloat16') -> Optional[float]:
    if t.get('kind') != kind:
        return None
    return 100.0 * t['flops_per_item'] / wall_per_item_s(t) / PEAK_FLOPS[dtype]


def busy_ms(t: dict, kind: str) -> Optional[float]:
    if t.get('kind') != kind:
        return None
    return 1e3 * busy_per_item_s(t)
