"""Weight carry into the port (counterpart of ``mvfnet_tpu/utils/checkpoint.py``).

- ``state_dict_from_jax``: the JAX package's recognizer variables
  (``{'params', 'batch_stats'}`` as nested dicts of numpy arrays) -> the
  port's ``state_dict`` in the reference torch vocabulary. It inverts the
  JAX importer's layout changes: HWIO conv kernels -> OIHW, ``(3, C)`` MVF
  taps -> Conv3d-shaped ``(C, 1, kT, kH, kW)``, Dense ``(in, out)`` ->
  Linear ``(out, in)``, and the BN names. ``jax_entries`` gives the same
  mapping leaf by leaf, with each leaf's JAX path.
- ``load_torch_state_dict``: a reference ``.pth`` -> ``{name: tensor}``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_BN_LEAF = {'scale': 'weight', 'bias': 'bias', 'mean': 'running_mean',
            'var': 'running_var'}
_MVF_LEAF = {'bn_scale': 'bn.weight', 'bn_bias': 'bn.bias',
             'bn_mean': 'bn.running_mean', 'bn_var': 'bn.running_var'}
_TAP_SHAPE = {'shift_conv': (3, 1, 1), 'h_conv': (1, 3, 1),
              'w_conv': (1, 1, 3)}


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _module_name(name: str) -> str:
    """JAX module name -> torch module path ('layer3_0' -> 'layer3.0')."""
    m = re.fullmatch(r'layer(\d+)_(\d+)', name)
    if m:
        return f'layer{m.group(1)}.{m.group(2)}'
    return {'downsample_conv': 'downsample.0',
            'downsample_bn': 'downsample.1',
            'backbone_mod': 'backbone', 'head_mod': 'cls_head',
            'fc': 'new_fc'}.get(name, name)


def _torch_entry(path: Tuple[str, ...], value: np.ndarray,
                 mvf_blocks: set) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if mods and mods[-1] == 'MVF_0':
        block = '.'.join(_module_name(m) for m in mods[:-1])
        if leaf in _TAP_SHAPE:
            cs = value.shape[1]
            return (f'{block}.conv1.{leaf}.weight',
                    value.T.reshape((cs, 1) + _TAP_SHAPE[leaf]))
        return f'{block}.conv1.{_MVF_LEAF[leaf]}', value
    prefix = '.'.join(_module_name(m) for m in mods)
    if leaf == 'kernel' and value.ndim == 4:
        if mods[-1] == 'conv1' and '.'.join(
                _module_name(m) for m in mods[:-1]) in mvf_blocks:
            prefix += '.net'          # MVF wraps the block's conv1
        return f'{prefix}.weight', value.transpose(3, 2, 0, 1)
    if leaf == 'kernel' and value.ndim == 2:
        return f'{prefix}.weight', value.T
    if leaf in _BN_LEAF:                 # BN leaves and the Dense bias
        return f'{prefix}.{_BN_LEAF[leaf]}', value
    raise KeyError(f'no torch name for JAX variable {"/".join(path)}')


def jax_entries(variables: Dict[str, Any]
                ) -> Iterator[Tuple[str, str, str, np.ndarray]]:
    """``(collection, JAX path, port name, value in the port's layout)`` for
    each leaf of the JAX package's recognizer variables; the path is
    '/'-joined inside its collection, as optax's labels see it."""
    leaves = [(coll, path, v) for coll in ('params', 'batch_stats')
              for path, v in _leaves(variables.get(coll, {}))]
    mvf_blocks = {'.'.join(_module_name(m) for m in path[:-2])
                  for _, path, _ in leaves if 'MVF_0' in path}
    for coll, path, value in leaves:
        name, v = _torch_entry(path, value, mvf_blocks)
        yield coll, '/'.join(path), name, v


def state_dict_from_jax(variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the JAX package's recognizer variables.

    Values keep their dtype; every BatchNorm also gets a zero
    ``num_batches_tracked``, so the result loads with ``strict=True``.
    """
    out: Dict[str, torch.Tensor] = {}
    for _, _, name, v in jax_entries(variables):
        out[name] = torch.tensor(v)       # a copy: JAX arrays are read-only
        if name.endswith('.running_mean'):
            out[name[:-len('running_mean')] + 'num_batches_tracked'] = \
                torch.zeros((), dtype=torch.long)
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference torch checkpoint: raw state dicts or
    ``{'state_dict': ...}`` wrappers, ``module.`` prefixes stripped."""
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    sd = ckpt['state_dict'] if isinstance(ckpt, dict) and \
        'state_dict' in ckpt else ckpt
    return {(k[len('module.'):] if k.startswith('module.') else k): v
            for k, v in sd.items() if isinstance(v, torch.Tensor)}
