"""Weight carry into the port (counterpart of ``mvfnet_tpu/utils/checkpoint.py``).

- ``state_dict_from_jax``: the JAX package's recognizer variables
  (``{'params', 'batch_stats'}`` as nested dicts of numpy arrays) -> the
  port's ``state_dict`` in the reference torch vocabulary. It inverts the
  JAX importer's layout changes: HWIO conv kernels -> OIHW, ``(3, C)`` MVF
  taps -> Conv3d-shaped ``(C, 1, kT, kH, kW)``, Dense ``(in, out)`` ->
  Linear ``(out, in)``, and the BN names. ``jax_entries`` gives the same
  mapping leaf by leaf, with each leaf's JAX path.
- ``load_torch_state_dict``: a reference ``.pth`` -> ``{name: tensor}``.
- ``import_torch_state_dict``: the non-strict import of a reference or
  torchvision state dict into a port model, with the JAX importer's key
  rules (``mvfnet_tpu/utils/checkpoint.py::import_torch_weights``) for the
  vocabularies the port has models for.
- ``save_checkpoint`` / ``load_checkpoint``: the train loop's checkpoints.
  The JAX package writes ``.msgpack`` files with a ``.meta.json`` sidecar;
  the port writes ``.pth`` files in mmcv's layout, ``{'meta': {'epoch',
  'iter'}, 'state_dict', 'optimizer'}``, with the model in the reference
  vocabulary, so the JAX package's ``import_torch_weights`` reads them.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .logging import get_root_logger

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


def _strip_module(key: str) -> str:
    return key[len('module.'):] if key.startswith('module.') else key


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference torch checkpoint: raw state dicts or
    ``{'state_dict': ...}`` wrappers, ``module.`` prefixes stripped."""
    return load_checkpoint(path)[0]


# ------------------------------------------------------- non-strict import

_HEAD_ALIASES = ('new_fc', 'new_cls', 'fc_cls')
_BLOCK_CONV1 = re.compile(r'(backbone\.layer\d+\.\d+\.conv1)(\.net)?\.weight$')


def _port_name(key: str, targets) -> Optional[str]:
    """The port name a reference or torchvision key loads into, or None for
    a key skipped on purpose (torchvision's classifier: the recognizer's
    head trains fresh). A name that is not in ``targets`` is unexpected."""
    parts = key.split('.')
    if parts[0] == 'cls_head':
        # new_fc: TSNClsHead; new_cls: its fcn alias; fc_cls: I3D heads
        if len(parts) > 1 and parts[1] in _HEAD_ALIASES:
            return 'cls_head.new_fc.' + ('weight' if parts[-1] == 'weight'
                                         else 'bias')
        return key
    if parts[0] == 'fc':
        return None
    name = key if parts[0] == 'backbone' else 'backbone.' + key
    m = _BLOCK_CONV1.match(name)
    if m and name not in targets:
        # MVF wraps a block's conv1 as conv1.net: a plain ResNet's conv1
        # is the same weight, and the other way round
        other = m.group(1) + ('.weight' if m.group(2) else '.net.weight')
        if other in targets:
            return other
    return name


def import_torch_state_dict(model: torch.nn.Module,
                            state_dict: Dict[str, Any],
                            inflate_in_channels: Optional[int] = None,
                            logger=None) -> Dict[str, List[str]]:
    """Non-strict import of a reference or torchvision state dict into
    ``model`` in place; returns the report ``{applied, missing, unexpected,
    mismatched}`` in port names (``unexpected`` keeps the source's keys).

    The key rules of the JAX package's ``import_torch_weights``
    (``mvfnet_tpu/utils/checkpoint.py:165-492``) for the 2-D Bottleneck
    ResNet, MVF and the TSN head: ``module.`` prefixes are stripped,
    ``num_batches_tracked`` and torchvision's ``fc.*`` are skipped,
    ``cls_head.{new_fc,new_cls,fc_cls}.*`` load into ``cls_head.new_fc``, a
    key without ``backbone.`` loads into the backbone, and a block's
    ``conv1.weight`` and ``conv1.net.weight`` stand for each other. A key of
    the wrong size is skipped and reported as mismatched and, as in the JAX
    importer, also as unexpected; a key the model lacks is unexpected; a
    model entry no key reached keeps its value and is reported missing.
    ``inflate_in_channels`` (10 for Flow, 15 for RGBDiff) turns an RGB stem
    into the mean over its input channels, broadcast. The vocabularies the
    port has no model for (BNInception, MobileNet, I3D, SlowFast, X3D,
    R(2+1)D, TRN, non-local) end up unexpected.
    """
    logger = logger or get_root_logger()
    targets = model.state_dict()
    applied: List[str] = []
    unexpected: List[str] = []
    mismatched: List[str] = []
    updates: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        key = _strip_module(key)
        if key.endswith('num_batches_tracked'):
            continue
        name = _port_name(key, targets)
        if name is None:
            continue
        if name not in targets or name.endswith('num_batches_tracked'):
            unexpected.append(key)
            continue
        value = torch.as_tensor(value)
        if (inflate_in_channels is not None
                and name == 'backbone.conv1.weight' and value.ndim == 4
                and value.shape[1] == 3 and inflate_in_channels != 3):
            value = value.mean(dim=1, keepdim=True).expand(
                -1, inflate_in_channels, -1, -1)
        target = targets[name]
        if value.shape != target.shape:
            mismatched.append(f'{name}: ckpt {tuple(value.shape)} vs model '
                              f'{tuple(target.shape)}')
            unexpected.append(key)
            continue
        updates[name] = value
        applied.append(name)
    with torch.no_grad():
        for name, value in updates.items():
            targets[name].copy_(value)
    done = set(applied)
    missing = [n for n in targets
               if n not in done and not n.endswith('num_batches_tracked')]
    for what, keys, log in (
            ('size-mismatched keys skipped (non-strict load)', mismatched,
             logger.warning),
            ('unexpected keys in source state_dict', unexpected, logger.info),
            ('params not found in source state_dict', missing, logger.info)):
        if keys:
            log('%s: %s', what, ', '.join(keys[:20])
                + (' ...' if len(keys) > 20 else ''))
    return dict(applied=applied, missing=missing, unexpected=unexpected,
                mismatched=mismatched)


# ------------------------------------------------------- train checkpoints

def save_checkpoint(path: str, model: torch.nn.Module, optimizer=None,
                    meta: Optional[Dict[str, Any]] = None) -> None:
    """Write ``{'meta', 'state_dict', 'optimizer'}`` to ``path`` (``.pth``)
    atomically: a temporary file in the same directory, then
    ``os.replace``. The weights are written from host copies."""
    payload: Dict[str, Any] = {
        'meta': dict(meta or {}),
        'state_dict': {k: v.detach().cpu()
                       for k, v in model.state_dict().items()}}
    if optimizer is not None:
        payload['optimizer'] = optimizer.state_dict()
    dirpath = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirpath, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirpath, suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            torch.save(payload, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, Any]],
                                        Dict[str, Any]]:
    """``(state_dict, optimizer_state, meta)`` of a torch checkpoint on the
    host, ``module.`` prefixes stripped; a raw state dict gives no
    optimizer state and an empty meta. The JAX package's ``.msgpack``
    checkpoints raise."""
    if path.endswith('.msgpack'):
        raise NotImplementedError(
            f'{path}: the .msgpack checkpoint reader is not ported yet '
            '(ROADMAP.md, A6); the port reads and writes .pth')
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    wrapped = isinstance(ckpt, dict) and 'state_dict' in ckpt
    sd = ckpt['state_dict'] if wrapped else ckpt
    sd = {_strip_module(k): v for k, v in sd.items()
          if isinstance(v, torch.Tensor)}
    if not wrapped:
        return sd, None, {}
    return sd, ckpt.get('optimizer'), dict(ckpt.get('meta') or {})
