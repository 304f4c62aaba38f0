"""Weight carry into the port (counterpart of ``mvfnet_tpu/utils/checkpoint.py``).

- ``state_dict_from_jax``: the JAX package's recognizer variables
  (``{'params', 'batch_stats'}`` as nested dicts of numpy arrays) -> the
  port's ``state_dict`` in the reference torch vocabulary. It inverts the
  JAX importer's layout changes: HWIO conv kernels -> OIHW, ``(3, C)`` MVF
  taps -> Conv3d-shaped ``(C, 1, kT, kH, kW)``, Dense ``(in, out)`` ->
  Linear ``(out, in)``, and the BN names. ``jax_entries`` gives the same
  mapping leaf by leaf, with each leaf's JAX path;
  ``jax_variables_from_state_dict`` is its inverse.
- ``load_torch_state_dict``: a reference ``.pth`` -> ``{name: tensor}``.
- ``import_torch_state_dict``: the non-strict import of a reference or
  torchvision state dict into a port model, with the JAX importer's key
  rules (``mvfnet_tpu/utils/checkpoint.py::import_torch_weights``) for the
  vocabularies the port has models for. ``load_weights`` loads either
  checkpoint format into a model as the JAX package's CLIs do.
- ``save_checkpoint`` / ``load_checkpoint``: the train loop's checkpoints.
  The port's loop writes ``.pth`` files in mmcv's layout, ``{'meta':
  {'epoch', 'iter'}, 'state_dict', 'optimizer'}``, with the model in the
  reference vocabulary, so the JAX package's ``import_torch_weights`` reads
  them. The JAX package's loop writes ``.msgpack`` files (flax's
  serialization of ``{'variables', 'opt_state'}``, with a ``.meta.json``
  sidecar); ``load_checkpoint`` reads them and ``save_msgpack_checkpoint``
  writes them, through the port's own codec (``utils/msgpack_codec.py``).
- ``optax_state_from_optimizer`` / ``load_optax_state``: the SGD momentum
  buffers of ``engine.optim.ClippedSGD`` as the optax state of the JAX
  package's optimizer chain (``mvfnet_tpu/engine/optim.py:189-227``), and
  back.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .logging import get_root_logger
from .msgpack_codec import msgpack_restore, write_msgpack

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
_AVG_DOWN_CONV = re.compile(r'\.downsample\.1\.weight$')


def _shortcut_name(key: str, value) -> str:
    """The reference's avg_down shortcut ``Sequential(pool, conv, norm)``
    names its conv ``downsample.1`` and its norm ``downsample.2``; the
    port's (``resnet.Downsample``) names them ``downsample.0`` and
    ``downsample.1``, as the plain shortcut does. A 4-D
    ``downsample.1.weight`` is such a conv."""
    if '.downsample.2.' in key:
        return key.replace('.downsample.2.', '.downsample.1.')
    if _AVG_DOWN_CONV.search(key) and getattr(value, 'ndim', 0) == 4:
        return key.replace('.downsample.1.', '.downsample.0.')
    return key


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
    (``mvfnet_tpu/utils/checkpoint.py:165-492``) for the 2-D ResNet (its
    options included), MVF and the TSN head: ``module.`` prefixes are stripped,
    ``num_batches_tracked`` and torchvision's ``fc.*`` are skipped,
    ``cls_head.{new_fc,new_cls,fc_cls}.*`` load into ``cls_head.new_fc``, a
    key without ``backbone.`` loads into the backbone, and a block's
    ``conv1.weight`` and ``conv1.net.weight`` stand for each other. The
    reference's avg_down shortcut (pool, conv, norm at indices 0-2) loads
    into the port's (conv, norm at 0-1); the JAX importer takes its conv
    for the norm and reports it mismatched (ROADMAP.md, section C). A key of
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
        name = _port_name(_shortcut_name(key, value), targets)
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
    """``(state_dict, optimizer_state, meta)`` of a checkpoint on the host.

    A torch checkpoint gives its state dict with ``module.`` prefixes
    stripped, its torch optimizer state and its meta; a raw state dict gives
    no optimizer state and an empty meta. A ``.msgpack`` checkpoint of the
    JAX package gives ``state_dict_from_jax`` of its variables, its optax
    state as the nested dict flax stored (None when empty) and the
    ``.meta.json`` sidecar (``{}`` without one), as
    ``mvfnet_tpu/utils/checkpoint.py::load_checkpoint`` does.
    """
    if path.endswith('.msgpack'):
        return _load_msgpack(path)
    ckpt = torch.load(path, map_location='cpu', weights_only=False)
    wrapped = isinstance(ckpt, dict) and 'state_dict' in ckpt
    sd = ckpt['state_dict'] if wrapped else ckpt
    sd = {_strip_module(k): v for k, v in sd.items()
          if isinstance(v, torch.Tensor)}
    if not wrapped:
        return sd, None, {}
    return sd, ckpt.get('optimizer'), dict(ckpt.get('meta') or {})


def load_weights(model: torch.nn.Module, path: str,
                 logger=None) -> Dict[str, List[str]]:
    """A checkpoint's weights into ``model`` in place, as the JAX package's
    test CLI loads them (``test_recognizer.py::load_model_variables``);
    returns the import report of ``import_torch_state_dict``.

    A ``.pth`` loads non-strictly. A ``.msgpack`` loads as flax's
    ``from_state_dict`` restores the model's variables: an entry of the
    file the model lacks is reported unexpected, and a model entry the file
    lacks, or holds in another shape, raises.
    """
    report = import_torch_state_dict(model, load_checkpoint(path)[0],
                                     logger=logger)
    if path.endswith('.msgpack') and (report['missing']
                                      or report['mismatched']):
        raise ValueError(
            f'{path} does not match the model: missing '
            f'{report["missing"][:5]}, mismatched {report["mismatched"][:5]}')
    return report


# ------------------------------------------------------ .msgpack checkpoints

_COLLECTIONS = ('params', 'batch_stats')
# port name -> JAX path, applied in order to the name's module part
_JAX_MODULE_RULES = (
    (re.compile(r'^backbone\.'), 'backbone_mod.'),
    (re.compile(r'^cls_head\.new_fc\.'), 'head_mod.fc.'),
    (re.compile(r'\blayer(\d+)\.(\d+)\b'), r'layer\1_\2'),
    (re.compile(r'\bdownsample\.0\b'), 'downsample_conv'),
    (re.compile(r'\bdownsample\.1\b'), 'downsample_bn'),
    (re.compile(r'\bconv1\.net\b'), 'conv1'),
    (re.compile(r'\bconv1\.(shift_conv|h_conv|w_conv)\.weight$'),
     r'MVF_0.\1'),
    (re.compile(r'\bconv1\.bn\.(weight|bias|running_mean|running_var)$'),
     r'MVF_0.bn_\1'),
)
_JAX_LEAF = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
             'running_mean': ('batch_stats', 'mean'),
             'running_var': ('batch_stats', 'var'),
             'bn_weight': ('params', 'bn_scale'),
             'bn_bias': ('params', 'bn_bias'),
             'bn_running_mean': ('batch_stats', 'bn_mean'),
             'bn_running_var': ('batch_stats', 'bn_var')}


def _jax_entry(name: str, value: torch.Tensor
               ) -> Optional[Tuple[str, Tuple[str, ...], np.ndarray]]:
    """``(collection, JAX path, value in the JAX layout)`` of a port
    ``state_dict`` entry (the inverse of ``_torch_entry``); None for
    ``num_batches_tracked``, which the JAX package does not keep."""
    if name.endswith('num_batches_tracked'):
        return None
    jname = name
    for pattern, repl in _JAX_MODULE_RULES:
        jname = pattern.sub(repl, jname)
    *mods, leaf = jname.split('.')
    v = value.detach().cpu()
    if leaf in _TAP_SHAPE:                       # (C, 1, kT, kH, kW)
        return 'params', tuple(mods) + (leaf,), v.reshape(-1, 3).T.numpy()
    if leaf == 'weight' and v.ndim == 4:
        return 'params', tuple(mods) + ('kernel',), \
            v.permute(2, 3, 1, 0).numpy()
    if leaf == 'weight' and v.ndim == 2:
        return 'params', tuple(mods) + ('kernel',), v.T.numpy()
    if leaf in _JAX_LEAF and v.ndim <= 1:
        coll, jleaf = _JAX_LEAF[leaf]
        return coll, tuple(mods) + (jleaf,), v.numpy()
    raise KeyError(f'no JAX variable for port entry {name}')


def _set_path(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def jax_variables_from_state_dict(state_dict: Dict[str, torch.Tensor]
                                  ) -> Dict[str, Dict[str, Any]]:
    """The JAX package's recognizer variables ``{'params', 'batch_stats'}``
    (nested dicts of numpy arrays in the JAX layout) for a port
    ``state_dict``: OIHW -> HWIO, Conv3d-shaped MVF taps -> ``(3, C)``,
    Linear -> Dense, the BN names. The inverse of ``state_dict_from_jax``;
    ``num_batches_tracked`` is dropped."""
    out: Dict[str, Dict[str, Any]] = {c: {} for c in _COLLECTIONS}
    for name, value in state_dict.items():
        entry = _jax_entry(name, value)
        if entry is not None:
            coll, path, v = entry
            _set_path(out[coll], path, v)
    return out


def _load_msgpack(path: str):
    with open(path, 'rb') as f:
        # one writable buffer: the arrays the codec returns view it
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    payload = msgpack_restore(data)
    variables = payload['variables']
    extra = sorted(set(variables) - set(_COLLECTIONS))
    if extra:
        raise NotImplementedError(
            f'{path}: collections {extra} beyond params and batch_stats; '
            'quantized backbones and their calibration state are not '
            'ported yet (ROADMAP.md, A14)')
    meta: Dict[str, Any] = {}
    if os.path.exists(path + '.meta.json'):
        with open(path + '.meta.json') as f:
            meta = json.load(f)
    return (state_dict_from_jax(variables), payload.get('opt_state') or None,
            meta)


def _optax_layout(optimizer) -> Tuple[bool, Dict[str, Dict[str, str]]]:
    """Where the JAX package's chain keeps each state for the optimizer's
    recipe: whether the clip leads the chain (its empty state at '0'), and
    for each trained label the index of ``add_decayed_weights`` ('decay'),
    of ``trace`` ('trace') and of ``scale_by_schedule`` ('count') inside
    that label's chain. A state is absent when its transform is: no decay
    where the label's weight decay is 0, no trace without momentum
    (``mvfnet_tpu/engine/optim.py::sgd_torch``)."""
    layout = {}
    for label, wd in optimizer.label_weight_decay.items():
        keys = (['decay'] if wd else []) + (
            ['trace'] if optimizer.defaults['momentum'] else []) + ['count']
        layout[label] = {k: str(i) for i, k in enumerate(keys)}
    return optimizer.max_norm is not None, layout


def _param_names(model: torch.nn.Module) -> Dict[int, str]:
    return {id(p): n for n, p in model.named_parameters()}


def optax_state_from_optimizer(model: torch.nn.Module, optimizer,
                               step: int) -> Dict[str, Any]:
    """The optax state the JAX package's chain would hold for ``model``
    trained by ``optimizer`` (``engine.optim.build_optimizer``) for
    ``step`` steps, as ``flax.serialization.to_state_dict`` lays it out:
    ``{'0': {} (the clip), '1': {'inner_states': {label: {'inner_state':
    {...}}}}}``, each trained label's chain holding ``{}`` for the decay,
    ``{'trace': <the full JAX parameter tree, the label's momentum buffers
    in the JAX layout and ``{}`` for every other parameter>}`` and
    ``{'count': step}``; the frozen label's state is ``{}``. A parameter
    with no buffer yet (no step taken) gets zeros, optax's initial trace."""
    clip, layout = _optax_layout(optimizer)
    names = _param_names(model)
    label_of = {names[id(p)]: g['label'] for g in optimizer.param_groups
                for p in g['params']}
    inner: Dict[str, Any] = {'frozen': {'inner_state': {}}}
    for label, keys in layout.items():
        chain: Dict[str, Any] = {}
        if 'decay' in keys:
            chain[keys['decay']] = {}
        if 'trace' in keys:
            tree: Dict[str, Any] = {}
            for name, p in model.named_parameters():
                _, path, v = _jax_entry(name, p)
                if label_of.get(name) == label:
                    buf = optimizer.state.get(p, {}).get('momentum_buffer')
                    v = _jax_entry(name, buf if buf is not None
                                   else torch.zeros_like(p))[2]
                else:
                    v = {}
                _set_path(tree, path, v)
            chain[keys['trace']] = {'trace': tree}
        chain[keys['count']] = {'count': np.asarray(step, np.int32)}
        inner[label] = {'inner_state': chain}
    multi = {'inner_states': inner}
    return {'0': {}, '1': multi} if clip else {'0': multi}


def _layout_error(what: str) -> ValueError:
    return ValueError(f'optax state: {what}; the layout does not match the '
                      "optimizer's recipe (clip, weight decay, momentum)")


def _leaf_paths(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """The non-``{}`` leaves of a nested dict with their paths."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, path + (k,))
        else:
            yield path + (k,), v


def load_optax_state(model: torch.nn.Module, optimizer,
                     opt_state: Dict[str, Any], step: int) -> None:
    """Set ``optimizer``'s momentum buffers from the optax state of a
    ``.msgpack`` checkpoint (the layout of ``optax_state_from_optimizer``),
    each trace leaf carried into the port's layout by the weights' rule.
    Every trained parameter gets its buffer, zeros included, so that torch
    does not start it anew at the next step. Raises on a layout the
    optimizer's recipe does not give, or a step count other than
    ``step``."""
    clip, layout = _optax_layout(optimizer)
    top = {'0', '1'} if clip else {'0'}
    if set(opt_state) != top or (clip and opt_state['0'] != {}):
        raise _layout_error(f'top-level keys {sorted(opt_state)}')
    inner = opt_state['1' if clip else '0'].get('inner_states', {})
    if set(inner) != set(layout) | {'frozen'} \
            or inner['frozen'] != {'inner_state': {}}:
        raise _layout_error(f'labels {sorted(inner)}')
    names = _param_names(model)
    mvf_blocks = {n[:-len('.conv1.net.weight')] for n in names.values()
                  if n.endswith('.conv1.net.weight')}
    groups = {g['label']: g['params'] for g in optimizer.param_groups}
    for label, keys in layout.items():
        chain = inner[label].get('inner_state', {})
        if set(chain) != set(keys.values()) or (
                'decay' in keys and chain[keys['decay']] != {}):
            raise _layout_error(f'label {label!r} holds {sorted(chain)}')
        count = int(np.asarray(chain[keys['count']]['count']))
        if count != step:
            raise ValueError(f'optax state: label {label!r} counts {count} '
                             f'steps, the checkpoint meta {step}')
        if 'trace' not in keys:
            continue
        leaves = dict(_leaf_paths(chain[keys['trace']]['trace']))
        for p in groups.get(label, []):
            name = names[id(p)]
            _, path, _ = _jax_entry(name, p)
            if path not in leaves:
                raise _layout_error(f'no {label!r} trace for {name}')
            back, v = _torch_entry(path, np.asarray(leaves.pop(path)),
                                   mvf_blocks)
            if back != name or tuple(v.shape) != tuple(p.shape):
                raise _layout_error(f'trace {"/".join(path)} does not fit '
                                    f'{name}')
            optimizer.state[p]['momentum_buffer'] = torch.as_tensor(
                v).to(device=p.device, dtype=p.dtype)
        if leaves:
            raise _layout_error(f'{label!r} traces for parameters outside '
                                f'the label: {sorted(leaves)[:3]}')


def save_msgpack_checkpoint(path: str, model: torch.nn.Module,
                            optimizer=None,
                            meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the JAX package's ``.msgpack`` checkpoint of ``model`` (the
    counterpart of ``mvfnet_tpu/utils/checkpoint.py::save_checkpoint``):
    ``{'variables': {'params', 'batch_stats'}, 'opt_state'}`` in flax's
    layout, the optax state from ``optimizer`` at ``meta['iter']`` steps
    (``{}`` without one), written atomically (a temporary file in the same
    directory, then ``os.replace``), and ``meta`` as the ``.meta.json``
    sidecar."""
    meta = dict(meta or {})
    payload = {
        'variables': jax_variables_from_state_dict(model.state_dict()),
        'opt_state': ({} if optimizer is None else optax_state_from_optimizer(
            model, optimizer, meta.get('iter', 0)))}
    dirpath = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirpath, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirpath, suffix='.tmp')
    try:
        with os.fdopen(fd, 'wb') as f:
            write_msgpack(f, payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    with open(path + '.meta.json', 'w') as f:
        json.dump(meta, f)
