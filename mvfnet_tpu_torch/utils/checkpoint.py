"""Weight carry into the port (counterpart of ``mvfnet_tpu/utils/checkpoint.py``).

- ``state_dict_from_jax``: the JAX package's recognizer variables
  (``{'params', 'batch_stats'}`` as nested dicts of numpy arrays) -> the
  port's ``state_dict`` in the reference torch vocabulary. It inverts the
  JAX importer's layout changes: HWIO conv kernels -> OIHW, THWIO ones ->
  OITHW, ``(3, C)`` MVF taps -> Conv3d-shaped ``(C, 1, kT, kH, kW)``,
  Dense ``(in, out)`` -> Linear ``(out, in)`` (X3D's SE pair -> the
  reference's 1x1x1 Conv3d ``(out, in, 1, 1, 1)``), CoST's shared HWIO
  kernel -> the reference's ``(C, C, 1, 3, 3)``, the BN names, and the
  module names of the other families (SlowFast's flat ``slow_*``/
  ``fast_*`` -> ``slow_path.``/``fast_path.``, X3D's ``conv1_3x1``/
  ``conv1_3x1_bn`` -> ``conv1_3x1.{0,1}``, the I3D heads' FC ->
  ``fc_cls``, BNInception's nested ``{name}/{conv,bn}`` -> the flat
  ``{name}`` and ``{name}_bn``, MobileNetV2's named modules -> d-li14's
  ``features.K.conv.I``, a 2-D non-local block ``nonlocal{i}_{j}`` ->
  ``layer{i}.{j}.nl`` beside the wrapped ``layer{i}.{j}.block``, I3D's
  ``LocalAttention_0`` -> ``nonlocal_block``, CoST_0 -> ``conv2``, the TRN
  MLPs -> ``segmental_consensus.{classifier,fc_fusion_scales.i}``, the
  R(2+1)D stem's ``conv1_s/bn1_s/conv1_t/bn1_t`` and letter-named blocks,
  InceptionV1-I3D's flat stem convs and branches). A ``quant_stats``
  collection (the int8 convs' calibration state) becomes entries named
  after the conv's buffers (``backbone.layer1.0.conv1.act_amax``), which
  the model holds outside its ``state_dict`` (``models.common.
  quant_buffers``). ``jax_entries``
  gives the same mapping leaf by leaf, with each leaf's JAX path;
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
  ``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` write and read the
  same payload as the JAX package's Orbax step directories
  (``{ckpt_dir}/step_{step}`` and ``step_{step}.meta.json``) without
  orbax (``utils/orbax_io.py``).
- ``optax_state_from_optimizer`` / ``load_optax_state``: the SGD momentum
  buffers of ``engine.optim.ClippedSGD`` as the optax state of the JAX
  package's optimizer chain (``mvfnet_tpu/engine/optim.py:189-227``), and
  back.
"""

from __future__ import annotations

import json
import os
import re
import string
import tempfile
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import orbax_io
from .logging import get_root_logger
from .msgpack_codec import msgpack_restore, write_msgpack

_COLLECTIONS = ('params', 'batch_stats', 'quant_stats')
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
    """JAX module name -> torch module path ('layer3_0' -> 'layer3.0',
    'slow_layer3_0' -> 'slow_path.layer3.0', 'nonlocal2_1' ->
    'layer2.1.nl')."""
    m = re.fullmatch(r'layer(\d+)_(\d+)', name)
    if m:
        return f'layer{m.group(1)}.{m.group(2)}'
    m = re.fullmatch(r'nonlocal(\d+)_(\d+)', name)
    if m:
        return f'layer{m.group(1)}.{m.group(2)}.nl'
    m = re.fullmatch(r'(slow|fast)_(.+)', name)
    if m:
        return f'{m.group(1)}_path.{_module_name(m.group(2))}'
    m = re.fullmatch(r'fc_fusion_(\d+)_fc([12])', name)
    if m:       # TRNmultiscale: Sequential(ReLU, Linear, ReLU, Linear)
        return f'fc_fusion_scales.{m.group(1)}.{2 * int(m.group(2)) - 1}'
    return {'downsample_conv': 'downsample.0',
            'downsample_bn': 'downsample.1', 'conv1_bn': 'conv1_7x7_s2_bn',
            'conv1_3x1': 'conv1_3x1.0', 'conv1_3x1_bn': 'conv1_3x1.1',
            'backbone_mod': 'backbone', 'head_mod': 'cls_head',
            'fc': 'new_fc', 'consensus': 'segmental_consensus',
            'LocalAttention_0': 'nonlocal_block', 'CoST_0': 'conv2',
            'stem_conv': 'features.0.0', 'stem_bn': 'features.0.1',
            'head_conv': 'conv.0', 'head_bn': 'conv.1'}.get(name, name)


# BNInception's branch modules -> the reference's name suffixes
_BNI_BRANCH = {'b1x1': '1x1', 'b3_reduce': '3x3_reduce', 'b3': '3x3',
               'bd_reduce': 'double_3x3_reduce', 'bd1': 'double_3x3_1',
               'bd2': 'double_3x3_2', 'bpool_proj': 'pool_proj'}
# InceptionV1-I3D's
_I3D_BRANCH = {'b1x1': '1x1', 'b1_reduce': 'branch1_3x3_reduce',
               'b1_3x3': 'branch1_3x3', 'b2_reduce': 'branch2_3x3_reduce',
               'b2_3x3': 'branch2_3x3', 'pool_proj': 'pool_proj'}
# R(2+1)D's BatchNorm wrappers: the JAX module nests each BatchNorm one
# level deeper, under a child 'bn'
_R3D_BN = ('bn0', 'bn1', 'bn2', 'bn3', 'bn1_s', 'bn1_t', 'bn_s', 'bn_T')
# and the convs only its blocks hold (beside 'conv0' and the stem 'conv1_s')
_R3D_CONV = ('conv', 'conv_s', 'conv_t', 'conv_T', 'conv_C')
_BNI_STEM = ('conv1_7x7_s2', 'conv2_3x3_reduce', 'conv2_3x3')
# MobileNetV2's block modules -> d-li14's ``conv`` Sequential indices:
# block 0 has no expansion, the others do
_MBV2_INDEX = (
    {'dw_conv': 0, 'dw_bn': 1, 'pw_linear_conv': 3, 'pw_linear_bn': 4},
    {'pw_conv': 0, 'pw_bn': 1, 'dw_conv': 3, 'dw_bn': 4,
     'pw_linear_conv': 6, 'pw_linear_bn': 7})


class _TreeContext:
    """What naming a JAX leaf in the port needs from the rest of its tree:
    the modules holding an MVF (whose conv becomes ``net``), the 2-D blocks
    that a non-local block follows (which become ``block``), the head
    FC's name (``fc_cls`` when the backbone convolves in 3-D outside its
    non-local blocks, else ``new_fc``), and whether the tree is an
    R(2+1)D's (BatchNorms nested in a wrapper, letter-named blocks)."""

    def __init__(self, leaves):
        """``leaves``: (JAX path, number of dimensions) of every leaf."""
        leaves = list(leaves)
        self.mvf = {tuple(p[:p.index('MVF_0')]) for p, _ in leaves
                    if 'MVF_0' in p}
        self.wrapped = {re.sub(r'^nonlocal', 'layer', m) for p, _ in leaves
                        for m in p if re.fullmatch(r'nonlocal\d+_\d+', m)}
        self.head_fc = 'fc_cls' if any(
            p[-1] == 'kernel' and nd == 5 and not any(
                m.startswith(('nonlocal', 'LocalAttention')) for m in p)
            for p, nd in leaves) else 'new_fc'
        self.r3d = any(
            (a in _R3D_BN and b == 'bn') or a in ('conv0', 'conv1_s')
            or (a in ('conv1', 'conv2') and b in _R3D_CONV)
            for p, _ in leaves for a, b in zip(p, p[1:]))


def _port_prefix(mods, ctx: '_TreeContext') -> str:
    """The port's dotted module path of a JAX module path."""
    out = []
    i = 0
    while i < len(mods):
        m = mods[i]
        nxt = mods[i + 1] if i + 1 < len(mods) else None
        if m in _BNI_STEM and nxt in ('conv', 'bn'):
            out.append(m if nxt == 'conv' else m + '_bn')
            i += 2
            continue
        if m.startswith('inception_') and (nxt in _BNI_BRANCH
                                           or nxt in _I3D_BRANCH):
            suffix = _BNI_BRANCH.get(nxt) or _I3D_BRANCH[nxt]
            out.append(f'{m}_{suffix}'
                       + ('_bn' if mods[i + 2] == 'bn' else ''))
            i += 3
            continue
        if ctx.r3d and m == 'bn' and i and mods[i - 1] in _R3D_BN:
            i += 1                      # the wrapper's BatchNorm
            continue
        blk = re.fullmatch(r'layer(\d+)_(\d+)', m)
        if ctx.r3d and blk:             # blocks a, b, ... of a ModuleList
            out.append(f'layer{blk.group(1)}.'
                       f'{string.ascii_lowercase[int(blk.group(2))]}')
            i += 1
            continue
        blk = re.fullmatch(r'block(\d+)', m)
        if blk and nxt is not None:
            b = int(blk.group(1))
            if nxt == 'MVF_0':
                out.append(f'features.{b + 1}.conv.0')
            else:
                out.append(f'features.{b + 1}.conv.'
                           f'{_MBV2_INDEX[b > 0][nxt]}')
                if nxt == 'pw_conv' and tuple(mods[:i + 1]) in ctx.mvf:
                    out.append('net')
            i += 2
            continue
        if m == 'consensus' and nxt in ('fc1', 'fc2'):   # TRN's MLP
            out.append(f'segmental_consensus.classifier.'
                       f'{1 if nxt == "fc1" else 3}')
            i += 2
            continue
        if m == 'MVF_0':                # a ResNet block's MVF wraps conv1
            out.append('conv1')
        else:
            out.append(_module_name(m))
            if m in ctx.wrapped:
                out.append('block')
            if m == 'fc' and out[:1] == ['cls_head']:
                out[-1] = ctx.head_fc
        i += 1
    return '.'.join(out)


def is_quant_stat(name: str) -> bool:
    """Whether a port entry or JAX leaf name is an int8 conv's calibration
    statistic (``act_amax``, ``act_amax_y``, ``..._calibrated``)."""
    return name.rsplit('.', 1)[-1].rsplit('/', 1)[-1].startswith('act_amax')


def _torch_entry(path: Tuple[str, ...], value: np.ndarray,
                 ctx: _TreeContext) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if is_quant_stat(leaf):
        prefix = _port_prefix(mods, ctx)
        if mods[-1] == 'conv1' and tuple(mods[:-1]) in ctx.mvf:
            prefix += '.net'          # MVF wraps the block's conv1
        return f'{prefix}.{leaf}', value
    if mods and mods[-1] == 'MVF_0':
        prefix = _port_prefix(mods, ctx)
        if leaf in _TAP_SHAPE:
            cs = value.shape[1]
            return (f'{prefix}.{leaf}.weight',
                    value.T.reshape((cs, 1) + _TAP_SHAPE[leaf]))
        return f'{prefix}.{_MVF_LEAF[leaf]}', value
    prefix = _port_prefix(mods, ctx)
    if mods and mods[-1] == 'CoST_0' and leaf == 'shift_conv':
        # the shared HWIO kernel -> the reference's Conv3d (O, I, 1, 3, 3)
        return (f'{prefix}.shift_conv.weight',
                value.transpose(3, 2, 0, 1)[:, :, None])
    if leaf == 'time_weighting':
        return f'{prefix}.time_weighting', value
    if leaf == 'kernel' and value.ndim == 5:        # THWIO -> OITHW
        return f'{prefix}.weight', value.transpose(4, 3, 0, 1, 2)
    if leaf == 'kernel' and value.ndim == 2 and mods[-2] == 'se':
        return (f'{prefix}.weight',
                value.T.reshape(value.shape[::-1] + (1, 1, 1)))
    if leaf == 'kernel' and value.ndim == 4:
        if mods[-1] == 'conv1' and tuple(mods[:-1]) in ctx.mvf:
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
    each leaf of the JAX package's recognizer variables (``params``,
    ``batch_stats`` and ``quant_stats``); the path is '/'-joined inside its
    collection, as optax's labels see it."""
    leaves = [(coll, path, v) for coll in _COLLECTIONS
              for path, v in _leaves(variables.get(coll, {}))]
    ctx = _TreeContext((path, np.ndim(v)) for _, path, v in leaves)
    for coll, path, value in leaves:
        name, v = _torch_entry(path, value, ctx)
        yield coll, '/'.join(path), name, v


def state_dict_from_jax(variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for the JAX package's recognizer variables.

    Values keep their dtype; every BatchNorm also gets a zero
    ``num_batches_tracked``, so the result loads with ``strict=True``
    (``quant_stats`` entries aside: ``is_quant_stat`` picks them out).
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
_HEAD_FCS = ('new_fc', 'fc_cls')
_AVG_DOWN_CONV = re.compile(r'\.downsample\.1\.weight$')


def _shortcut_name(key: str, value) -> str:
    """The reference's avg_down shortcut ``Sequential(pool, conv, norm)``
    names its conv ``downsample.1`` and its norm ``downsample.2``; the
    port's (``resnet.Downsample``) names them ``downsample.0`` and
    ``downsample.1``, as the plain shortcut does. A 4-D (in I3D
    a 5-D) ``downsample.1.weight`` is such a conv."""
    if '.downsample.2.' in key:
        return key.replace('.downsample.2.', '.downsample.1.')
    if _AVG_DOWN_CONV.search(key) and getattr(value, 'ndim', 0) in (4, 5):
        return key.replace('.downsample.1.', '.downsample.0.')
    return key


def _port_name(key: str, targets) -> Optional[str]:
    """The port name a reference or torchvision key loads into, or None for
    a key skipped on purpose (torchvision's classifier: the recognizer's
    head trains fresh). A name that is not in ``targets`` is unexpected."""
    parts = key.split('.')
    if parts[0] == 'cls_head':
        # new_fc: TSNClsHead; new_cls: its fcn alias; fc_cls: I3D heads;
        # each loads into the model's head FC, whichever it is
        if len(parts) > 1 and parts[1] in _HEAD_ALIASES:
            fc = next((f for f in _HEAD_FCS
                       if f'cls_head.{f}.weight' in targets), 'new_fc')
            return f'cls_head.{fc}.' + ('weight' if parts[-1] == 'weight'
                                        else 'bias')
        return key
    if parts[0] == 'fc' or 'layer4_lateral' in key:
        # torchvision's classifier; SlowFast's last lateral, which the
        # reference builds and its forward never uses
        return None
    name = key if parts[0] == 'backbone' else 'backbone.' + key
    if name not in targets:
        for other in _alternates(name):
            if other in targets:
                return other
    return name


_WRAPPED_CONV = re.compile(
    r'(backbone\.(?:layer\d+\.\d+(?:\.block)?\.conv1'
    r'|features\.\d+\.conv\.0))(\.net)?\.weight$')
_NL_BLOCK = re.compile(r'^(backbone\.layer\d+\.\d+)(\.block)?\.')


def _alternates(name: str) -> List[str]:
    """Port names that stand for ``name`` in a model of another wrapping,
    as the JAX importer maps both to one path: a conv and its MVF-wrapped
    ``net`` (a ResNet block's conv1, MobileNetV2's expanding conv), a 2-D
    block and the ``block`` a non-local block wraps, and both at once."""
    out = []
    m = _NL_BLOCK.match(name)
    if m:
        out.append(m.group(1) + ('.' if m.group(2) else '.block.')
                   + name[m.end():])
    for n in [name] + out:
        c = _WRAPPED_CONV.match(n)
        if c:
            out.append(c.group(1) + ('.weight' if c.group(2)
                                     else '.net.weight'))
    return out


def import_torch_state_dict(model: torch.nn.Module,
                            state_dict: Dict[str, Any],
                            inflate_in_channels: Optional[int] = None,
                            logger=None) -> Dict[str, List[str]]:
    """Non-strict import of a reference or torchvision state dict into
    ``model`` in place; returns the report ``{applied, missing, unexpected,
    mismatched}`` in port names (``unexpected`` keeps the source's keys).

    The key rules of the JAX package's ``import_torch_weights``
    (``mvfnet_tpu/utils/checkpoint.py:165-492``) for the 2-D ResNet (its
    options included), MVF, CoST, non-local blocks, BNInception,
    MobileNetV2, the TSN head with TRN, and the 3-D families (I3D,
    SlowFast, X3D), whose port names are the reference's: ``module.``
    prefixes are stripped, ``num_batches_tracked``, torchvision's ``fc.*``
    and SlowFast's unused ``layer4_lateral`` are skipped,
    ``cls_head.{new_fc,new_cls,fc_cls}.*`` load into the head's FC
    (``new_fc`` or ``fc_cls``), a key without ``backbone.`` loads into the
    backbone, and a block's ``conv1.weight`` and ``conv1.net.weight``
    stand for each other. A 2-D kernel loads into a 3-D one of the same
    other sizes inflated over time, ``w3d[t] = w2d / kT`` (the reference's
    I3D ``init_weights``). The
    reference's avg_down shortcut (pool, conv, norm at indices 0-2) loads
    into the port's (conv, norm at 0-1); the JAX importer takes its conv
    for the norm and reports it mismatched (ROADMAP.md, section C). A conv
    and its MVF-wrapped ``net`` stand for each other (a ResNet block's
    conv1, MobileNetV2's expanding conv), and so do a 2-D block and the
    ``block`` a non-local block wraps. A key of
    the wrong size is skipped and reported as mismatched and, as in the JAX
    importer, also as unexpected; a key the model lacks is unexpected; a
    model entry no key reached keeps its value and is reported missing.
    ``inflate_in_channels`` (10 for Flow, 15 for RGBDiff) turns an RGB stem
    into the mean over its input channels, broadcast (before a temporal
    inflation). Keys the JAX importer also reports end up unexpected:
    X3D's unused stem ``bn1``, biases of convs without one, the fast
    pathway's laterals. Calibration entries (``is_quant_stat``, from a
    ``.msgpack``'s ``quant_stats``) load into the int8 convs' buffers; a
    model without int8 convs skips them, and a model with some that the
    entries do not cover reports those buffers missing.
    """
    from ..models.common import quant_buffers
    logger = logger or get_root_logger()
    targets = model.state_dict()
    stats = quant_buffers(model)
    applied: List[str] = []
    unexpected: List[str] = []
    mismatched: List[str] = []
    updates: Dict[str, torch.Tensor] = {}
    carried_stats = False
    for key, value in state_dict.items():
        key = _strip_module(key)
        if key.endswith('num_batches_tracked'):
            continue
        if is_quant_stat(key):
            # calibration state: into the int8 convs' buffers; a model
            # without int8 convs ignores it, as the JAX CLI restores only
            # the model's own collections
            if stats:
                carried_stats = True
                name = key if key.startswith('backbone.') \
                    else 'backbone.' + key
                if name in stats:
                    updates[name] = torch.as_tensor(value).reshape(())
                    applied.append(name)
                else:
                    unexpected.append(key)
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
        if (value.ndim == 4 and target.ndim == 5 and value.shape
                == target.shape[:2] + target.shape[3:]):
            kt = target.shape[2]
            value = (value / kt).unsqueeze(2).expand(target.shape)
        if value.shape != target.shape:
            mismatched.append(f'{name}: ckpt {tuple(value.shape)} vs model '
                              f'{tuple(target.shape)}')
            unexpected.append(key)
            continue
        updates[name] = value
        applied.append(name)
    with torch.no_grad():
        for name, value in updates.items():
            (stats[name] if name in stats else targets[name]).copy_(value)
    done = set(applied)
    missing = [n for n in targets
               if n not in done and not n.endswith('num_batches_tracked')]
    if carried_stats:       # the collection must then match the model's
        missing += [n for n in stats if n not in done]
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

_BNI_SUFFIX = {v: k for k, v in _BNI_BRANCH.items()}


def _mbv2_module(m) -> str:
    """``features.K.conv.I`` -> MobileNetV2's ``block{K-1}.{module}``."""
    b = int(m.group(1)) - 1
    index = {i: name for name, i in _MBV2_INDEX[b > 0].items()}
    return f'block{b}.{index[int(m.group(2))]}.'


# port name -> JAX path, applied in order to the name's module part
_JAX_MODULE_RULES = (
    (re.compile(r'^backbone\.'), 'backbone_mod.'),
    (re.compile(r'^cls_head\.(new_fc|fc_cls)\.'), 'head_mod.fc.'),
    (re.compile(r'^cls_head\.segmental_consensus\.classifier\.([13])\.'),
     lambda m: f'head_mod.consensus.fc{(int(m.group(1)) + 1) // 2}.'),
    (re.compile(r'^cls_head\.segmental_consensus\.fc_fusion_scales\.'
                r'(\d+)\.([13])\.'),
     lambda m: (f'head_mod.consensus.fc_fusion_{m.group(1)}_'
                f'fc{(int(m.group(2)) + 1) // 2}.')),
    # BNInception (InceptionV1-I3D's stem conv stays flat, ``_FAMILY_RULES``):
    # flat conv / conv_bn pairs -> nested conv / bn
    (re.compile(r'\b(conv1_7x7_s2|conv2_3x3_reduce|conv2_3x3)_bn\.'),
     r'\1.bn.'),
    (re.compile(r'\b(conv1_7x7_s2|conv2_3x3_reduce|conv2_3x3)\.'
                r'(?=(weight|bias)$)'), r'\1.conv.'),
    (re.compile(r'\binception_(\d[a-z])_(1x1|3x3_reduce|3x3|double_3x3_reduce'
                r'|double_3x3_1|double_3x3_2|pool_proj)(_bn)?\.'),
     lambda m: (f'inception_{m.group(1)}.{_BNI_SUFFIX[m.group(2)]}.'
                f'{"bn" if m.group(3) else "conv"}.')),
    # MobileNetV2: d-li14's Sequential indices -> named modules
    (re.compile(r'\bfeatures\.0\.0\.'), 'stem_conv.'),
    (re.compile(r'\bfeatures\.0\.1\.'), 'stem_bn.'),
    (re.compile(r'\bfeatures\.(\d+)\.conv\.0\.(shift_conv|h_conv|w_conv)'
                r'\.weight$'),
     lambda m: f'block{int(m.group(1)) - 1}.MVF_0.{m.group(2)}'),
    (re.compile(r'\bfeatures\.(\d+)\.conv\.0\.bn\.'
                r'(weight|bias|running_mean|running_var)$'),
     lambda m: f'block{int(m.group(1)) - 1}.MVF_0.bn_{m.group(2)}'),
    (re.compile(r'\bfeatures\.(\d+)\.conv\.(\d+)\.(net\.)?'), _mbv2_module),
    (re.compile(r'^backbone_mod\.conv\.0\.'), 'backbone_mod.head_conv.'),
    (re.compile(r'^backbone_mod\.conv\.1\.'), 'backbone_mod.head_bn.'),
    # non-local blocks: 2-D beside the wrapped block, 3-D inside it
    (re.compile(r'\blayer(\d+)\.(\d+)\.nl\.'), r'nonlocal\1_\2.'),
    (re.compile(r'\blayer(\d+)\.(\d+)\.block\.'), r'layer\1.\2.'),
    (re.compile(r'\bnonlocal_block\.'), 'LocalAttention_0.'),
    # CoST replaces conv2
    (re.compile(r'\bconv2\.shift_conv\.weight$'), 'CoST_0.shift_conv'),
    (re.compile(r'\bconv2\.bn\.'), 'CoST_0.bn.'),
    (re.compile(r'\blayer(\d+)\.(\d+)\b'), r'layer\1_\2'),
    (re.compile(r'\bdownsample\.0\b'), 'downsample_conv'),
    (re.compile(r'\bdownsample\.1\b'), 'downsample_bn'),
    (re.compile(r'\bconv1_3x1\.0\b'), 'conv1_3x1'),
    (re.compile(r'\bconv1_3x1\.1\b'), 'conv1_3x1_bn'),
    (re.compile(r'\b(slow|fast)_path\.'), r'\1_'),
    (re.compile(r'\bconv1\.net\b'), 'conv1'),
    (re.compile(r'\bconv1\.(shift_conv|h_conv|w_conv)\.weight$'),
     r'MVF_0.\1'),
    (re.compile(r'\bconv1\.bn\.(weight|bias|running_mean|running_var)$'),
     r'MVF_0.bn_\1'),
)
_I3D_SUFFIX = {v: k for k, v in _I3D_BRANCH.items()}
# rules of one vocabulary (``_vocabulary``), applied before the others
_FAMILY_RULES = {
    'inception_i3d': (
        (re.compile(r'\bconv1_7x7_s2_bn\.'), 'conv1_bn.'),
        # the stem conv is flat: leave it out of BNInception's rule
        (re.compile(r'\bconv1_7x7_s2\.(?=(weight|bias)$)'),
         'conv1_7x7_s2_flat.'),
        (re.compile(r'\binception_(\d[a-z])_(1x1|branch[12]_3x3_reduce'
                    r'|branch[12]_3x3|pool_proj)(_bn)?\.'),
         lambda m: (f'inception_{m.group(1)}.{_I3D_SUFFIX[m.group(2)]}.'
                    f'{"bn" if m.group(3) else "conv"}.')),
    ),
    'r3d': (
        # BatchNorms under the wrapper's 'bn'; blocks a, b, ... -> 0, 1, ...
        (re.compile(r'\.(bn\d(?:_[st])?|bn_s|bn_T)\.'), r'.\1.bn.'),
        (re.compile(r'\blayer(\d+)\.([a-z])\.'),
         lambda m: f'layer{m.group(1)}.'
                   f'{string.ascii_lowercase.index(m.group(2))}.'),
    ),
}
_FAMILY_AFTER = {'inception_i3d': ((re.compile(r'\bconv1_7x7_s2_flat\.'),
                                    'conv1_7x7_s2.'),)}


def _vocabulary(names) -> str:
    """The family whose names need their own rules: 'r3d' (letter-named
    blocks or the R(2+1)D stem), 'inception_i3d' (its branch names), or
    ''."""
    names = list(names)
    if any(re.search(r'\blayer\d+\.[a-z]\.|^backbone\.conv1_s\.', n)
           for n in names):
        return 'r3d'
    if any('_branch1_3x3' in n for n in names):
        return 'inception_i3d'
    return ''


_JAX_LEAF = {'weight': ('params', 'scale'), 'bias': ('params', 'bias'),
             'running_mean': ('batch_stats', 'mean'),
             'running_var': ('batch_stats', 'var'),
             'bn_weight': ('params', 'bn_scale'),
             'bn_bias': ('params', 'bn_bias'),
             'bn_running_mean': ('batch_stats', 'bn_mean'),
             'bn_running_var': ('batch_stats', 'bn_var')}


def _jax_entry(name: str, value: torch.Tensor, family: str = ''
               ) -> Optional[Tuple[str, Tuple[str, ...], np.ndarray]]:
    """``(collection, JAX path, value in the JAX layout)`` of a port
    ``state_dict`` entry (the inverse of ``_torch_entry``), in the
    vocabulary ``family`` (``_vocabulary`` of the whole state dict); None
    for ``num_batches_tracked``, which the JAX package does not keep."""
    if name.endswith('num_batches_tracked'):
        return None
    jname = name
    for pattern, repl in (_FAMILY_RULES.get(family, ()) + _JAX_MODULE_RULES
                          + _FAMILY_AFTER.get(family, ())):
        jname = pattern.sub(repl, jname)
    *mods, leaf = jname.split('.')
    v = value.detach().cpu()
    if is_quant_stat(leaf):
        return 'quant_stats', tuple(mods) + (leaf,), v.numpy()
    if leaf == 'shift_conv' and mods[-1] == 'CoST_0':   # (O, I, 1, 3, 3)
        return 'params', tuple(mods) + (leaf,), \
            v[:, :, 0].permute(2, 3, 1, 0).numpy()
    if leaf == 'time_weighting':
        return 'params', tuple(mods) + (leaf,), v.numpy()
    if leaf in _TAP_SHAPE:                       # (C, 1, kT, kH, kW)
        return 'params', tuple(mods) + (leaf,), v.reshape(-1, 3).T.numpy()
    if leaf == 'weight' and v.ndim == 5 and mods[-2] == 'se':
        return 'params', tuple(mods) + ('kernel',), v.flatten(1).T.numpy()
    if leaf == 'weight' and v.ndim == 5:
        return 'params', tuple(mods) + ('kernel',), \
            v.permute(2, 3, 4, 1, 0).numpy()
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
    ``state_dict``: OIHW -> HWIO, OITHW -> THWIO, Conv3d-shaped MVF taps ->
    ``(3, C)``, Linear and the SE pair -> Dense, the BN and module names. The inverse of ``state_dict_from_jax``;
    ``num_batches_tracked`` is dropped."""
    out: Dict[str, Dict[str, Any]] = {c: {} for c in _COLLECTIONS}
    family = _vocabulary(state_dict)
    for name, value in state_dict.items():
        entry = _jax_entry(name, value, family)
        if entry is not None:
            coll, path, v = entry
            _set_path(out[coll], path, v)
    if not out['quant_stats']:      # a model without int8 convs has none
        del out['quant_stats']
    return out


def _from_payload(payload: Dict[str, Any], path: str, meta_path: str):
    """``(state_dict, opt_state or None, meta)`` of the JAX package's
    checkpoint payload ``{'variables', 'opt_state'}``, read from ``path``,
    with the ``meta_path`` sidecar where it exists."""
    variables = payload['variables']
    extra = sorted(set(variables) - set(_COLLECTIONS))
    if extra:
        raise ValueError(f'{path}: collections {extra} beyond '
                         f'{", ".join(_COLLECTIONS)}')
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return (state_dict_from_jax(variables), payload.get('opt_state') or None,
            meta)


def _load_msgpack(path: str):
    with open(path, 'rb') as f:
        # one writable buffer: the arrays the codec returns view it
        data = bytearray(os.fstat(f.fileno()).st_size)
        f.readinto(data)
    return _from_payload(msgpack_restore(data), path, path + '.meta.json')


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
    family = _vocabulary(names.values())
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
                _, path, v = _jax_entry(name, p, family)
                if label_of.get(name) == label:
                    buf = optimizer.state.get(p, {}).get('momentum_buffer')
                    v = _jax_entry(name, buf if buf is not None
                                   else torch.zeros_like(p), family)[2]
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
    family = _vocabulary(names.values())
    entries = [e for e in (_jax_entry(n, v, family)
                           for n, v in model.state_dict().items()) if e]
    ctx = _TreeContext((path, v.ndim) for _, path, v in entries)
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
            _, path, _ = _jax_entry(name, p, family)
            if path not in leaves:
                raise _layout_error(f'no {label!r} trace for {name}')
            back, v = _torch_entry(path, np.asarray(leaves.pop(path)),
                                   ctx)
            if back != name or tuple(v.shape) != tuple(p.shape):
                raise _layout_error(f'trace {"/".join(path)} does not fit '
                                    f'{name}')
            optimizer.state[p]['momentum_buffer'] = torch.as_tensor(
                v).to(device=p.device, dtype=p.dtype)
        if leaves:
            raise _layout_error(f'{label!r} traces for parameters outside '
                                f'the label: {sorted(leaves)[:3]}')


def _jax_payload(model: torch.nn.Module, optimizer,
                 meta: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX package's checkpoint payload of ``model``: ``{'variables':
    {'params', 'batch_stats'}, 'opt_state'}`` in flax's layout (with
    ``quant_stats`` when the model has int8 convs), the optax state from
    ``optimizer`` at ``meta['iter']`` steps (``{}`` without one)."""
    from ..models.common import quant_buffers
    return {
        'variables': jax_variables_from_state_dict(
            {**model.state_dict(), **quant_buffers(model)}),
        'opt_state': ({} if optimizer is None else optax_state_from_optimizer(
            model, optimizer, meta.get('iter', 0)))}


def save_msgpack_checkpoint(path: str, model: torch.nn.Module,
                            optimizer=None,
                            meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the JAX package's ``.msgpack`` checkpoint of ``model`` (the
    counterpart of ``mvfnet_tpu/utils/checkpoint.py::save_checkpoint``):
    ``_jax_payload``, written atomically (a temporary file in the same
    directory, then ``os.replace``), and ``meta`` as the ``.meta.json``
    sidecar."""
    meta = dict(meta or {})
    payload = _jax_payload(model, optimizer, meta)
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


def save_checkpoint_orbax(ckpt_dir: str, model: torch.nn.Module,
                          optimizer=None,
                          meta: Optional[Dict[str, Any]] = None,
                          step: int = 0) -> int:
    """Write the JAX package's Orbax step directory of ``model`` (the
    counterpart of ``mvfnet_tpu/utils/checkpoint.py::
    save_checkpoint_orbax``): ``_jax_payload`` (variables and the optax
    state) as ``{ckpt_dir}/step_{step}`` in orbax's per-file layout, which
    the JAX package's ``load_checkpoint_orbax`` reads (``utils/
    orbax_io.py``), and ``meta`` as ``step_{step}.meta.json``. Returns the
    bytes of array data written."""
    meta = dict(meta or {})
    nbytes = orbax_io.save_pytree(os.path.join(ckpt_dir, f'step_{step}'),
                                  _jax_payload(model, optimizer, meta))
    with open(os.path.join(ckpt_dir, f'step_{step}.meta.json'), 'w') as f:
        json.dump(meta, f)
    return nbytes


def load_checkpoint_orbax(ckpt_dir: str, step: int
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Optional[Dict[str, Any]],
                                     Dict[str, Any]]:
    """``(state_dict, opt_state or None, meta)`` of an Orbax step directory
    ``{ckpt_dir}/step_{step}``, written by the JAX package (OCDBT) or by
    ``save_checkpoint_orbax``, as ``load_checkpoint`` gives them for a
    ``.msgpack`` file: ``opt_state`` fits ``load_optax_state``."""
    path = os.path.join(ckpt_dir, f'step_{step}')
    return _from_payload(orbax_io.load_pytree(path), path,
                         os.path.join(ckpt_dir, f'step_{step}.meta.json'))
