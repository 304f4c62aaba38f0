"""Orbax checkpoint directories read and written without orbax: the
``_METADATA`` tree, zarr v2 arrays and both of orbax's storage layouts.

A checkpoint that orbax's ``StandardCheckpointer`` saves is a directory
with ``_METADATA`` (JSON: every leaf's key path and value type, an empty
dict as ``{"value_type": "Dict", "skip_deserialize": true}``, and whether
the arrays live in OCDBT), ``_CHECKPOINT_METADATA`` (JSON: timestamps and
the handler), and a zarr v2 array a leaf: ``<path joined by '.'>/.zarray``
(JSON: shape, chunks, dtype, order, fill value, compressor) and its chunks
``<path>/<i.j...>``, zstd-compressed. With ``"use_ocdbt": true`` (what the
JAX package writes) those keys live in an OCDBT store (``ocdbt.py``); else
each is a file. ``load_pytree`` reads both; ``save_pytree`` writes the
per-file layout (``"use_ocdbt": false``), which orbax reads back as it
reads its own, with chunks in zstd frames of raw blocks (``zstd.py``).
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from . import ocdbt, zstd

METADATA = '_METADATA'
CHECKPOINT_METADATA = '_CHECKPOINT_METADATA'
_HANDLER = ('orbax.checkpoint._src.handlers.standard_checkpoint_handler.'
            'StandardCheckpointHandler')
_ARRAY_TYPES = ('np.ndarray', 'jax.Array')


class OrbaxError(ValueError):
    """A directory that is not an Orbax checkpoint this module reads."""


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` of a nested dict, an empty dict being a leaf."""
    for k, v in tree.items():
        if not isinstance(k, str):
            raise OrbaxError(f'key {k!r} at {path}: only str keys')
        if isinstance(v, dict) and v:
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _read_array(get, name: str) -> np.ndarray:
    """The zarr v2 array stored under ``name`` (``get(key)`` -> bytes or
    None)."""
    meta_bytes = get(f'{name}/.zarray')
    if meta_bytes is None:
        raise OrbaxError(f'no {name}/.zarray')
    meta = json.loads(meta_bytes)
    if meta.get('zarr_format') != 2 or meta.get('filters'):
        raise OrbaxError(f'{name}: zarr format {meta.get("zarr_format")}, '
                         f'filters {meta.get("filters")}')
    comp = meta.get('compressor')
    if comp is not None and comp.get('id') != 'zstd':
        raise OrbaxError(f'{name}: compressor {comp}')
    dtype = np.dtype(meta['dtype'])
    shape, chunks = tuple(meta['shape']), tuple(meta['chunks'])
    order, sep = meta.get('order', 'C'), meta.get('dimension_separator', '.')
    fill = meta.get('fill_value')
    out = np.full(shape, 0 if fill is None else fill, dtype)
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*(len(g) for g in grid)) if shape else [()]:
        key = sep.join(map(str, idx)) if shape else '0'
        data = get(f'{name}/{key}')
        if data is None:
            continue                                    # the fill value
        if comp is not None:
            data = zstd.decompress(data)
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def _getter(path: str, use_ocdbt: bool):
    if use_ocdbt:
        return ocdbt.Store(path).get

    def get(key: str) -> Optional[bytes]:
        try:
            with open(os.path.join(path, *key.split('/')), 'rb') as f:
                return f.read()
        except FileNotFoundError:
            return None
    return get


def load_pytree(path: str) -> Dict[str, Any]:
    """The nested dict of numpy arrays that orbax's ``StandardCheckpointer
    .restore(path)`` returns, an empty dict where one was saved."""
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get('use_zarr3'):
        raise OrbaxError(f'{path}: zarr3 arrays are not read')
    get = _getter(path, bool(meta.get('use_ocdbt')))
    tree: Dict[str, Any] = {}
    for key, entry in meta['tree_metadata'].items():
        keys = entry['key_metadata']
        if any(k.get('key_type') != 2 for k in keys):
            raise OrbaxError(f'{key}: only dict keys are read')
        names = tuple(k['key'] for k in keys)
        if names != tuple(ast.literal_eval(key)):
            raise OrbaxError(f'{key}: key metadata {names}')
        value = entry['value_metadata']
        if value['value_type'] == 'Dict' and value.get('skip_deserialize'):
            leaf: Any = {}
        elif value['value_type'] in _ARRAY_TYPES:
            leaf = _read_array(get, '.'.join(names))
        else:
            raise OrbaxError(f'{key}: value type {value["value_type"]}')
        node = tree
        for k in names[:-1]:
            node = node.setdefault(k, {})
        node[names[-1]] = leaf
    return tree


def _zarray(a: np.ndarray) -> bytes:
    meta = {'chunks': list(a.shape) or [], 'compressor': {'id': 'zstd',
                                                          'level': 1},
            'dimension_separator': '.', 'dtype': a.dtype.str,
            'fill_value': None, 'filters': None, 'order': 'C',
            'shape': list(a.shape), 'zarr_format': 2}
    return json.dumps(meta, sort_keys=True, separators=(',', ':')).encode()


def save_pytree(path: str, tree: Dict[str, Any]) -> int:
    """Write ``tree`` (nested dicts of numpy arrays and empty dicts, str
    keys) as an Orbax checkpoint directory at ``path`` in orbax's per-file
    layout, replacing one that exists: each array one zarr chunk in a zstd
    frame of raw blocks. Written into a temporary directory beside ``path``,
    then renamed. Returns the bytes of array data written."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=os.path.basename(path)
                           + '.orbax-checkpoint-tmp-')
    t0 = time.time_ns()
    try:
        tree_meta, nbytes = {}, 0
        for names, leaf in _leaves(tree):
            entry = {'key_metadata': [{'key': k, 'key_type': 2}
                                      for k in names]}
            if isinstance(leaf, dict):
                entry['value_metadata'] = {'value_type': 'Dict',
                                           'skip_deserialize': True}
            else:
                a = np.array(leaf, order='C')    # keeps 0-d arrays 0-d
                if a.dtype.kind not in 'biuf':
                    raise OrbaxError(f'{names}: dtype {a.dtype}')
                a = a.astype(a.dtype.newbyteorder('<'), copy=False)
                d = os.path.join(tmp, '.'.join(names))
                os.makedirs(d)
                with open(os.path.join(d, '.zarray'), 'wb') as f:
                    f.write(_zarray(a))
                chunk = '.'.join(['0'] * a.ndim) if a.ndim else '0'
                with open(os.path.join(d, chunk), 'wb') as f:
                    f.write(zstd.compress_raw(a.tobytes()))
                nbytes += a.nbytes
                entry['value_metadata'] = {'value_type': 'np.ndarray',
                                           'skip_deserialize': False}
            tree_meta[str(names)] = entry
        with open(os.path.join(tmp, METADATA), 'w') as f:
            json.dump({'tree_metadata': tree_meta, 'use_ocdbt': False,
                       'use_zarr3': False,
                       'store_array_data_equal_to_fill_value': True,
                       'custom_metadata': None}, f)
        with open(os.path.join(tmp, CHECKPOINT_METADATA), 'w') as f:
            json.dump({'item_handlers': _HANDLER, 'metrics': {},
                       'performance_metrics': {},
                       'init_timestamp_nsecs': t0,
                       'commit_timestamp_nsecs': time.time_ns(),
                       'custom_metadata': {}}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return nbytes
