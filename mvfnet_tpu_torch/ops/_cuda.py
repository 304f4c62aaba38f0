"""Build and load the port's hand-written CUDA kernels.

``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` (listed in
``.gitignore``). A source that calls a CUDA library (nvJPEG) names it in
``LINK``; the library is linked from the toolkit's ``lib64``, which goes on
the built library's run path. The built file's name carries a hash of its
source and of the nvcc command's flags, so an edited source or a changed
flag is rebuilt and a stale library is never loaded. Libraries are loaded
with ``ctypes``; nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, List, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# the CUDA libraries each source links, beyond the runtime
LINK: Dict[str, Sequence[str]] = {'nvjpeg_decode': ('-lnvjpeg',)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register/shared-memory report) per built source
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                           'toolkit (nvcc on PATH or in /usr/local/cuda)')
    return path


def _flags(name: str, nvcc: str) -> List[str]:
    """nvcc's flags for ``csrc/<name>.cu``: ``NVCC_FLAGS``, then its
    ``LINK`` libraries from the toolkit's ``lib64`` beside ``nvcc``'s
    ``bin``, that directory also on the library's run path."""
    libs = list(LINK.get(name, ()))
    if not libs:
        return list(NVCC_FLAGS)
    lib64 = os.path.join(os.path.dirname(os.path.dirname(
        os.path.realpath(nvcc))), 'lib64')
    return NVCC_FLAGS + [f'-L{lib64}', f'-Xlinker=-rpath={lib64}'] + libs


def library_path(name: str, nvcc: str) -> Tuple[str, List[str]]:
    """Where ``csrc/<name>.cu``'s library is built, named by a hash of the
    source and of its flags, and the flags."""
    args = _flags(name, nvcc)
    digest = hashlib.sha1()
    with open(os.path.join(SRC_DIR, name + '.cu'), 'rb') as f:
        digest.update(f.read())
    digest.update('\0'.join(args).encode())
    return (os.path.join(BUILD_DIR, f'lib{name}_{digest.hexdigest()[:16]}.so'),
            args)


def _build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; its path."""
    nvcc = _nvcc()
    path, args = library_path(name, nvcc)
    if os.path.exists(path):
        return path
    src = os.path.join(SRC_DIR, name + '.cu')
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([nvcc] + args + ['-o', tmp, src],
                          capture_output=True, text=True)
    build_logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed for {name}.cu:\n{build_logs[name]}')
    os.replace(tmp, path)   # atomic: concurrent builders agree
    return path


def library(name: str,
            signatures: Dict[str, Tuple[Sequence, type]]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` set from ``{function: (argtypes, restype)}``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(_build(name))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f'{what}: CUDA launch failed with cudaError_t '
                           f'{err}')
