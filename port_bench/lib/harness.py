"""What ``run.py`` finds by name, and what it checks and prints.

Everything that belongs to one cell, configuration, driver or per-layer
metric sits in a file of its own, found by the name ``BENCHMARK.json``
gives it:

- ``workloads/<cell>.json``: the cell's traffic (its driver, sizes, pool,
  the limits of the numbers its check compares);
- ``configs/<config>.json``: the model, test and train settings as run;
- ``drivers/<driver>.py``: a ``Bench`` class (set-up, window, traced
  window, check);
- ``metrics/<metric>.py``: a ``read(trace)`` function that returns the
  metric from the traced run's data, or None where it finds nothing.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

# top-level module names that no run may load, compared whole
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'mvfnet_tpu')


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, 'BENCHMARK.json'))


def cell(bench: dict, name: str) -> dict:
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise KeyError(f'no workload named {name!r} in BENCHMARK.json')


def config_entry(bench: dict, name: str) -> dict:
    for c in bench['configs']:
        if c['name'] == name:
            return c
    raise KeyError(f'no config named {name!r} in BENCHMARK.json')


def metrics_for(entries: List[dict], workload: str) -> List[dict]:
    """The metrics of ``entries`` that ``workload`` reports: those that
    list it, and those with no ``workloads`` key."""
    return [m for m in entries
            if 'workloads' not in m or workload in m['workloads']]


def workload_file(name: str) -> dict:
    return load_json(os.path.join(HERE, 'workloads', name + '.json'))


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded by path (metric
    names hold dots)."""
    path = os.path.join(HERE, kind, name + '.py')
    spec = importlib.util.spec_from_file_location(
        f'port_bench_{kind}_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` as a whole word."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split('.')[0] in FORBIDDEN)


def set_cache_dirs() -> None:
    """The program's kernel caches at fixed directories inside the
    checkout (its nvcc libraries go to ``mvfnet_tpu_torch/_build/`` by
    themselves); a library that would load JAX by itself is told not to."""
    cache = os.path.join(HERE, '.cache')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    """The last line of standard output; the compared numbers come last."""
    out = dict(correct=correct, attempted=attempted, failed=failed,
               metrics=metrics, device=device)
    if breakdown is not None:
        out['breakdown'] = breakdown
    out['checks'] = checks
    return json.dumps(out)


def check_lines(checks: Dict[str, dict]) -> List[str]:
    """One line a compared number: name, value, limit, verdict."""
    return [f'check {name}: {c["value"]!r} limit {c["limit"]!r} '
            f'{"ok" if c["ok"] else "FAILED"}'
            for name, c in checks.items()]
