"""The port stands alone: no JAX, flax, msgpack, mvfnet_tpu, PyAV, decord,
triton, orbax, tensorstore or zstandard import anywhere in
mvfnet_tpu_torch/ or chip_smoke.py (the port carries its own msgpack codec,
zstd decoder and OCDBT reader, and decodes video with cv2), importing it
loads none of them nor a kernel, and its entry points run on CUDA unless
told not to."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), '..'))
PORT = os.path.join(REPO, 'mvfnet_tpu_torch')
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'mvfnet_tpu', 'av',
             'decord', 'triton', 'orbax', 'tensorstore', 'zstandard')


def _port_files():
    files = [os.path.join(REPO, 'chip_smoke.py')]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith('.py')]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def test_port_sources_import_no_jax_package():
    files = _port_files()
    assert len(files) > 15
    names = {os.path.relpath(f, PORT) for f in files}
    assert {'parallel/__init__.py', 'parallel/dist.py',
            'parallel/launch.py', 'data/video_io.py',
            'models/backbones/resnet_i3d.py',
            'models/backbones/resnet_i3d_slowfast.py',
            'models/backbones/resnet_x3d.py', 'models/heads/i3d_head.py',
            'models/recognizers/recognizer3d.py'} <= names
    bad = [(os.path.relpath(f, REPO), root) for f in files
           for root in _imported_roots(f) if root in FORBIDDEN]
    assert bad == []


def test_import_loads_no_jax_triton_or_kernel():
    code = (
        'import sys\n'
        'import mvfnet_tpu_torch, mvfnet_tpu_torch.models\n'
        'import mvfnet_tpu_torch.engine.train_step\n'
        'import mvfnet_tpu_torch.utils.checkpoint\n'
        'import mvfnet_tpu_torch.data, mvfnet_tpu_torch.engine.eval\n'
        'import mvfnet_tpu_torch.engine, mvfnet_tpu_torch.engine.train_loop\n'
        'import mvfnet_tpu_torch.tools.test_recognizer\n'
        'import mvfnet_tpu_torch.tools.train_recognizer\n'
        'import mvfnet_tpu_torch.tools.feature_extractor\n'
        'import mvfnet_tpu_torch.tools.count_flops\n'
        'import mvfnet_tpu_torch.tools.report_accuracy\n'
        'import mvfnet_tpu_torch.utils.flops\n'
        'import mvfnet_tpu_torch.utils.msgpack_codec\n'
        'import mvfnet_tpu_torch.utils.zstd, mvfnet_tpu_torch.utils.ocdbt\n'
        'import mvfnet_tpu_torch.utils.orbax_io\n'
        'import mvfnet_tpu_torch.data.native_io\n'
        'import mvfnet_tpu_torch.tools.jpeg_kinds\n'
        'import mvfnet_tpu_torch.tools.ycc_bench\n'
        'import mvfnet_tpu_torch.parallel, mvfnet_tpu_torch.parallel.dist\n'
        'import mvfnet_tpu_torch.parallel.launch\n'
        'import mvfnet_tpu_torch.data.video_io\n'
        'import mvfnet_tpu_torch.models.backbones.resnet\n'
        'import mvfnet_tpu_torch.models.backbones.resnet_i3d\n'
        'import mvfnet_tpu_torch.models.backbones.resnet_i3d_slowfast\n'
        'import mvfnet_tpu_torch.models.backbones.resnet_x3d\n'
        'import mvfnet_tpu_torch.models.heads.i3d_head\n'
        'import mvfnet_tpu_torch.models.recognizers.recognizer3d\n'
        'from mvfnet_tpu_torch.ops import _cuda\n'
        'mods = [m for m in sys.modules if m.split(".")[0] in '
        '("jax", "flax", "msgpack", "triton", "av", "decord", "orbax", '
        '"tensorstore", "zstandard") '
        'or m == "mvfnet_tpu" '
        'or m.startswith("mvfnet_tpu.")]\n'
        'assert not mods, mods\n'
        'assert not _cuda._libs\n'
        'print("ok")\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == 'ok'


def test_default_device_is_cuda_and_raises_without_it():
    from mvfnet_tpu_torch.engine.train_step import (make_eval_step,
                                                    resolve_device)
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        make_eval_step(model)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA')
    out = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')],
                         cwd=str(tmp_path), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ''
    assert 'no CUDA device' in out.stderr
