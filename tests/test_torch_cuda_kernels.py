"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here carries the ``cuda`` marker and skips without a GPU. This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch (the repository's ``tests/conftest.py`` imports JAX,
hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mvfnet_tpu_torch.ops import fused_block as fb

pytestmark = pytest.mark.cuda

# (N, H, W, Cin), Cm: the JAX suite's shapes (general kernel), and shapes
# that take the tiled bf16 kernel at the edges of its strip walk: H and W
# not multiples of its tile, H not a multiple of the strip or the step
# (a ragged last step), H = 1, and H below the step with W ragged
SHAPES = [((2, 8, 8, 32), 16), ((1, 6, 10, 24), 8), ((3, 13, 11, 128), 64),
          ((160, 37, 20, 128), 64), ((1, 1, 64, 256), 64),
          ((2, 3, 9, 192), 128)]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (chip_smoke.py makes the same '
                    'checks on the card)')
    # cuDNN's float32 convs default to TF32; the plain version must not
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)


def _inputs(shape, cm, dtype):
    cin = shape[-1]
    sizes = [shape, (cin, cm), (1, cm), (3, 3, cm, cm), (1, cm), (cm, cin),
             (1, cin)]
    arrs = [torch.from_numpy(np.random.RandomState(i).randn(*s) * 0.2)
            .float().cuda() for i, s in enumerate(sizes)]
    x, w1, b1, w2, b2, w3, b3 = arrs
    return x.to(dtype), w1.to(dtype), b1, w2.to(dtype), b2, w3.to(dtype), b3


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,cm', SHAPES)
def test_fused_bottleneck_matches_plain(cuda, shape, cm, dtype):
    args = _inputs(shape, cm, getattr(torch, dtype))
    key = (dtype,) + shape + (cm,)
    n, h, w, cin = shape
    if dtype == 'bfloat16' and cin % 64 == 0 and cm % 64 == 0:
        assert fb.kernel_path(torch.bfloat16, h, w, cin, cm) == 'tiled'
    before = (fb.bottleneck_eval_cuda.launches,
              fb.bottleneck_eval_cuda.launches_by_shape[key])
    got = fb.bottleneck_eval(*args).float()
    torch.cuda.synchronize()
    assert (fb.bottleneck_eval_cuda.launches,
            fb.bottleneck_eval_cuda.launches_by_shape[key]) == (
                before[0] + 1, before[1] + 1)
    want = fb.bottleneck_eval_plain(*args).float()
    ref = want.abs().max().item()
    # f32: fp32 sums in another order; bf16: the plain version rounds each
    # conv output to bf16 before its bias, the kernel after (about one ulp)
    tol = 1e-5 * (1 + ref) if dtype == 'float32' else 1e-2 * ref
    assert (got - want).abs().max().item() <= tol


def test_fused_bottleneck_raises_on_what_it_does_not_take(cuda):
    x, w1, b1, w2, b2, w3, b3 = _inputs(*SHAPES[0], torch.float32)
    half = [t.half() for t in (x, w1, w2, w3)]
    with pytest.raises(TypeError, match='bfloat16 or float32'):
        fb.bottleneck_eval(half[0], half[1], b1, half[2], b2, half[3], b3)
    with pytest.raises(ValueError, match='contiguous NHWC'):
        fb.bottleneck_eval(x.transpose(1, 2), w1, b1, w2, b2, w3, b3)
    with pytest.raises(TypeError, match='weights must be in x.dtype'):
        fb.bottleneck_eval(x, w1.bfloat16(), b1, w2, b2, w3, b3)
