"""The CUDA kernels of nfdpm_tpu_torch against their plain PyTorch versions.

These tests need a CUDA card (and nvcc to build the kernels); elsewhere they
skip. On the card, run them without the JAX test bootstrap:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: elementwise rtol 1e-5 and atol 1e-5; the coupling logdet, a sum
of up to D log terms taken in another order, rtol 1e-5 and atol 1e-4.
"""

import pytest
import torch

from nfdpm_tpu_torch.ops.kernels import channel_mix as cm
from nfdpm_tpu_torch.ops.kernels import coupling_tail as ct

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


@pytest.mark.parametrize("shape,o", [((64, 16, 16, 12), 12), ((64, 4, 4, 48), 48),
                                     ((37, 3, 5, 14), 20), ((3, 1, 1, 192), 192)])
def test_channel_mix_matches_plain(gen, shape, o):
    x, w, b = _randn(gen, *shape), _randn(gen, o, shape[-1], scale=0.3), _randn(gen, o)
    before = cm.channel_mix.launches
    y = cm.channel_mix(x, w, b)
    torch.cuda.synchronize()
    assert cm.channel_mix.launches == before + 1
    torch.testing.assert_close(y, cm.channel_mix_plain(x, w, b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(64, 16, 16, 6), (37, 3, 5, 7), (1, 1, 1, 1)])
def test_coupling_tail_and_inverse_match_plain(gen, shape):
    ls, b, xb = _randn(gen, *shape, scale=0.5), _randn(gen, *shape), _randn(gen, *shape)
    y, ldj = ct.coupling_tail(ls, b, xb)
    y_p, ldj_p = ct.coupling_tail_plain(ls, b, xb)
    torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ldj, ldj_p, rtol=1e-5, atol=1e-4)
    again = ct.coupling_tail(ls, b, xb)[1]
    assert torch.equal(ldj, again)  # fixed reduction order, no atomics
    x = ct.coupling_tail_inverse(ls, b, y)
    torch.testing.assert_close(x, ct.coupling_tail_inverse_plain(ls, b, y),
                               rtol=1e-5, atol=1e-5)


def test_wrappers_raise_on_bad_inputs(gen):
    x = _randn(gen, 4, 8)
    with pytest.raises(TypeError):
        cm.channel_mix(x.double(), _randn(gen, 8, 8).double(), _randn(gen, 8).double())
    with pytest.raises(ValueError, match="contiguous"):
        cm.channel_mix(_randn(gen, 8, 4).T, _randn(gen, 8, 8), _randn(gen, 8))
    with pytest.raises(ValueError, match="CUDA device"):
        cm.channel_mix(x, _randn(gen, 8, 8).cpu(), _randn(gen, 8))
    with pytest.raises(ValueError, match="shape"):
        ct.coupling_tail(x, x, _randn(gen, 4, 9))
