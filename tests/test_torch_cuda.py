"""The hand-written CUDA kernels on the card, against their plain versions.

Marked ``cuda``; each test skips without a card.  Imports no JAX, so it runs
on a machine that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

CASES = [
    (2, 4, 2, 64, 64, 32, True, 0),
    (1, 4, 4, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 96, 16, False, 0),
    (1, 4, 2, 128, 128, 32, True, 32),
    (1, 2, 2, 80, 112, 32, False, 0),
    (4, 14, 2, 512, 512, 64, True, 0),    # qwen2-0.5b prefill
    (1, 2, 1, 33, 47, 128, True, 0),      # hd 128, ragged, Sq != Sk
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain version in full f32
    return torch.device("cuda")


def _inputs(b, h, kh, sq, sk, hd, dtype, device, seed=7):
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,sq,sk,hd,causal,window", CASES)
def test_kernel_matches_plain_version(cuda, b, h, kh, sq, sk, hd, causal,
                                      window, dtype):
    q, k, v = _inputs(b, h, kh, sq, sk, hd, dtype, cuda)
    before = fa.launches
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    tol = TOL[dtype]
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=tol, rtol=tol)


def test_auto_attention_takes_the_kernel_on_the_card(cuda):
    from repro_torch.models import layers

    q, k, v = _inputs(2, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    before = fa.launches
    out = layers.attention(q, k, v, causal=True, impl="auto")
    assert fa.launches == before + 1
    want = ref.attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _inputs(1, 4, 2, 16, 16, 32, torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :24].contiguous(), k[..., :24].contiguous(),
                           v[..., :24].contiguous())
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(q[:, :3].contiguous(), k, v)
