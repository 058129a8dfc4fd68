"""The port's flash attention on the CPU (its plain version) against the JAX
package's Pallas kernel (interpret mode) and its jnp oracle, over the shape
and dtype sweep of ``test_kernels.py``.  The CUDA kernel itself is held
against the same plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

CASES = [
    (2, 4, 2, 64, 64, 32, True, 0),       # GQA causal
    (1, 4, 4, 128, 128, 64, True, 0),     # MHA
    (2, 2, 1, 96, 96, 16, False, 0),      # MQA bidirectional
    (1, 4, 2, 128, 128, 32, True, 32),    # sliding window
    (1, 2, 2, 80, 112, 32, False, 0),     # ragged + cross lengths
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(b, h, kh, sq, sk, hd, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kh,sq,sk,hd,causal,window", CASES)
def test_flash_attention_matches_jax(b, h, kh, sq, sk, hd, causal, window, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _inputs(b, h, kh, sq, sk, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in arrays)

    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                              block_q=32, block_k=32)
    assert out.dtype == tdt and out.shape == (b, h, sq, hd)
    got = out.float().numpy()
    kernel = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=32, block_k=32)
    oracle = jref.attention_ref(jq, jk, jv, causal=causal, window=window)
    for want in (kernel, oracle):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_plain_version_is_the_cpu_path():
    arrays = _inputs(1, 4, 2, 40, 40, 16)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    before = fa.launches
    np.testing.assert_array_equal(
        ops.flash_attention(q, k, v, causal=True).numpy(),
        ref.attention_ref(q, k, v, causal=True).numpy())
    assert fa.launches == before  # the plain version launches nothing


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never falls back to the plain version."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 16, 16, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa.flash_attention(q, k, v)
