"""The port's RMSNorm on the CPU against the JAX package: the op
(``ops.rms_norm``, whose CPU path is the plain version) against the Pallas
kernel in interpret mode and its oracle over the sweep of
``test_kernels.py``, and the model's ``layers.rms_norm`` switch against the
JAX layer.  The CUDA kernel itself is held against the same plain version on
the card (``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.models import layers as L

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, d)).astype(np.float32),
            (0.1 * rng.standard_normal(d)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("rows,d,block", [(64, 128, 32), (37, 256, 16), (5, 64, 8)])
def test_rms_norm_matches_jax(rows, d, block, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, s = _inputs(rows, d)
    out = ops.rms_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(s), block_rows=block)
    assert out.dtype == tdt and out.shape == (rows, d)
    jx = jnp.asarray(x).astype(jdt)
    for want in (jops.rms_norm(jx, jnp.asarray(s), block_rows=block),
                 jref.rms_norm_ref(jx, jnp.asarray(s))):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("impl", ["auto", "ref", "pallas"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layer_switch_matches_jax(impl, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, s = _inputs(15, 1600, seed=1)  # hymba's width: not a power of two
    before = rn.launches
    out = L.rms_norm(torch.from_numpy(x).to(tdt).reshape(3, 5, 1600),
                     torch.from_numpy(s).to(tdt), 1e-6, impl=impl)
    assert rn.launches == before  # the CPU never reaches the kernel
    want = JL.rms_norm(jnp.asarray(x).astype(jdt).reshape(3, 5, 1600),
                       jnp.asarray(s).astype(jdt), 1e-6)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_wrapper_refuses_cpu_tensors_and_unknown_impls():
    x, s = map(torch.from_numpy, _inputs(4, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        rn.rms_norm(x, s)
    with pytest.raises(ValueError, match="impl"):
        L.rms_norm(x, s, impl="fused")
