"""The port's selective scan on the CPU against the JAX package: the op
(``ops.selective_scan``, whose CPU path is the plain version) against the
Pallas kernel in interpret mode and its sequential oracle, over the sweep of
``test_kernels.py`` plus a DI that no power-of-two tile divides; and the
model's ``_selective_scan`` (chunked log-step scan, with and without ``h0``)
against the JAX package's associative scan.  The CUDA kernel itself is held
against the same plain version on the card (``test_torch_cuda.py``,
``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import ops, ref
from repro_torch.kernels import selective_scan as ss
from repro_torch.models import layers as L

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

CASES = [
    (2, 64, 32, 8, 16, 16),
    (1, 96, 64, 16, 32, 32),
    (2, 50, 32, 4, 32, 16),     # sequence padding in the Pallas kernel
    (1, 100, 200, 16, 40, 32),  # ragged DI: the JAX kernel needs block_d | DI
]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _inputs(b, s, di, n, seed=0):
    """u, dt, a, b, c, d as f32 numpy arrays (dt > 0, a < 0)."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, di))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di))))
    a = -np.exp(0.3 * rng.standard_normal((di, n)))
    bm, cm = rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n))
    d = 1.0 + 0.1 * rng.standard_normal(di)
    return [x.astype(np.float32) for x in (u, dt, a, bm, cm, d)]


def _split(arrays, jdt, tdt):
    """JAX and torch operands: u, dt, b, c in the working dtype; a, d f32."""
    low = (0, 1, 3, 4)
    jx = [jnp.asarray(x).astype(jdt if i in low else jnp.float32)
          for i, x in enumerate(arrays)]
    tx = [torch.from_numpy(x).to(tdt if i in low else torch.float32)
          for i, x in enumerate(arrays)]
    return jx, tx


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,s,di,n,bd,bs", CASES)
def test_selective_scan_matches_jax(b, s, di, n, bd, bs, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jx, tx = _split(_inputs(b, s, di, n), jdt, tdt)
    y, h = ops.selective_scan(*tx, block_d=bd, block_s=bs)
    assert y.dtype == h.dtype == torch.float32
    assert y.shape == (b, s, di) and h.shape == (b, di, n)
    kernel = jops.selective_scan(*jx, block_d=bd, block_s=bs)
    oracle = jref.selective_scan_ref(*jx)
    for jy, jh in (kernel, oracle):
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=tol, rtol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=tol, rtol=tol)


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s,chunk", [(100, 256), (100, 32), (1, 256)])
def test_model_scan_matches_jax(s, chunk, with_h0):
    """The chunked scan of the model path, f32: log-step passes in the port,
    ``lax.associative_scan`` in JAX, so they agree to f32 rounding."""
    arrays = _inputs(2, s, 24, 16, seed=1)
    jx, tx = _split(arrays, jnp.float32, torch.float32)
    h0 = np.random.default_rng(2).standard_normal((2, 24, 16)).astype(np.float32)
    kw = dict(chunk=chunk, impl="auto")
    before = ss.launches
    y, h = L._selective_scan(*tx, h0=torch.from_numpy(h0) if with_h0 else None, **kw)
    jy, jh = JL._selective_scan(*jx, h0=jnp.asarray(h0) if with_h0 else None, **kw)
    assert ss.launches == before  # the CPU never reaches the kernel
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)


def test_model_scan_pallas_is_the_op():
    tx = [torch.from_numpy(x) for x in _inputs(1, 40, 16, 8, seed=3)]
    y, h = L._selective_scan(*tx, impl="pallas")
    want_y, want_h = ref.selective_scan_ref(*tx)
    np.testing.assert_array_equal(y.numpy(), want_y.numpy())
    np.testing.assert_array_equal(h.numpy(), want_h.numpy())
    with pytest.raises(ValueError, match="impl"):
        L._selective_scan(*tx, impl="local")


def test_op_refuses_h0_and_the_wrapper_refuses_cpu_tensors():
    tx = [torch.from_numpy(x) for x in _inputs(1, 8, 16, 4)]
    with pytest.raises(NotImplementedError, match="h0"):
        ops.selective_scan(*tx, h0=torch.zeros(1, 16, 4))
    with pytest.raises(NotImplementedError, match="h0"):
        L._selective_scan(*tx, h0=torch.zeros(1, 16, 4), impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ss.selective_scan(*tx)
