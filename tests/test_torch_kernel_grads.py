"""The plain versions of the backward kernels (``repro_torch.kernels.ref.*_bwd``)
and the port's plain ``rms_norm`` with its custom VJP, against ``jax.vjp``
of the JAX package's oracles (``repro.kernels.ref``) and of its
``repro.models.layers.rms_norm``, on the same inputs and cotangents from
numpy, in f32 and bf16 (the cotangents in the outputs' dtypes).  The CUDA
backward kernels are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances, as max |diff| over max |reference| of each gradient (at least
1): f32 within 2e-5 (the same f32 operations summed in another order); bf16
within one bf16 step, 2^-7 (both sides round the same f32 values to bf16,
and a value one f32 ulp from a rounding boundary can go either way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as jlayers
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ref
from repro_torch.models import layers

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}


def _rand(rng, shape, dtype, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32).astype(jnp.dtype(dtype))


def _pair(a):
    """One numpy array (f32 or ml_dtypes bf16) as (JAX array, CPU tensor)."""
    return jnp.asarray(a), tensor_from_numpy(a)


def _agree(got, want, dtype):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        g32, w32 = g.float().numpy(), w.astype(np.float32)
        err = float(np.abs(g32 - w32).max())
        assert err <= TOL[dtype] * max(1.0, float(np.abs(w32).max())), err


ATTN = [
    (2, 4, 2, 16, 16, 16, True, 0),
    (1, 4, 4, 24, 24, 32, True, 0),
    (2, 2, 1, 12, 20, 16, False, 0),
    (1, 4, 2, 32, 32, 16, True, 8),
    (1, 2, 1, 20, 28, 16, False, 6),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,sq,sk,hd,causal,window", ATTN)
def test_attention_plain_backward_matches_jax(b, h, kh, sq, sk, hd, causal, window, dtype):
    rng = np.random.default_rng(0)
    arrays = [_rand(rng, s, dtype) for s in ((b, h, sq, hd), (b, kh, sk, hd), (b, kh, sk, hd),
                                             (b, h, sq, hd))]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = map(_pair, arrays)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention_ref(q, k, v, causal=causal,
                                                        window=window), jq, jk, jv)
    want = vjp(jdo)
    got = ref.attention_ref_bwd(tq, tk, tv, tdo, causal=causal, window=window)
    _agree(got, want, dtype)


SCAN = [(2, 24, 16, 8), (1, 40, 12, 16), (2, 17, 8, 4)]


def _scan_arrays(rng, b, s, di, n, dtype):
    u, bm, cm = (_rand(rng, sh, dtype) for sh in ((b, s, di), (b, s, n), (b, s, n)))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, di)))).astype(np.float32).astype(
        jnp.dtype(dtype))
    a = (-np.exp(0.3 * rng.standard_normal((di, n)))).astype(np.float32)
    d = (1.0 + 0.1 * rng.standard_normal(di)).astype(np.float32)
    dy = rng.standard_normal((b, s, di)).astype(np.float32)
    return [u, dt, a, bm, cm, d], dy


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,di,n", SCAN)
def test_scan_plain_backward_matches_jax(b, s, di, n, dtype):
    arrays, dy = _scan_arrays(np.random.default_rng(1), b, s, di, n, dtype)
    pairs = [_pair(a) for a in arrays]
    _, vjp = jax.vjp(lambda *x: jref.selective_scan_ref(*x)[0], *(p[0] for p in pairs))
    want = vjp(jnp.asarray(dy))
    got = ref.selective_scan_ref_bwd(*(p[1] for p in pairs), torch.from_numpy(dy))
    _agree(got, want, dtype)


@pytest.mark.parametrize("b,s,di,n", SCAN)
def test_chunked_plain_scan_has_the_same_gradient(b, s, di, n):
    """The model's plain scan (sequence chunks, log-step prefix scan inside;
    chunk 8 here, so several chunks) differentiates to the sequential
    oracle's gradient."""
    arrays, dy = _scan_arrays(np.random.default_rng(2), b, s, di, n, "float32")
    tensors = [torch.from_numpy(a) for a in arrays]
    leaves = [t.clone().requires_grad_(True) for t in tensors]
    y, _ = layers._selective_scan(*leaves, chunk=8, impl="ref")
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    want = ref.selective_scan_ref_bwd(*tensors, torch.from_numpy(dy))
    _agree(got, [w.numpy() for w in want], "float32")


@pytest.mark.parametrize("x_dtype,scale_dtype", [("float32", "float32"),
                                                 ("bfloat16", "float32"),
                                                 ("float32", "bfloat16"),
                                                 ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("shape", [(8, 64), (2, 5, 48), (3, 1001)])
def test_rms_norm_custom_vjp_matches_jax(shape, x_dtype, scale_dtype):
    """``ref.rms_norm_ref_bwd`` and the plain ``layers.rms_norm`` Function
    give the JAX custom VJP: dx in x's dtype, ds in scale's."""
    rng = np.random.default_rng(3)
    (jx, tx), (js, ts), (jdy, tdy) = map(_pair, (
        _rand(rng, shape, x_dtype, 2.0), _rand(rng, shape[-1:], scale_dtype, 0.1),
        _rand(rng, shape, x_dtype)))
    _, vjp = jax.vjp(lambda x, s: jlayers.rms_norm(x, s, 1e-6), jx, js)
    want = vjp(jdy)
    tol = "bfloat16" if "bfloat16" in (x_dtype, scale_dtype) else "float32"
    _agree(ref.rms_norm_ref_bwd(tx, ts, tdy, 1e-6), want, tol)
    leaves = [tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)]
    out = layers.rms_norm(*leaves, 1e-6, impl="ref")
    assert out.dtype == tx.dtype
    _agree(torch.autograd.grad(out, leaves, tdy), want, tol)


@pytest.mark.parametrize("impl,window,s", [("ref", 0, 40), ("blockwise", 0, 40),
                                           ("local", 8, 32), ("auto", 8, 32),
                                           ("auto", 0, 40)])
def test_plain_attention_paths_have_the_oracle_gradient(impl, window, s):
    rng = np.random.default_rng(4)
    q, k, v, do = (torch.from_numpy(_rand(rng, sh, "float32")) for sh in (
        (2, 4, s, 16), (2, 2, s, 16), (2, 2, s, 16), (2, 4, s, 16)))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = layers.attention(*leaves, causal=True, window=window, impl=impl, block_size=16)
    got = torch.autograd.grad(out, leaves, do)
    want = ref.attention_ref_bwd(q, k, v, do, causal=True, window=window)
    _agree(got, [w.numpy() for w in want], "float32")
