"""The port's dense layers against ``repro.models.layers`` on the same numpy
inputs (f32 tolerance 1e-5; bf16 2e-2 where the inputs are bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers as L

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

TOL = 1e-5


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_rms_norm():
    x, s = _np(0, 3, 5, 64), _np(1, 64, scale=0.1)
    _close(L.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope(theta, batched):
    x = _np(2, 2, 3, 10, 16)
    pos = (np.random.default_rng(3).integers(0, 50, (2, 10)) if batched
           else np.arange(10)).astype(np.int32)
    _close(L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("impl", ["ref", "blockwise", "pallas"])
@pytest.mark.parametrize("causal,window,sq,sk", [
    (True, 0, 48, 48), (False, 0, 40, 72), (True, 16, 64, 64)])
def test_attention(impl, causal, window, sq, sk):
    q, k, v = _np(4, 2, 4, sq, 16), _np(5, 2, 2, sk, 16), _np(6, 2, 2, sk, 16)
    kw = dict(causal=causal, window=window, impl=impl, block_size=32)
    if impl == "pallas":
        kw.pop("block_size")
    _close(L.attention(*map(torch.from_numpy, (q, k, v)), **kw),
           JL.attention(*map(jnp.asarray, (q, k, v)), **kw))


@pytest.mark.parametrize("causal,sq,sk", [(True, 48, 48), (False, 40, 72)])
def test_attention_auto_on_cpu_runs_the_plain_version(causal, sq, sk):
    q, k, v = _np(4, 2, 4, sq, 16), _np(5, 2, 2, sk, 16), _np(6, 2, 2, sk, 16)
    before = fa.launches
    _close(L.attention(*map(torch.from_numpy, (q, k, v)), causal=causal, impl="auto"),
           JL.attention(*map(jnp.asarray, (q, k, v)), causal=causal, impl="auto"))
    assert fa.launches == before


def test_attention_local_waits_for_the_hybrid_family():
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        L.attention(q, q, q, window=16, impl="auto")


def test_quantize_kv():
    x = _np(7, 2, 2, 9, 16, scale=3.0)
    q, s = L.quantize_kv(torch.from_numpy(x))
    jq, js = JL.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _close(s, js)


@pytest.mark.parametrize("cache", ["float32", "bfloat16", "int8"])
def test_decode_attention(cache):
    b, h, kh, smax, hd, n = 2, 4, 2, 24, 16, 17
    q, k, v = _np(8, b, h, 1, hd), _np(9, b, kh, smax, hd), _np(10, b, kh, smax, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    kw, jkw, tol = {}, {}, TOL
    if cache == "bfloat16":
        tq, tk, tv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
        tol = 2e-2
    elif cache == "int8":
        (tk, ks), (tv, vs) = L.quantize_kv(tk), L.quantize_kv(tv)
        (jk, jks), (jv, jvs) = JL.quantize_kv(jk), JL.quantize_kv(jv)
        kw, jkw = dict(k_scale=ks, v_scale=vs), dict(k_scale=jks, v_scale=jvs)
    _close(L.decode_attention(tq, tk, tv, n, **kw),
           JL.decode_attention(jq, jk, jv, n, **jkw), tol)


def test_swiglu_mlp():
    x, g, u, o = _np(11, 2, 5, 64), _np(12, 64, 128, scale=0.1), \
        _np(13, 64, 128, scale=0.1), _np(14, 128, 64, scale=0.1)
    _close(L.swiglu_mlp(*map(torch.from_numpy, (x, g, u, o))),
           JL.swiglu_mlp(*map(jnp.asarray, (x, g, u, o))))
