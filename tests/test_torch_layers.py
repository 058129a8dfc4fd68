"""The port's layers (dense, sliding-window and Mamba-1) against
``repro.models.layers`` on the same numpy inputs (f32 tolerance 1e-5; bf16
2e-2 where the inputs are bf16)."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,s", [(16, 64), (8, 40), (32, 64)])
def test_attention_local(window, s, dtype):
    q, k, v = _np(15, 2, 4, s, 16), _np(16, 2, 2, s, 16), _np(17, 2, 2, s, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tol = TOL
    if dtype == "bfloat16":
        tq, tk, tv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
        tol = 2e-2
    got = L.attention(tq, tk, tv, window=window, impl="local")
    _close(got, JL.attention_local(jq, jk, jv, window=window), tol)
    # and it equals full attention under the window mask
    _close(got, JL.attention_ref(jq, jk, jv, causal=True, window=window), tol)


def test_attention_auto_takes_the_local_path_on_cpu():
    q, k, v = _np(18, 1, 4, 64, 16), _np(19, 1, 2, 64, 16), _np(20, 1, 2, 64, 16)
    before = fa.launches
    _close(L.attention(*map(torch.from_numpy, (q, k, v)), window=16, impl="auto"),
           JL.attention(*map(jnp.asarray, (q, k, v)), window=16, impl="auto"))
    assert fa.launches == before


D, DI, N, R, CK = 32, 64, 8, 4, 4


def _mamba_params(seed=21):
    rng = np.random.default_rng(seed)

    def w(*shape, scale=0.2):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {
        "in_proj": w(D, 2 * DI), "conv_w": w(CK, DI, scale=0.5), "conv_b": w(DI),
        "x_proj": w(DI, R + 2 * N), "dt_proj": w(R, DI, scale=0.5),
        "dt_bias": (np.log(np.e - 1) + w(DI)).astype(np.float32),
        "a_log": np.log(np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (DI, N)))
        + w(DI, N, scale=0.05),
        "d_skip": 1.0 + w(DI), "out_proj": w(DI, D),
    }


def _both(tree):
    return ({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


@pytest.mark.parametrize("impl", ["auto", "pallas", "ref"])
@pytest.mark.parametrize("state", [False, True])
def test_mamba_block(state, impl):
    p, jp = _both(_mamba_params())
    x = _np(22, 2, 9, D)
    kw = dict(dt_rank=R, ssm_state=N, conv_k=CK, return_state=True)
    tkw, jkw = {}, {}
    if state:  # continue from a conv tail and an SSM state (the plain scan)
        conv0, h0 = _np(23, 2, CK - 1, DI), _np(24, 2, DI, N)
        tkw = dict(conv0=torch.from_numpy(conv0), h0=torch.from_numpy(h0))
        jkw = dict(conv0=jnp.asarray(conv0), h0=jnp.asarray(h0))
        if impl == "pallas":  # the kernel starts from h=0, as in the JAX package
            with pytest.raises(NotImplementedError, match="h0"):
                L.mamba_block(torch.from_numpy(x), p, impl=impl, **kw, **tkw)
            return
    out, h, tail = L.mamba_block(torch.from_numpy(x), p, impl=impl, **kw, **tkw)
    jout, jh, jtail = JL.mamba_block(jnp.asarray(x), jp, **kw, **jkw)
    _close(out, jout)
    _close(h, jh)
    _close(tail, jtail)


def test_mamba_decode_step():
    p, jp = _both(_mamba_params(seed=25))
    x, h0, conv0 = _np(26, 3, 1, D), _np(27, 3, DI, N), _np(28, 3, CK - 1, DI)
    kw = dict(dt_rank=R, ssm_state=N, conv_k=CK)
    got = L.mamba_decode_step(torch.from_numpy(x), p, torch.from_numpy(h0),
                              torch.from_numpy(conv0), **kw)
    want = JL.mamba_decode_step(jnp.asarray(x), jp, jnp.asarray(h0),
                                jnp.asarray(conv0), **kw)
    for g, w in zip(got, want):
        _close(g, w)


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
