"""The port's optimizer, training step, gradient compression and checkpoints
against the JAX package's, from the same trees (JAX layout carried over by
``repro_torch.convert``).

Tolerances: one AdamW update in f32 within 1e-6 relative (the same f32
operations in a different order); with bf16 moments one bf16 step (2^-8
relative), because a moment one f32 ulp apart can round to the neighbouring
bf16 value.  A train step within 1e-5 relative on the f32 loss and
gradients (the convolutions sum in different orders; see
test_torch_cnn.py), and params within 2e-7 absolute (one update moves them
by at most lr = 1e-5 in warmup); the error-feedback residual within 1e-5 of
its leaf's gradient scale.  Quantization (given the same input, blocked in
the same element order) and checkpoints are bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs.surrogates import SURROGATES as JAX_SURROGATES
from repro.distributed import compression as jcomp
from repro.models import cnn as jcnn
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs.surrogates import SURROGATES
from repro_torch.distributed import compression as tcomp
from repro_torch.models import cnn
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

NAME = "ptychonn"


class _Cfg:
    def __init__(self, grad_accum=1):
        self.grad_accum = grad_accum
        self.grad_accum_dtype = "float32"


def _jax_params(seed=0):
    return jax.tree.map(np.asarray, jcnn.init_surrogate(
        jax.random.PRNGKey(seed), JAX_SURROGATES[NAME].reduced()))


def _like(tree, seed, scale=1.0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (scale * rng.standard_normal(a.shape)).astype(dtype), tree)


def _to_torch(tree, dtype=None):
    return convert.surrogate_params_from_jax(tree, "cpu", dtype)


def _to_jax(flat):
    return convert.surrogate_params_to_jax(flat)


def _close(got_tree, want_tree, rtol, atol=0.0):
    assert jax.tree.structure(got_tree) == jax.tree.structure(want_tree)
    for a, b in zip(jax.tree.leaves(got_tree), jax.tree.leaves(want_tree)):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   rtol=rtol, atol=atol)


# -- AdamW --------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("step", [1, 50, 200])
def test_one_adamw_update_matches(step, clip, state_dtype):
    cfg = dict(lr=3e-3, warmup_steps=100, total_steps=200, clip_norm=clip,
               state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), tadamw.AdamWConfig(**cfg)
    params = _jax_params()
    grads = _like(params, 1, scale=0.5)   # global norm well above the clip
    mu = _like(params, 2, scale=0.1)
    nu = jax.tree.map(np.abs, _like(params, 3, scale=0.05))
    jdt = jnp.dtype(state_dtype)
    jstate = jadamw.OptState(jax.tree.map(lambda a: jnp.asarray(a, jdt), mu),
                             jax.tree.map(lambda a: jnp.asarray(a, jdt), nu),
                             jnp.asarray(step - 1, jnp.int32))
    jp, jst, jm = jadamw.apply_updates(params, grads, jstate, jcfg)

    tdt = tadamw.torch_dtype(state_dtype)
    tstate = tadamw.OptState(
        _to_torch(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)), mu), tdt),
        _to_torch(jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jdt)), nu), tdt),
        torch.tensor(step - 1, dtype=torch.int32))
    tp, tst, tm = tadamw.apply_updates(_to_torch(params), _to_torch(grads), tstate, tcfg)

    assert int(tst.step) == int(jst.step) == step
    assert tst.mu["enc.0.w"].dtype == tdt
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    assert float(jm["grad_norm"]) > 1.0  # the clip is active when on
    moment_tol = 1e-6 if state_dtype == "float32" else 2.0**-8
    _close(_to_jax(tp), jp, rtol=1e-6, atol=1e-7)
    _close(_to_jax(tst.mu), jst.mu, rtol=moment_tol)
    _close(_to_jax(tst.nu), jst.nu, rtol=moment_tol)


def test_cosine_schedule_matches_over_the_whole_run():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=60)
    steps = np.arange(0, 70, dtype=np.int32)
    want = np.asarray(jadamw.cosine_schedule(jadamw.AdamWConfig(**cfg), jnp.asarray(steps)))
    got = tadamw.cosine_schedule(tadamw.AdamWConfig(**cfg), torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


# -- compression ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1000,), (3, 3, 64, 128), (7,), (256,), (2, 300)])
def test_quantization_matches_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0)).astype(np.float32)
    x.reshape(-1)[:3] = 0.0
    jq, js, jpad = jcomp.quantize(jnp.asarray(x))
    tq, ts, tpad = tcomp.quantize(torch.from_numpy(x))
    assert tpad == jpad
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    jd = np.asarray(jcomp.quantize_dequantize(jnp.asarray(x)))
    assert tcomp.quantize_dequantize(torch.from_numpy(x)).numpy().tobytes() == jd.tobytes()


def test_error_feedback_blocks_in_the_reference_order_bit_for_bit():
    grads = _like(_jax_params(), 4, scale=0.3)
    ef = _like(grads, 5, scale=0.01)
    jg, je = jcomp.apply_error_feedback(grads, ef)
    tg, te = tcomp.apply_error_feedback(_to_torch(grads), _to_torch(ef))
    for got, want in ((_to_jax(tg), jg), (_to_jax(te), je)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            assert a.tobytes() == np.asarray(b).tobytes()
    # blocked in the port's own layout, a kernel's 256-blocks hold other
    # elements: the quantized gradient would differ
    flat = _to_torch(grads)["enc.1.w"]
    assert not torch.equal(tcomp.quantize_dequantize(flat),
                           convert.from_jax_layout("enc.1.w", tcomp.quantize_dequantize(
                               convert.to_jax_layout("enc.1.w", flat))))


# -- the training step ----------------------------------------------------------

def _batch(cfg, rows, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows,) + cfg.input_shape).astype(np.float32)
    y = rng.standard_normal((rows,) + cfg.output_shape).astype(np.float32)
    w = np.ones(rows, np.float32)
    w[[2, rows - 1]] = 0.0  # zero-weight padding rows in both microbatches
    return {"x": x, "y": y, "weights": w}


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
def test_one_train_step_matches(accum, compress):
    jcfg, tcfg = JAX_SURROGATES[NAME].reduced(), SURROGATES[NAME].reduced()
    opt = dict(lr=1e-3, warmup_steps=100, total_steps=1000)
    jopt, topt = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)
    params = _jax_params(7)
    batch = _batch(jcfg, 8)

    jfn = jax.jit(jstep.make_train_step(
        _Cfg(accum), jopt, lambda p, b: jcnn.surrogate_loss(p, b, jcfg),
        compress_grads=compress))
    js, jm = jfn(jstep.init_train_state(params, jopt, error_feedback=compress), batch)

    tfn = tstep.make_train_step(_Cfg(accum), topt,
                                lambda p, b: cnn.surrogate_loss(p, b, tcfg),
                                compress_grads=compress)
    tstate = tstep.init_train_state(_to_torch(params), topt, error_feedback=compress)
    ts, tm = tfn(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})

    assert float(tm["tokens"]) == float(jm["tokens"]) == 6.0
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    _close(_to_jax(ts["params"]), jax.tree.map(np.asarray, js["params"]), rtol=0, atol=2e-7)
    _close(_to_jax(ts["opt"].mu), js["opt"].mu, rtol=1e-5, atol=1e-9)
    _close(_to_jax(ts["opt"].nu), js["opt"].nu, rtol=1e-5, atol=1e-12)
    assert int(ts["opt"].step) == int(js["opt"].step) == 1
    if compress:
        # The residual is a difference of near-equal values, so it carries
        # the gradient's own 1e-5 error: the tolerance is scaled by the
        # leaf's gradient, max|g| = max|mu| / (1 - b1) after one step.
        for a, b, m in zip(jax.tree.leaves(_to_jax(ts["ef"])), jax.tree.leaves(js["ef"]),
                           jax.tree.leaves(js["opt"].mu)):
            gmax = np.abs(np.asarray(m)).max() / (1 - jopt.b1)
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5 * gmax)
    # the old state is left as it was (functional, like the JAX step)
    assert int(tstate["opt"].step) == 0


def test_grad_accum_two_equals_one_on_the_same_batch():
    """Sum-gradient accumulation: two microbatches give the full-batch
    update (the paper's Eq. 3 in the step)."""
    tcfg = SURROGATES[NAME].reduced()
    opt = tadamw.AdamWConfig(lr=1e-3)
    params = _to_torch(_jax_params(7))
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 8).items()}
    outs = []
    for accum in (1, 2):
        fn = tstep.make_train_step(_Cfg(accum), opt, lambda p, b: cnn.surrogate_loss(p, b, tcfg))
        outs.append(fn(tstep.init_train_state(params, opt), batch))
    (s1, m1), (s2, m2) = outs
    assert float(m1["tokens"]) == float(m2["tokens"])
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-6)
    for k in s1["params"]:
        np.testing.assert_allclose(s1["params"][k], s2["params"][k], rtol=0, atol=1e-9)



def test_step_traces_each_microbatchs_phases_in_order():
    """With tracing on, a step of ``grad_accum`` 4 records forward, backward
    and accumulate for each microbatch, then one optimizer span, one after
    another on the calling thread."""
    from repro_torch.obs import trace as obs_trace

    tcfg = SURROGATES[NAME].reduced()
    opt = tadamw.AdamWConfig(lr=1e-3)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 8).items()}
    fn = tstep.make_train_step(_Cfg(4), opt, lambda p, b: cnn.surrogate_loss(p, b, tcfg))
    state = tstep.init_train_state(_to_torch(_jax_params(7)), opt)
    tracer = obs_trace.enable()
    try:
        fn(state, batch)
    finally:
        obs_trace.disable()
    recs, _, dropped = tracer.records()
    assert dropped == 0
    names = [obs_trace.kind_name(int(k)) for k in recs["kind"]]
    assert names == ["step.forward", "step.backward", "step.accumulate"] * 4 + [
        "step.optimizer"]
    assert (recs["t1"] >= recs["t0"]).all() and (recs["t0"][1:] >= recs["t1"][:-1]).all()


# -- checkpoints ------------------------------------------------------------------

def _states(state_dtype, error_feedback):
    """The same one-step-trained state in both packages (port state from
    the JAX one through convert, so leaves are equal bit for bit)."""
    cfg = JAX_SURROGATES[NAME].reduced()
    opt = jadamw.AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    fn = jax.jit(jstep.make_train_step(_Cfg(), opt, lambda p, b: jcnn.surrogate_loss(p, b, cfg),
                                       compress_grads=error_feedback))
    js, _ = fn(jstep.init_train_state(_jax_params(3), opt, error_feedback=error_feedback),
               _batch(cfg, 4))
    jsn = jax.tree.map(np.asarray, js)
    tdt = tadamw.torch_dtype(state_dtype)
    ts = {"params": _to_torch(jsn["params"]),
          "opt": tadamw.OptState(_to_torch(jsn["opt"].mu, tdt), _to_torch(jsn["opt"].nu, tdt),
                                 torch.tensor(int(jsn["opt"].step), dtype=torch.int32))}
    if error_feedback:
        ts["ef"] = _to_torch(jsn["ef"])
    return js, ts, opt


def _template(opt, error_feedback):
    cfg = JAX_SURROGATES[NAME].reduced()
    return jstep.init_train_state(jcnn.init_surrogate(jax.random.PRNGKey(9), cfg), opt,
                                  error_feedback=error_feedback)


def _leaf_files(d):
    return {f[:-4] for f in os.listdir(d) if f.endswith(".npy")}


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_bit_exact_in_jax(tmp_path, state_dtype, error_feedback):
    js, ts, opt = _states(state_dtype, error_feedback)
    extra = tckpt.plan_cursor_extra(4, 0, 3, plan_hash="abc")
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 4, ts, extra=extra)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 4, js, extra=extra)
    assert _leaf_files(path) == _leaf_files(jpath)
    with open(os.path.join(path, "meta.json")) as f, open(os.path.join(jpath, "meta.json")) as g:
        assert json.load(f) == json.load(g)  # same leaf order, step and cursor
    restored, meta = jckpt.restore_checkpoint(path, _template(opt, error_feedback))
    assert meta["extra"] == extra
    assert jax.tree.structure(restored) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(js)):
        assert _same_bits(a, b)


@pytest.mark.parametrize("error_feedback", [False, True])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_bit_exact_in_the_port(tmp_path, state_dtype, error_feedback):
    js, ts, opt = _states(state_dtype, error_feedback)
    path = jckpt.save_checkpoint(str(tmp_path), 8, js, extra={"solar_step": 8})
    tdt = tadamw.torch_dtype(state_dtype)
    template = tstep.init_train_state(
        cnn.init_surrogate(SURROGATES[NAME].reduced(), device="cpu"),
        tadamw.AdamWConfig(state_dtype=state_dtype), error_feedback=error_feedback)
    restored, meta = tckpt.restore_checkpoint(path, template)
    assert tckpt.resume_cursor(meta) == (8, None)
    assert sorted(restored) == sorted(ts)
    assert restored["opt"].mu["dec.1.w"].dtype == tdt
    assert int(restored["opt"].step) == int(ts["opt"].step) == 1
    for top in ts:
        if top == "opt":
            pairs = [(restored["opt"].mu, ts["opt"].mu), (restored["opt"].nu, ts["opt"].nu)]
        else:
            pairs = [(restored[top], ts[top])]
        for got, want in pairs:
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                assert torch.equal(got[k], want[k])


def test_uncommitted_checkpoints_are_skipped_and_async_equals_sync(tmp_path):
    _, ts, _ = _states("float32", False)
    d = str(tmp_path)
    ck = tckpt.AsyncCheckpointer(d)
    ck.save(4, ts, extra={"solar_step": 4})
    ck.wait()
    sync = tckpt.save_checkpoint(str(tmp_path / "sync"), 4, ts)
    for name in _leaf_files(ck.last_path):
        assert np.load(os.path.join(ck.last_path, name + ".npy")).tobytes() == \
            np.load(os.path.join(sync, name + ".npy")).tobytes()
    # a later save that crashed before its COMMITTED marker
    partial = tckpt.save_checkpoint(d, 8, ts)
    os.remove(os.path.join(partial, "COMMITTED"))
    os.makedirs(os.path.join(d, "step_00000012.tmp"))
    assert tckpt.latest_checkpoint(d) == jckpt.latest_checkpoint(d) == ck.last_path
    assert tckpt.latest_checkpoint(str(tmp_path / "missing")) is None


def test_plan_cursor_records_equal_the_reference():
    for args in [(4, 0, 3, None), (17, 2, 0, "f00d")]:
        assert tckpt.plan_cursor_extra(*args) == jckpt.plan_cursor_extra(*args)
        meta = {"step": 9, "extra": jckpt.plan_cursor_extra(*args)}
        assert tckpt.resume_cursor(meta) == jckpt.resume_cursor(meta)
    legacy = {"step": 9, "extra": {"solar_step": 5}}
    assert tckpt.resume_cursor(legacy) == jckpt.resume_cursor(legacy) == (5, None)
    assert tckpt.resume_cursor({"step": 9}) == jckpt.resume_cursor({"step": 9}) == (9, None)
