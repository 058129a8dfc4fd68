"""The port's LM training slice against the JAX package on the CPU: the
training loss and every gradient leaf, the train step, the launcher and
LM checkpoints, for the dense (qwen2-0.5b), hybrid (hymba-1.5b) and ssm
(falcon-mamba-7b) families at ``reduced()`` in f32, from the same weights.

The JAX init leaves biases and norm scales at zero, which would hide a bias
or ``1 + scale`` bug, so every leaf gets seeded numpy noise before it is
handed to both sides (through ``convert.lm_params_from_jax``).

Tolerances.  The loss within 1e-5 relative: both sides run the same f32
operations, summed in different orders.  Each gradient leaf within 1e-4 of
its own max |value|: a gradient sums the same products over the batch and
the sequence in another order (and, through the selective scan, JAX's
log-step prefix scan against the port's), a few f32 ulps of the largest
element.  The train-step bounds are the JAX package's own
(``tests/test_train.py``), and the per-step loss of 5 steps follows the JAX
step within 1e-5 relative.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config, list_configs
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec, lm
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

# Files run in parallel worker processes: one intra-op thread keeps torch's
# thread pool from starving timing-sensitive tests in the other workers.
torch.set_num_threads(1)

ARCHS = ["qwen2-0.5b", "hymba-1.5b", "falcon-mamba-7b"]
B, S = 4, 64
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)


def _jax_tree(arch, seed=0, noise=0.05):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed),
                                                jax_config(arch).reduced()))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def _batch(cfg, b=B, s=S, seed=2, ignore=True, pad_rows=0):
    """Tokens and shifted labels from numpy; with ``ignore`` a few labels of
    -1, and ``pad_rows`` trailing rows of weight 0."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    if ignore:
        labels[:, -1] = -1
        labels[0, :5] = -1
    weights = np.ones((b,), np.float32)
    if pad_rows:
        weights[-pad_rows:] = 0.0
    return {"tokens": tokens, "labels": labels, "weights": weights}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_loss_and_grads(cfg, flat, batch):
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()}
    loss, metrics = lm.train_loss(lm.nested_params(leaves), _torch_batch(batch), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    return loss, metrics, dict(zip(leaves, grads))


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _leaf_close(got, want, tol=GRAD_TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k], np.float32), np.asarray(want[k], np.float32)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, f"{k}: max |diff| {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_every_gradient_match_jax(arch):
    tree = _jax_tree(arch)
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    batch = _batch(cfg, pad_rows=1)
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jlm.train_loss(p, _jax_batch(batch), jcfg), has_aux=True)(
            jax.tree.map(jnp.asarray, tree))
    loss, metrics, grads = _port_loss_and_grads(cfg, convert.lm_params_from_jax(tree, "cpu"),
                                                batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=LOSS_RTOL)
    assert float(metrics["tokens"]) == float(jm["tokens"])  # the unclamped weight mass
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    _leaf_close({k: g.numpy() for k, g in grads.items()}, _flatten(jgrads))


@pytest.mark.parametrize("arch", list_configs())
def test_arch_smoke_forward_and_grad(arch):
    """Reduced config: one forward and one gradient; finite (the counterpart
    of the JAX package's test_models.py smoke test, every family: the
    encoder-decoder through ``encdec``, vlm with patch embeddings)."""
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, b=2, s=32, ignore=False)
    rng = np.random.default_rng(3)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        batch["source"] = rng.standard_normal((2, cfg.source_len, cfg.d_model)).astype(
            np.float32)
    model = encdec if cfg.family == "encdec" else lm
    init = encdec.init_encdec if cfg.family == "encdec" else lm.init_lm
    flat = lm.flat_params(init(cfg, seed=0, device="cpu"))
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()}
    loss, _ = model.train_loss(lm.nested_params(leaves), _torch_batch(batch), cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                materialize_grads=True)
    assert np.isfinite(float(loss.detach()))
    for k, g in zip(leaves, grads):
        assert g.shape == flat[k].shape and torch.isfinite(g).all(), (arch, k)


def test_two_level_scan_matches_single_level():
    cfg = get_config("deepseek-7b").reduced().replace(num_layers=4)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg, b=2, s=32, ignore=False))
    l1 = lm.train_loss(params, batch, cfg)[0]
    l2 = lm.train_loss(params, batch, cfg.replace(scan_block=2))[0]
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_remat_and_two_level_scan_leave_the_gradient_unchanged():
    cfg = get_config("hymba-1.5b").reduced().replace(num_layers=4)
    flat = lm.flat_params(lm.init_lm(cfg, seed=0, device="cpu"))
    batch = _batch(cfg, b=2, s=32)
    _, _, want = _port_loss_and_grads(cfg.replace(remat=False), flat, batch)
    for variant in (cfg, cfg.replace(scan_block=2)):
        _, _, got = _port_loss_and_grads(variant, flat, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("chunks", [(32, 8), (32, 24)])
def test_ce_chunking_invariant(chunks):
    """The loss does not depend on ce_chunk; a chunk that does not divide S
    shrinks until it does (24 -> 16 at S = 32)."""
    cfg = get_config("qwen2-0.5b").reduced()
    params = lm.init_lm(cfg, seed=0, device="cpu")
    batch = _torch_batch(_batch(cfg, b=2, s=32))
    l1 = lm.train_loss(params, batch, cfg.replace(ce_chunk=chunks[0]))[0]
    l2 = lm.train_loss(params, batch, cfg.replace(ce_chunk=chunks[1]))[0]
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)


def test_flat_params_round_trip_and_jax_paths():
    tree = _jax_tree("hymba-1.5b")
    flat = convert.lm_params_from_jax(tree, "cpu")
    assert "layers.ssm.x_proj" in flat and "layers.ln_ssm" in flat
    assert list(lm.flat_params(lm.nested_params(flat))) == list(flat)
    back = convert.lm_params_to_jax(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert np.array_equal(a, b)
    assert not convert.is_surrogate_params(flat)
    assert convert.is_surrogate_params(["enc.0.w", "dec.1.b", "head.w1"])


# -- the train step: counterparts of the JAX package's tests/test_train.py -------

def _steps(arch, accum=1):
    cfg = get_config(arch).reduced().replace(grad_accum=accum)
    jcfg = jax_config(arch).reduced().replace(grad_accum=accum)
    opt = tadamw.AdamWConfig(**OPT)
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(
        lm.nested_params(p), b, cfg))
    return cfg, jcfg, opt, step


def _max_delta(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def test_zero_weight_padding_rows_are_exact_noops():
    """SOLAR's uneven batches are padded with weight-0 rows; the update must
    equal the unpadded batch's (paper Eq. 3)."""
    arch = "qwen2-0.5b"
    flat = convert.lm_params_from_jax(_jax_tree(arch), "cpu")
    cfg = get_config(arch).reduced()
    batch = _batch(cfg, b=8, s=32, ignore=False)
    pad = {k: np.concatenate([v, np.zeros_like(v)]) for k, v in batch.items()}
    opt = tadamw.AdamWConfig(**OPT)
    loss = lambda p, b: lm.train_loss(lm.nested_params(p), b, cfg)  # noqa: E731
    step1 = tstep.make_train_step(cfg.replace(grad_accum=4), opt, loss)
    step2 = tstep.make_train_step(cfg.replace(grad_accum=8), opt, loss)
    s1, m1 = step1(tstep.init_train_state(flat, opt), _torch_batch(batch))
    s2, m2 = step2(tstep.init_train_state(flat, opt), _torch_batch(pad))
    assert _max_delta(s1["params"], s2["params"]) < 1e-6
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5
    assert float(m2["tokens"]) == float(m1["tokens"])


def test_node_sample_remap_invariance():
    cfg, _, opt, step = _steps("hymba-1.5b")
    flat = convert.lm_params_from_jax(_jax_tree("hymba-1.5b"), "cpu")
    batch = _batch(cfg, b=8, s=32, ignore=False)
    perm = np.random.default_rng(5).permutation(8)
    shuffled = {k: v[perm] for k, v in batch.items()}
    s1, _ = step(tstep.init_train_state(flat, opt), _torch_batch(batch))
    s2, _ = step(tstep.init_train_state(flat, opt), _torch_batch(shuffled))
    assert _max_delta(s1["params"], s2["params"]) < 5e-6


def test_grad_accum_invariance():
    flat = convert.lm_params_from_jax(_jax_tree("falcon-mamba-7b"), "cpu")
    outs = []
    for accum in (1, 2, 4):
        cfg, _, opt, step = _steps("falcon-mamba-7b", accum)
        s, _ = step(tstep.init_train_state(flat, opt),
                    _torch_batch(_batch(cfg, b=8, s=32, ignore=False)))
        outs.append(s["params"])
    assert _max_delta(outs[0], outs[1]) < 1e-5
    assert _max_delta(outs[0], outs[2]) < 1e-5


def test_training_reduces_loss():
    cfg, _, opt, step = _steps("qwen2-0.5b")
    state = tstep.init_train_state(lm.flat_params(lm.init_lm(cfg, seed=0, device="cpu")), opt)
    batch = _torch_batch(_batch(cfg, b=8, s=32, ignore=False))
    first = None
    for _ in range(12):
        state, m = step(state, batch)
        first = first if first is not None else float(m["loss"])
    assert float(m["loss"]) < first * 0.8


@pytest.mark.parametrize("arch", ARCHS)
def test_per_step_loss_follows_the_jax_step(arch):
    """5 steps (grad_accum 2, a padding row) from the same params and
    batches: the port's loss follows the JAX step's within 1e-5."""
    cfg, jcfg, opt, step = _steps(arch, accum=2)
    jopt = jadamw.AdamWConfig(**OPT)
    jfn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    tree = _jax_tree(arch)
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jopt)
    ts = tstep.init_train_state(convert.lm_params_from_jax(tree, "cpu"), opt)
    for i in range(5):
        batch = _batch(cfg, b=4, s=32, seed=10 + i, pad_rows=1)
        js, jm = jfn(js, _jax_batch(batch))
        ts, tm = step(ts, _torch_batch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        assert float(tm["tokens"]) == float(jm["tokens"])


# -- checkpoints ------------------------------------------------------------------

def _lm_states():
    """The same one-step-trained hymba state in both packages."""
    arch = "hymba-1.5b"
    jcfg = jax_config(arch).reduced()
    jopt = jadamw.AdamWConfig(**OPT)
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    tree = _jax_tree(arch)
    js, _ = fn(jstep.init_train_state(jax.tree.map(jnp.asarray, tree), jopt),
               _jax_batch(_batch(jcfg, b=2, s=32)))
    jsn = jax.tree.map(np.asarray, js)
    ts = {"params": convert.lm_params_from_jax(jsn["params"], "cpu"),
          "opt": tadamw.OptState(convert.lm_params_from_jax(jsn["opt"].mu, "cpu"),
                                 convert.lm_params_from_jax(jsn["opt"].nu, "cpu"),
                                 torch.tensor(int(jsn["opt"].step), dtype=torch.int32))}
    return js, ts, jopt


def test_lm_checkpoint_cross_loads_bit_exact_both_ways(tmp_path):
    js, ts, jopt = _lm_states()
    extra = tckpt.plan_cursor_extra(1, 0, 0, plan_hash="abc")
    path = tckpt.save_checkpoint(str(tmp_path / "port"), 1, ts, extra=extra)
    jpath = jckpt.save_checkpoint(str(tmp_path / "jax"), 1, js, extra=extra)
    names = {f[:-4] for f in os.listdir(path) if f.endswith(".npy")}
    assert names == {f[:-4] for f in os.listdir(jpath) if f.endswith(".npy")}
    assert "params__layers__ssm__x_proj" in names
    with open(os.path.join(path, "meta.json")) as f, open(os.path.join(jpath, "meta.json")) as g:
        assert json.load(f) == json.load(g)
    # the port's files restore in JAX ...
    jtemplate = jstep.init_train_state(
        jlm.init_lm(jax.random.PRNGKey(9), jax_config("hymba-1.5b").reduced()), jopt)
    restored, _ = jckpt.restore_checkpoint(path, jtemplate)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(js)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    # ... and JAX's in the port
    cfg = get_config("hymba-1.5b").reduced()
    template = tstep.init_train_state(lm.flat_params(lm.init_lm(cfg, seed=9, device="cpu")),
                                      tadamw.AdamWConfig(**OPT))
    back, _ = tckpt.restore_checkpoint(jpath, template)
    for top in ("params",):
        for k, want in ts[top].items():
            assert torch.equal(back[top][k], want), k
    for got, want in ((back["opt"].mu, ts["opt"].mu), (back["opt"].nu, ts["opt"].nu)):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    assert int(back["opt"].step) == 1


# -- the launcher -----------------------------------------------------------------

def _train_argv(tmp_path, *extra):
    return ["train", "--arch", "hymba-1.5b", "--reduced", "--device", "cpu",
            "--num-samples", "256", "--seq-len", "32", "--nodes", "2", "--local-batch", "4",
            "--buffer", "64", "--epochs", "1", "--num-workers", "2",
            "--data", str(tmp_path / "tokens.bin"), *extra]


def test_launcher_trains_on_planned_batches_and_resumes(tmp_path):
    ck = str(tmp_path / "ckpt")
    args = ttrain.build_parser().parse_args(_train_argv(
        tmp_path, "--steps", "4", "--checkpoint-dir", ck, "--checkpoint-every", "2"))
    full = ttrain.train(args)
    losses = [m["loss"] for m in full.metrics_history]
    assert len(losses) == 4 and all(np.isfinite(losses))
    cap = full.loader.capacity
    assert all(m["tokens"] <= 2 * cap * 32 for m in full.metrics_history)
    # resume from the step-2 checkpoint: the same steps and the same losses
    for name in os.listdir(ck):
        if name.endswith("00000004"):
            os.rename(os.path.join(ck, name), os.path.join(tmp_path, name))
    args = ttrain.build_parser().parse_args(_train_argv(
        tmp_path, "--steps", "4", "--checkpoint-dir", ck, "--resume"))
    res = ttrain.train(args)
    assert [m["step"] for m in res.metrics_history] == [2, 3]
    np.testing.assert_allclose([m["loss"] for m in res.metrics_history], losses[2:],
                               rtol=1e-5)


def test_launcher_plan_matches_the_jax_plan(tmp_path, capsys):
    argv = ["plan", "--loader", "solar", "--num-samples", "512", "--nodes", "4",
            "--local-batch", "8", "--buffer", "128", "--epochs", "2"]
    report = ttrain.main(argv + ["--out", str(tmp_path / "port.plan.npz")])
    capsys.readouterr()
    jtrain.main(argv + ["--out", str(tmp_path / "jax.plan.npz")])
    want = json.loads(capsys.readouterr().out)
    assert report == want
    inspected = ttrain.main(["plan", "--inspect", str(tmp_path / "jax.plan.npz")])
    assert inspected == want


def _untimed(summary):
    """A ``DistributedReport.summary()`` less its times."""
    if isinstance(summary, dict):
        return {k: _untimed(v) for k, v in summary.items()
                if k not in ("wall_time_s", "latency", "last_heartbeat_age_s")}
    if isinstance(summary, list):
        return [_untimed(v) for v in summary]
    return summary


@pytest.mark.dist
def test_launcher_refuses_the_subcommands_of_a_later_slice(tmp_path, capsys):
    """The subcommands of the later slices are ported and refuse nothing:
    ``stream --verify`` runs with its parities true (its summaries against
    the JAX CLI's: ``tests/test_torch_stream.py``), and ``distributed`` with
    ``--verify`` exits cleanly and prints what the JAX launcher prints for
    the same flags, less times."""
    stream = ttrain.main(["stream", "--nodes", "2", "--num-samples", "256",
                          "--window-steps", "4", "--watermark", "32", "--verify",
                          "--data", str(tmp_path / "stream")])
    assert json.loads(capsys.readouterr().out) == stream
    assert stream["verify"]["plan_parity"] and stream["verify"]["stream_parity"]
    argv = ["distributed", "--nodes", "2", "--peer-fetch", "--num-samples", "512",
            "--local-batch", "16", "--buffer", "128", "--epochs", "2", "--verify"]
    port = ttrain.main(argv + ["--data", str(tmp_path / "port.bin")])
    printed = json.loads(capsys.readouterr().out)
    jtrain.main(argv + ["--data", str(tmp_path / "jax.bin")])
    want = json.loads(capsys.readouterr().out)
    assert _untimed(printed) == _untimed(port) == _untimed(want)
    assert port["verify"] == {"digest_parity": True, "aggregate_parity": True,
                              "mismatched_ranks": [], "dead_ranks": []}
