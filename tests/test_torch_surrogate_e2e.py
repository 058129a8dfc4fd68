"""End to end on the port, on the CPU: SOLAR loader -> trainer -> checkpoint,
the counterparts of ``tests/test_system.py``'s system tests, and the port's
run held against the JAX ``Trainer``'s from the same parameters and plan.

Tolerance of the 10-step comparison: per-step loss within 1e-5 relative.
Both runs see the same batches (the plans and stream digests are equal,
test_torch_data.py) and start from the same parameters; they differ only in
the f32 order of the convolutions' sums (test_torch_cnn.py), which the
optimizer carries from step to step."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as rdata
from repro.configs.surrogates import SURROGATES as JAX_SURROGATES
from repro.models import cnn as jcnn
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train.step import init_train_state as j_init_train_state
from repro.train.step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs.surrogates import SURROGATES
from repro_torch.core.scheduler import SolarConfig
from repro_torch.data import LoaderSpec, build_pipeline, create_synthetic_store
from repro_torch.launch import train_surrogate
from repro_torch.models import cnn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)

LOSS_RTOL = 1e-5


class _Cfg:
    grad_accum = 1
    grad_accum_dtype = "float32"


@pytest.fixture(scope="module")
def surrogate_setup(tmp_path_factory):
    cfg = SURROGATES["ptychonn"].reduced()
    d = tmp_path_factory.mktemp("e2e")
    store = create_synthetic_store(
        str(d / "x.bin"), num_samples=256,
        sample_shape=cfg.input_shape, dtype=np.float32, kind="random",
    )
    yield cfg, store
    store.close()


def _ld(name, store, num_nodes=2, local_batch=8, num_epochs=2, buffer_size=64, **kw):
    return build_pipeline(LoaderSpec(
        loader=name, store=store, num_nodes=num_nodes, local_batch=local_batch,
        num_epochs=num_epochs, buffer_size=buffer_size, seed=0, collect_data=True, **kw))


def _params(cfg):
    return cnn.init_surrogate(cfg, generator=torch.Generator().manual_seed(0), device="cpu")


def _trainer(cfg, store, loader_name, steps=8, ckpt=None, every=0, skip=0, state=None,
             prefetch_depth=2):
    store.reset_counters()
    ld = _ld(loader_name, store)
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(_Cfg(), opt, lambda p, b: cnn.surrogate_loss(p, b, cfg))
    t = Trainer(loader=ld, step_fn=step,
                state=state if state is not None else init_train_state(_params(cfg), opt),
                make_batch=train_surrogate.make_batch_fn(cfg, ld.capacity),
                checkpoint_dir=ckpt, checkpoint_every=every, skip_steps=skip,
                prefetch_depth=prefetch_depth, num_workers=2, device="cpu")
    t.run(max_steps=steps)
    return t


def test_end_to_end_solar_training(surrogate_setup):
    cfg, store = surrogate_setup
    t = _trainer(cfg, store, "solar", steps=10)
    losses = [m["loss"] for m in t.metrics_history]
    assert len(losses) == 10
    assert all(np.isfinite(v) for v in losses)
    assert min(losses) < losses[0]
    assert losses[-1] < losses[0] * 2.0
    bd = t.breakdown()
    assert bd["load_s"] > 0 and bd["compute_s"] > 0
    assert bd["loader_internal"]["loader"] == "solar"


@pytest.mark.parametrize("name", ["naive", "solar"])
def test_end_to_end_data_volume(surrogate_setup, name):
    cfg, store = surrogate_setup
    t = _trainer(cfg, store, name, steps=6)
    assert sum(m["tokens"] for m in t.metrics_history) == 6 * 16  # padding is weightless


def test_prefetch_depth_does_not_change_training(surrogate_setup):
    cfg, store = surrogate_setup
    a = _trainer(cfg, store, "solar", steps=5, prefetch_depth=0)
    b = _trainer(cfg, store, "solar", steps=5, prefetch_depth=2)
    assert [m["loss"] for m in a.metrics_history] == [m["loss"] for m in b.metrics_history]


def test_trainer_skip_steps_resume_cursor(surrogate_setup, tmp_path):
    cfg, store = surrogate_setup
    full = _trainer(cfg, store, "solar", steps=8)
    part = _trainer(cfg, store, "solar", steps=4, ckpt=str(tmp_path), every=4)
    restored, resume = Trainer.try_restore(str(tmp_path), part.state)
    assert resume == 4
    for k, v in part.state["params"].items():
        assert torch.equal(restored["params"][k], v)
    resumed = _trainer(cfg, store, "solar", steps=8, skip=resume, state=restored)
    ids_full = [m["step"] for m in full.metrics_history]
    assert [m["step"] for m in resumed.metrics_history] == ids_full[resume:]
    # from the restored state the run continues exactly as the full one
    assert [m["loss"] for m in resumed.metrics_history] == \
        [m["loss"] for m in full.metrics_history][resume:]


def test_try_restore_refuses_a_different_plan(surrogate_setup, tmp_path):
    cfg, store = surrogate_setup
    t = _trainer(cfg, store, "solar", steps=2, ckpt=str(tmp_path), every=2)
    plan_hash = t.loader.config_hash
    assert Trainer.try_restore(str(tmp_path), t.state, plan_hash=plan_hash)[1] == 2
    with pytest.raises(ValueError, match="different plan"):
        Trainer.try_restore(str(tmp_path), t.state, plan_hash="0" * 16)
    assert Trainer.try_restore(str(tmp_path / "none"), t.state)[1] == 0


def test_solar_gradient_equals_vanilla_gradient(surrogate_setup):
    """The batch SOLAR emits at step k yields the same synchronized gradient
    as the vanilla loader's step-k batch (paper Eq. 3)."""
    cfg, store = surrogate_setup
    params = _params(cfg)

    def grads_for(loader_name, **kw):
        ld = _ld(loader_name, store, num_epochs=1, **kw)
        mk = train_surrogate.make_batch_fn(cfg, ld.capacity)
        out = []
        for sb in ld:
            b = {k: torch.from_numpy(v) for k, v in mk(sb).items()}
            leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
            loss, m = cnn.surrogate_loss(leaves, b, cfg)
            out.append(torch.autograd.grad(loss * m["tokens"], list(leaves.values())))
        return out

    vanilla = grads_for("naive")
    solar = grads_for("solar", solar=SolarConfig(num_nodes=2, local_batch=8, buffer_size=64))
    assert len(vanilla) == len(solar) > 0
    for gv, gs in zip(vanilla, solar):
        for a, b in zip(gv, gs):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("loader", ["naive", "solar"])
def test_port_loss_follows_the_jax_trainer_for_10_steps(surrogate_setup, loader):
    cfg, store = surrogate_setup
    jcfg = JAX_SURROGATES["ptychonn"].reduced()
    jparams = jcnn.init_surrogate(jax.random.PRNGKey(0), jcfg)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=10)

    rstore = rdata.open_store(store.path, "binary")
    try:
        rld = rdata.build_pipeline(rdata.LoaderSpec(
            loader=loader, store=rstore, num_nodes=2, local_batch=8, num_epochs=2,
            buffer_size=64, seed=0, collect_data=True))
        mk = train_surrogate.make_batch_fn(cfg, rld.capacity)
        jstep = jax.jit(j_make_train_step(_Cfg(), JAdamWConfig(**opt),
                                          lambda p, b: jcnn.surrogate_loss(p, b, jcfg)))
        jt = JTrainer(loader=rld, step_fn=jstep,
                      state=j_init_train_state(jparams, JAdamWConfig(**opt)),
                      make_batch=lambda sb: {k: jnp.asarray(v) for k, v in mk(sb).items()},
                      num_workers=2)
        jt.run(max_steps=10)
    finally:
        rstore.close()

    tld = _ld(loader, store)
    assert tld.config_hash == rld.config_hash  # the same plan
    tparams = convert.surrogate_params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tstep = make_train_step(_Cfg(), AdamWConfig(**opt),
                            lambda p, b: cnn.surrogate_loss(p, b, cfg))
    tt = Trainer(loader=tld, step_fn=tstep, state=init_train_state(tparams, AdamWConfig(**opt)),
                 make_batch=mk, num_workers=2, device="cpu")
    tt.run(max_steps=10)

    jh, th = jt.metrics_history, tt.metrics_history
    assert len(th) == len(jh) == 10
    assert [m["step"] for m in th] == [m["step"] for m in jh]
    assert [m["tokens"] for m in th] == [m["tokens"] for m in jh]
    np.testing.assert_allclose([m["loss"] for m in th], [m["loss"] for m in jh],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([m["lr"] for m in th], [m["lr"] for m in jh], rtol=1e-6)
    assert jh[-1]["loss"] < jh[0]["loss"]


def test_launcher_trains_both_loaders_and_resumes(tmp_path, capsys):
    common = ["--arch", "ptychonn", "--reduced", "--device", "cpu",
              "--num-samples", "256", "--nodes", "2", "--local-batch", "8",
              "--buffer", "64", "--epochs", "1", "--num-workers", "2",
              "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    first = train_surrogate.main(common + ["--steps", "4"])
    assert sorted(first) == ["naive", "solar"]
    for r in first.values():
        assert r["steps"] == 4 and np.isfinite(r["last_loss"])
    assert first["solar"]["modeled_pfs_s"] < first["naive"]["modeled_pfs_s"]
    out = capsys.readouterr().out
    assert "== solar ==" in out and "speedup (SOLAR vs naive)" in out
    resumed = train_surrogate.main(common + ["--steps", "6", "--resume"])
    assert all(r["steps"] == 2 for r in resumed.values())  # steps 4 and 5


def test_trainer_records_its_spans(surrogate_setup):
    """The flight recorder sees the loop: one make-batch and one compute
    span a step, stamped with the step; inside make-batch the padded batch
    (its rows and rows of weight 0) and its staging (its bytes), inside
    compute the step's phases; the prefetch waits with the queue's depth;
    the pipeline's assembly and its chunk reads stamped with the step they
    serve."""
    from repro_torch.obs import trace as obs_trace

    cfg, store = surrogate_setup
    store.reset_counters()
    ld = _ld("solar", store)
    opt = AdamWConfig(lr=1e-3)
    step = make_train_step(_Cfg(), opt, lambda p, b: cnn.surrogate_loss(p, b, cfg))
    make, batches = train_surrogate.make_batch_fn(cfg, ld.capacity), []

    def make_batch(sb):
        batches.append(make(sb))
        return batches[-1]

    t = Trainer(loader=ld, step_fn=step, state=init_train_state(_params(cfg), opt),
                make_batch=make_batch, prefetch_depth=2, num_workers=2, device="cpu")
    tracer = obs_trace.enable()
    try:
        t.run(max_steps=3)
    finally:
        assert obs_trace.disable() is tracer
    recs, threads, dropped = tracer.records()
    names = [obs_trace.kind_name(int(k)) for k in recs["kind"]]
    assert dropped == 0 and len(threads) == len(recs)
    main = threading.current_thread().name

    def rows(kind):
        return [(r, th) for r, th, n in zip(recs, threads, names) if n == kind]

    outer = {}
    for kind in ("train.make_batch", "train.compute"):
        got = rows(kind)
        assert [int(r["step"]) for r, _ in got] == [0, 1, 2]
        assert all(r["t1"] >= r["t0"] and th == main for r, th in got)
        outer[kind] = {int(r["step"]): r for r, _ in got}
    for kind, parent in (("batch.to_global", "train.make_batch"),
                         ("batch.stage", "train.make_batch"),
                         ("step.forward", "train.compute"),
                         ("step.backward", "train.compute"),
                         ("step.accumulate", "train.compute"),
                         ("step.optimizer", "train.compute")):
        got = rows(kind)
        assert [int(r["step"]) for r, _ in got] == [0, 1, 2], kind  # grad_accum 1
        for r, th in got:
            p = outer[parent][int(r["step"])]
            assert th == main and p["t0"] <= r["t0"] <= r["t1"] <= p["t1"], kind
    assert len(batches) == 3
    for (r, _), batch in zip(rows("batch.to_global"), batches):
        w = batch["weights"]
        assert (int(r["a"]), int(r["b"])) == (w.size, int(np.sum(w == 0)))
    for (r, _), batch in zip(rows("batch.stage"), batches):
        assert int(r["a"]) == sum(np.asarray(v).nbytes for v in batch.values())
    waits = rows("prefetch.qwait")
    assert len(waits) >= 3 and all(0 <= int(r["a"]) <= 2 and th == main for r, th in waits)
    # the pipeline assembles steps 0, 1, ... in order, each before the
    # trainer takes it, and a step's chunk reads end before its assembly
    assembled = {int(r["step"]): r for r, _ in rows("prefetch.assemble")}
    assert {th for _, th in rows("prefetch.assemble")} == {"solar-pipeline"}
    assert sorted(assembled) == list(range(len(assembled))) and len(assembled) >= 3
    for s in range(3):
        assert assembled[s]["t1"] <= outer["train.make_batch"][s]["t0"]
    reads = rows("chunk.read")
    assert {int(r["step"]) for r, _ in reads} >= {0}
    for r, th in reads:
        assert th.startswith("solar-io")
        if int(r["step"]) in assembled:
            assert r["t1"] <= assembled[int(r["step"])]["t1"]
        else:  # read ahead for a step the run stopped before
            assert int(r["step"]) > max(assembled)
    assert obs_trace.get().enabled is False  # back to the no-op tracer
