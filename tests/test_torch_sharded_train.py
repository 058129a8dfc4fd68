"""The port's sharding on several ranks: the sharded train step, the int8
all-reduce and the elastic restore on 4 gloo ranks of this CPU, against the
port's unsharded step and the JAX package.

One spawn of 4 ranks (``tests/_sharded_ranks.py``, one torch thread each)
carries every multi-rank check: on a ``("data", "model")`` = (2, 2) mesh,
two sharded steps of hymba-1.5b, qwen2-0.5b and qwen2-moe-a2.7b at
``reduced()`` in f32 (grad_accum 2, 2 SOLAR nodes of 3 and 2 real rows
padded to capacity 4), one step of qwen2-0.5b on a ``("pod", "data",
"model")`` = (2, 2, 1) mesh (the batch split pod-major over two mesh dims),
``compressed_psum`` over the world and over the data axis, the restore
of a checkpoint the JAX package wrote, and sharded saves, one of which
fails on rank 0.

The reference of a sharded step.  Data rank r trains SOLAR node r's rows and
cuts its ``grad_accum`` microbatches from them, so the sharded step with
grad_accum A over D data ranks is the unsharded step with grad_accum A·D
(``train/step.py``): the comparisons take that step, in the port and in the
JAX package.  For the families whose loss is a sum over rows (all but moe,
whose router aux loss depends on a microbatch's tokens) it is also the step
with grad_accum A, by Eq. (3): checked for hymba-1.5b and qwen2-0.5b.

Where the model splits its compute along ``model`` (every family here,
the moe family by experts: ``distributed/tensor_parallel.py``), the
sharded step's f32 operations are not the unsharded step's: a
row-parallel product sums its halves over two ranks.  Reduced hymba-1.5b's gradients move by 4e-6 of
their max when one leaf moves by an ulp, so no two orders of its f32
operations agree within 1e-5: its split step is held to the unsharded step
at ``SPLIT_TOL``.  The split steps are also held, at the bounds of an
unsplit step, to the step that does the same f32 operations with no data
axis: a pair of model ranks of a ``("replica", "data", "model")`` =
(2, 1, 2) mesh training the whole batch (``_sharded_ranks``), at
grad_accum A·D and A.

Tolerances.  Against the port's unsharded step, or the replica step: the
loss within 1e-6 relative and every rank's shard of every param and AdamW
moment within 1e-5 of the leaf's max |value| (the same f32 operations;
gradients summed over ranks in another order).  Reduced hymba-1.5b's split
step against the unsharded step: every shard within 1e-4 of its leaf's max,
the bound of ``tests/test_torch_tensor_parallel.py`` (its worst shard, of
a param or a moment, measured 6.7e-5 on a CPU, its loss 7.7e-8 relative;
qwen2-0.5b's split step measured 2.3e-6 and 8.0e-8, within the unsplit
bounds).  Against the JAX step: the loss within 1e-5
relative and each param leaf within 1e-4 of its max, the bounds of
``tests/test_torch_lm_train.py``.  ``compressed_psum`` and the restore are
exact.  The steps take AdamW's eps at 1e-3 (``_sharded_ranks.OPT`` says
why): with 1e-8 the update of an element whose gradient is near eps follows
the gradient's last bits, and a sum over ranks in another order moves such
params by up to a learning rate.
"""
import multiprocessing as mp
import queue as queue_mod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sharded_ranks as ranks
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jax_config
from repro.distributed import compression as jcomp
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import convert
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import get_config
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import sharding as tsh
from repro_torch.models import lm
from repro_torch.optim import adamw as tadamw
from repro_torch.train import step as tstep

torch.set_num_threads(1)

pytestmark = pytest.mark.dist

ARCHS = ["hymba-1.5b", "qwen2-0.5b", "qwen2-moe-a2.7b"]
LINEAR = ["hymba-1.5b", "qwen2-0.5b"]  # no per-microbatch term in the loss
SPLIT = ["hymba-1.5b", "qwen2-0.5b"]   # split at (2, 2), held to the replica step
SPLIT_TOL = {"hymba-1.5b": 1e-4}        # shard tol against the unsharded step
ACCUM, DATA = 2, 2
B, S = 8, 32                            # 2 nodes x capacity 4
WEIGHTS = np.array([1, 1, 1, 0, 1, 1, 0, 0], np.float32)
SPAWN_TIMEOUT_S = 240
PSUM = dict(kind="psum", seed=100, shape=(3, 1000))


def _jax_tree(arch, seed=0, noise=0.05):
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.PRNGKey(seed),
                                                jax_config(arch).reduced()))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(lambda a: (a + noise * rng.standard_normal(a.shape)).astype(a.dtype),
                        tree)


def _batch(seed):
    """The padded global batch of two uneven nodes, node by node."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[1, :5] = -1
    return {"tokens": tokens, "labels": labels, "weights": WEIGHTS.copy()}


BATCHES = [_batch(20), _batch(21)]


def _flat_np(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_np(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _jax_ckpt(path):
    """A one-step-trained reduced hymba-1.5b state, saved by the JAX package."""
    jcfg = jax_config("hymba-1.5b").reduced()
    jopt = jadamw.AdamWConfig(**ranks.OPT)
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js, _ = fn(jstep.init_train_state(jax.tree.map(jnp.asarray, _jax_tree("hymba-1.5b")),
                                      jopt), {k: jnp.asarray(v) for k, v in _batch(5).items()})
    return jckpt.save_checkpoint(str(path), 1, js), jax.tree.map(np.asarray, js)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the 4 ranks once; returns (per-rank results, the JAX state the
    restore job read)."""
    tmp = tmp_path_factory.mktemp("sharded")
    ckpt, jstate = _jax_ckpt(tmp / "ckpt")
    jobs = {arch: dict(kind="train", arch=arch, accum=ACCUM, params=_jax_tree(arch),
                       batches=BATCHES) for arch in ARCHS}
    for arch in SPLIT:
        for accum in (ACCUM, ACCUM * DATA):
            jobs[f"{arch} replica {accum}"] = dict(kind="train", arch=arch, accum=accum,
                                                   mesh="replica", params=_jax_tree(arch),
                                                   batches=BATCHES)
    jobs["pod"] = dict(kind="train", arch="qwen2-0.5b", accum=ACCUM, pod=True,
                       params=_jax_tree("qwen2-0.5b"), batches=BATCHES[:1])
    jobs["psum"] = PSUM
    jobs["restore"] = dict(kind="restore", arch="hymba-1.5b", path=ckpt)
    (tmp / "blocker").write_text("a file where a directory would go")
    jobs["save"] = dict(kind="save", arch="qwen2-0.5b", path=str(tmp / "saves"),
                        bad=str(tmp / "blocker" / "saves"))
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=ranks.run_rank, args=(r, str(tmp / "pg"), jobs, q))
             for r in range(ranks.WORLD)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, out = q.get(timeout=SPAWN_TIMEOUT_S)
            if isinstance(out, str):
                pytest.fail(f"rank {rank} failed:\n{out}")
            results[rank] = out
    except queue_mod.Empty:
        pytest.fail(f"ranks {sorted(set(range(ranks.WORLD)) - set(results))} "
                    f"gave no result in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results, jstate


def _block(full, spec, sizes, coord):
    """A rank's block of ``full`` under ``spec``: each dim split over its
    entry's axes, the first axis major (JAX's combined-axis order)."""
    index = []
    for dim, entry in enumerate(tuple(spec) + (None,) * (full.ndim - len(spec))):
        names = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        i, parts = 0, 1
        for n in names:
            i, parts = i * sizes[n] + coord[n], parts * sizes[n]
        n = full.shape[dim] // parts
        index.append(slice(i * n, (i + 1) * n))
    return full[tuple(index)]


def _port_steps(arch, accum, batches):
    cfg = get_config(arch).reduced().replace(grad_accum=accum)
    opt = tadamw.AdamWConfig(**ranks.OPT)
    step = tstep.make_train_step(cfg, opt, lambda p, b: lm.train_loss(
        lm.nested_params(p), b, cfg))
    state = tstep.init_train_state(convert.lm_params_from_jax(_jax_tree(arch), "cpu"), opt)
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    host = {name: {k: convert.tensor_to_numpy(v).astype(np.float32) for k, v in d.items()}
            for name, d in (("params", state["params"]), ("mu", state["opt"].mu),
                            ("nu", state["opt"].nu))}
    return metrics, host


def _whole(results, job):
    """The whole leaves of replica 0's step ``job`` from its two model
    ranks' shards, and its metrics."""
    parts = {o["replica_coord"]["model"]: o[job] for o in results.values()
             if o["replica_coord"]["replica"] == 0}
    host = {}
    for name in ("params", "mu", "nu"):
        host[name] = {}
        for k, spec in parts[0]["specs"].items():
            dims = [i for i, e in enumerate(spec) if e == "model"]
            blocks = [parts[m][name][k].astype(np.float32) for m in (0, 1)]
            host[name][k] = np.concatenate(blocks, axis=dims[0]) if dims else blocks[0]
    return parts[0]["metrics"], host


def _assert_shards(results, want, tol, key="coord", sizes=None, names=("params", "mu", "nu")):
    sizes = sizes or {"data": 2, "model": 2}
    for rank, out in results.items():
        for name in names:
            for k, full in want[name].items():
                got = out[name][k].astype(np.float32)
                ref = _block(full, out["specs"][k], sizes, out[key])
                assert got.shape == ref.shape, (rank, name, k, got.shape, ref.shape)
                scale = max(float(np.abs(full).max()), 1e-30)
                err = float(np.abs(got - ref).max())
                assert err <= tol * scale, f"rank {rank} {name} {k}: {err:.3e} > {tol} * {scale:.3e}"


def _assert_step(results, arch, metrics, want, tols=(1e-6, 1e-5)):
    """Every rank's (2, 2) step of ``arch`` against (metrics, whole leaves)."""
    for out in results.values():
        for got, ref in zip(out[arch]["metrics"], metrics):
            assert abs(got["loss"] - ref["loss"]) <= tols[0] * abs(ref["loss"])
            assert got["tokens"] == ref["tokens"]
    _assert_shards({r: {**o[arch], "coord": o["coord"]} for r, o in results.items()}, want,
                   tols[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_unsharded_step_on_every_rank(run, arch):
    results, _ = run
    _assert_step(results, arch, *_port_steps(arch, ACCUM * DATA, BATCHES),
                 (1e-6, SPLIT_TOL.get(arch, 1e-5)))


@pytest.mark.parametrize("arch", LINEAR)
def test_sharded_step_keeps_the_update_of_grad_accum_a(run, arch):
    """Eq. (3): cutting microbatches from each node's rows leaves the update
    of a loss that sums over rows unchanged."""
    results, _ = run
    _assert_step(results, arch, *_port_steps(arch, ACCUM, BATCHES),
                 (1e-6, SPLIT_TOL.get(arch, 1e-5)))


@pytest.mark.parametrize("accum", [ACCUM * DATA, ACCUM])
@pytest.mark.parametrize("arch", SPLIT)
def test_split_step_matches_the_replica_step_on_every_rank(run, arch, accum):
    """A split step against a split step of the same f32 operations with no
    data axis, at grad_accum A·D and, by Eq. (3), A."""
    results, _ = run
    _assert_step(results, arch, *_whole(results, f"{arch} replica {accum}"))


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_jax_step(run, arch):
    results, _ = run
    jcfg = jax_config(arch).reduced().replace(grad_accum=ACCUM * DATA)
    jopt = jadamw.AdamWConfig(**ranks.OPT)
    fn = jax.jit(jstep.make_train_step(jcfg, jopt, lambda p, b: jlm.train_loss(p, b, jcfg)))
    js = jstep.init_train_state(jax.tree.map(jnp.asarray, _jax_tree(arch)), jopt)
    losses = []
    for b in BATCHES:
        js, m = fn(js, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
    for out in results.values():
        np.testing.assert_allclose([m["loss"] for m in out[arch]["metrics"]], losses,
                                   rtol=1e-5)
    want = {"params": _flat_np(jax.tree.map(np.asarray, js["params"]))}
    _assert_shards({r: {**o[arch], "coord": o["coord"]} for r, o in results.items()}, want,
                   1e-4, names=("params",))


def test_batch_split_pod_major_over_two_mesh_dims(run):
    """On (pod, data, model) = (2, 2, 1) the 8 rows go 2 a rank, pod-major,
    and gradients sum over both dims: the unsharded step at grad_accum 8."""
    results, _ = run
    metrics, want = _port_steps("qwen2-0.5b", ACCUM * 4, BATCHES[:1])
    for out in results.values():
        got = out["pod"]["metrics"][0]
        assert abs(got["loss"] - metrics[0]["loss"]) <= 1e-6 * abs(metrics[0]["loss"])
    _assert_shards({r: {**o["pod"], "pod_coord": o["pod_coord"]} for r, o in results.items()},
                   want, 1e-5, key="pod_coord", sizes={"pod": 2, "data": 2, "model": 1})
    specs = results[0]["pod"]["specs"]
    assert specs["layers.wq"] == (None, ("pod", "data"), "model", None)


def _qd_inputs():
    return [torch.from_numpy(np.random.default_rng(PSUM["seed"] + r)
                             .standard_normal(PSUM["shape"]).astype(np.float32))
            for r in range(ranks.WORLD)]


def test_compressed_psum_is_the_rank_ordered_sum_bit_for_bit(run):
    results, _ = run
    qd = [tcomp.quantize_dequantize(x) for x in _qd_inputs()]
    world = qd[0]
    for x in qd[1:]:
        world = world + x
    for rank, out in results.items():
        assert np.array_equal(out["psum"]["world"], world.numpy()), rank
        # the data axis: ranks (0, m) and (1, m), in data order
        pair = [r for r, o in results.items() if o["coord"]["model"] == out["coord"]["model"]]
        pair.sort(key=lambda r: results[r]["coord"]["data"])
        assert np.array_equal(out["psum"]["data"], (qd[pair[0]] + qd[pair[1]]).numpy()), rank
    # and the JAX package's numerics: quantize_dequantize bit for bit
    jqd = np.asarray(jcomp.quantize_dequantize(jnp.asarray(_qd_inputs()[0].numpy())))
    assert np.array_equal(jqd, qd[0].numpy())


def test_elastic_restore_of_a_jax_checkpoint_onto_the_mesh(run):
    results, jstate = run
    want = {**{f"params.{k}": v for k, v in _flat_np(jstate["params"]).items()},
            **{f"mu.{k}": v for k, v in _flat_np(jstate["opt"].mu).items()},
            **{f"nu.{k}": v for k, v in _flat_np(jstate["opt"].nu).items()}}
    sharded = 0
    for rank, out in results.items():
        res = out["restore"]
        assert res["dtensor"] and res["step"] == 1 and res["opt_step"] == int(jstate["opt"].step)
        assert sorted(res["leaves"]) == sorted(want)
        for k, full in want.items():
            block = _block(full, res["specs"][k], {"data": 2, "model": 2}, out["coord"])
            assert np.array_equal(res["leaves"][k].astype(np.float32), block), (rank, k)
            sharded += block.size < full.size
    assert sharded > 0  # some leaves really are split


def test_sharded_saves_end_alike_on_every_rank(run):
    """Rank 0 alone writes a sharded state; every rank learns the path it
    committed (``save_checkpoint``, ``AsyncCheckpointer.wait``), and a write
    that fails on rank 0 raises on every rank instead of leaving the others
    waiting."""
    results, _ = run
    saves = [out["save"] for out in results.values()]
    for kind in ("sync", "async"):
        paths = {s[kind] for s in saves}
        assert len(paths) == 1 and paths.pop().endswith(f"step_0000000{1 + (kind == 'async')}")
        assert all(s[f"{kind}_committed"] for s in saves)
    for rank, s in results.items():
        for kind in ("sync_error", "async_error"):
            err = s["save"][kind]
            assert err is not None, (rank, kind)
            if rank != 0:
                assert err.startswith("RuntimeError: rank 0 failed"), (rank, err)


# -- world 1, in this process -------------------------------------------------------


@pytest.fixture()
def one_rank():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_elastic_restore_with_shardings(one_rank, tmp_path):
    """``tests/test_checkpoint.py:95``: restore onto explicit (single-device)
    shardings — the mesh-change path."""
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config("qwen2-0.5b").reduced()
    state = tstep.init_train_state(lm.flat_params(lm.init_lm(cfg, seed=0, device="cpu")),
                                   tadamw.AdamWConfig())
    path = tckpt.save_checkpoint(str(tmp_path), 1, state)
    mesh = make_local_mesh("cpu")
    sh = tsh.param_sharding(state, mesh)
    restored, _ = tckpt.restore_checkpoint(path, state, shardings=sh)
    leaf = restored["params"]["embed"]
    assert leaf.device_mesh.shape == (1, 1) and leaf.device_mesh.mesh_dim_names[0] == "data"
    assert torch.equal(leaf.full_tensor(), state["params"]["embed"])


def test_compressed_psum_matches_jax_at_world_1(one_rank):
    """``tests/test_train.py:125``: at world 1 the collective is
    ``quantize_dequantize``, and equals the JAX package's ``compressed_psum``
    on a (1,) mesh."""
    from jax.sharding import PartitionSpec as P

    shard_map = getattr(jax, "shard_map", None)
    if shard_map is None:  # jax < 0.8
        from jax.experimental.shard_map import shard_map
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (4, 256)))
    mesh = jax.make_mesh((1,), ("dp",))
    want = shard_map(lambda v: jcomp.compressed_psum(v, "dp"), mesh=mesh,
                     in_specs=P("dp"), out_specs=P("dp"))(jnp.asarray(x))
    got = tcomp.compressed_psum(torch.from_numpy(x))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tcomp.quantize_dequantize(torch.from_numpy(x)))


def test_sharded_step_on_one_rank_is_the_plain_step_bit_for_bit(one_rank, tmp_path):
    """A mesh of one rank moves no value: two sharded steps on a (1, 1)
    mesh equal the plain step's, bit for bit, and so does a third step
    from the sharded state saved and restored onto the mesh (every leaf a
    DTensor then, the step counter too)."""
    from repro_torch.launch.mesh import make_local_mesh

    arch = "hymba-1.5b"
    cfg = get_config(arch).reduced().replace(grad_accum=ACCUM)
    opt = tadamw.AdamWConfig(**ranks.OPT)
    fn = lambda p, b: lm.train_loss(lm.nested_params(p), b, cfg)  # noqa: E731
    flat = convert.lm_params_from_jax(_jax_tree(arch), "cpu")
    mesh = make_local_mesh("cpu")
    plain = tstep.init_train_state({k: v.clone() for k, v in flat.items()}, opt)
    sharded = tstep.init_train_state({k: v.clone() for k, v in flat.items()}, opt, mesh=mesh)
    pstep = tstep.make_train_step(cfg, opt, fn)
    sstep = tstep.make_train_step(cfg, opt, fn, mesh=mesh)
    for b in BATCHES:
        b = {k: torch.from_numpy(v) for k, v in b.items()}
        plain, pm = pstep(plain, b)
        sharded, sm = sstep(sharded, b)
        assert torch.equal(pm["loss"], sm["loss"]) and torch.equal(pm["grad_norm"],
                                                                   sm["grad_norm"])
    for k, p in plain["params"].items():
        assert torch.equal(sharded["params"][k].full_tensor(), p), k
        assert torch.equal(sharded["opt"].nu[k].full_tensor(), plain["opt"].nu[k]), k
    path = tckpt.save_checkpoint(str(tmp_path), 2, sharded)
    restored, _ = tckpt.restore_checkpoint(path, sharded,
                                           shardings=tsh.param_sharding(sharded, mesh))
    b = {k: torch.from_numpy(v) for k, v in _batch(22).items()}
    plain, pm = pstep(plain, b)
    restored, rm = sstep(restored, b)
    assert torch.equal(pm["loss"], rm["loss"])
    for k, p in plain["params"].items():
        assert torch.equal(restored["params"][k].full_tensor(), p), k


def test_sharded_step_refuses_a_mesh_without_a_process_group():
    fake = type("FakeMesh", (), {"axis_names": ("data", "model")})()
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tstep.make_train_step(cfg, tadamw.AdamWConfig(), lambda p, b: None, mesh=fake)
