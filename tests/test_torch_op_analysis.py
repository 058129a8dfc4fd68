"""``repro_torch.launch.op_analysis`` (the counterpart of
``repro.launch.hlo_analysis``, ``tests/test_hlo_analysis.py`` mirrored):
dot FLOPs and traffic against hand counts, views free, the peak of live
storages, the hand-written kernels' meta path against their work formulas
(scores admitted in closed form against a mask count), collectives in a
loop on a fake process group, and a meta run against a CPU run of the same
program."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro.launch.hlo_analysis import COLLECTIVE_KINDS as JAX_KINDS
from repro.launch.hlo_analysis import program_stats as jax_program_stats
from repro_torch.configs import SHAPES, get_config
from repro_torch.kernels import ops, work
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import dryrun, op_analysis
from repro_torch.launch.op_analysis import COLLECTIVE_KINDS, program_stats
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state

torch.set_num_threads(1)

JAX_KEYS = {"dot_flops", "traffic_bytes", "traffic_by_tag", "collectives"}


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_linear_conv_bmm_hand_counts(device):
    x, w, b = (torch.empty(s, device=device) for s in ((4, 8), (16, 8), (16,)))
    s = program_stats(F.linear, x, w, b)
    assert JAX_KEYS <= set(s) and s["collectives"]["ok"]
    assert s["dot_flops"] == 2 * 4 * 16 * 8
    assert s["dot_flops_by_dtype"] == {"float32": 2 * 4 * 16 * 8}
    # addmm reads bias, x and w, writes [4, 16]; the transpose of w is a view
    assert s["traffic_bytes"] == 4 * (16 + 4 * 8 + 16 * 8 + 4 * 16)

    x, w = torch.empty(2, 3, 8, 8, device=device), torch.empty(5, 3, 3, 3, device=device)
    s = program_stats(F.conv2d, x, w)
    assert s["dot_flops"] == 2 * (2 * 5 * 6 * 6) * (3 * 3 * 3)
    assert s["traffic_bytes"] == 4 * (x.numel() + w.numel() + 2 * 5 * 6 * 6)

    a, c = torch.empty(3, 4, 5, device=device, dtype=torch.bfloat16), \
        torch.empty(3, 5, 6, device=device, dtype=torch.bfloat16)
    s = program_stats(torch.bmm, a, c)
    assert s["dot_flops_by_dtype"] == {"bfloat16": 2 * 3 * 4 * 6 * 5}
    assert s["traffic_bytes"] == 2 * (a.numel() + c.numel() + 3 * 4 * 6)


def test_the_jax_hand_count_of_a_dot():
    """``test_program_stats_dot_flops``: a [8, 16] dot contracting 8."""
    from test_hlo_analysis import _FAKE

    a, w = meta(8, 8), meta(8, 16)
    assert program_stats(torch.mm, a, w)["dot_flops"] == jax_program_stats(_FAKE)["dot_flops"]
    assert COLLECTIVE_KINDS == JAX_KINDS


def test_views_are_free_and_share_a_storage():
    def views(x):
        return x.view(16, 4), x.t(), x[1:], x.transpose(0, 1)[2], x.expand(3, 4, 16)

    x = meta(4, 16)
    s = program_stats(views, x)
    assert s["ops"] >= 5 and s["traffic_bytes"] == 0 and s["dot_flops"] == 0
    assert s["peak_bytes"] == s["argument_bytes"] == 4 * 64
    assert s["output_bytes"] == s["alias_bytes"] == 4 * 64


def test_traffic_rules_for_copies_gathers_scatters_and_broadcasts():
    x, idx = meta(64, 8), torch.empty(5, dtype=torch.int64, device="meta")
    assert program_stats(lambda t, i: t[i], x, idx)["traffic_bytes"] == 2 * 5 * 8 * 4
    dst, src = meta(64, 8), meta(5, 8)
    s = program_stats(lambda d, i, v: d.index_put_((i,), v), dst, idx, src)
    assert s["traffic_bytes"] == 2 * (5 * 8 * 4 + 5 * 8)  # f32 values and int64 indices, twice
    s = program_stats(lambda d, v: d[:5].copy_(v), dst, src)
    assert s["traffic_bytes"] == 2 * 5 * 8 * 4
    # a broadcast input counts its distinct elements: x + a [8] row
    s = program_stats(lambda t, r: t + r, x, meta(8))
    assert s["traffic_bytes"] == 4 * (64 * 8 + 8 + 64 * 8)
    s = program_stats(lambda: torch.empty(10, device="meta"))
    assert s["traffic_bytes"] == 0 and s["peak_bytes"] == 0  # nothing on the device


def test_peak_counts_live_storages():
    def chain(x):
        for _ in range(10):
            y = x * 2
            x = y + 1
        return x

    def keep(x):
        return [x * 2 for _ in range(10)]

    x = meta(256 * 1024)
    mb = 1 << 20
    s = program_stats(chain, x)
    assert s["peak_bytes"] == 4 * mb  # x, the live y and the new x, and the old x
    assert s["output_bytes"] == mb and s["alias_bytes"] == 0
    assert program_stats(keep, x)["peak_bytes"] == 11 * mb


def test_admitted_scores_in_closed_form_equal_a_mask_count():
    for sq, sk, causal, window in itertools.product(
            [1, 2, 7, 64, 100], [1, 5, 64, 130], [True, False], [0, 1, 3, 16, 64, 200]):
        qpos, kpos = np.arange(sq)[:, None], np.arange(sk)[None, :]
        ok = np.ones((sq, sk), bool)
        if causal:
            ok &= kpos <= qpos
        if window > 0:
            ok &= qpos - kpos < window
        assert work.admitted_scores(sq, sk, causal, window) == ok.sum(), \
            (sq, sk, causal, window)
    # hymba-1.5b's 32k prefill, whose mask alone would take 1 GiB
    assert work.admitted_scores(32768, 32768, True, 1024) == \
        1024 * 1025 // 2 + (32768 - 1024) * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_meta_records_equal_their_formulas(dtype):
    b, h, kh, s, hd, di, n, d = 2, 4, 2, 96, 64, 48, 16, 80

    def leaf(*shape, dt=dtype):
        return meta(*shape, dtype=dt).requires_grad_(True)

    q, k, v = leaf(b, h, s, hd), leaf(b, kh, s, hd), leaf(b, kh, s, hd)
    u, dt_, bm, cm = leaf(b, s, di), leaf(b, s, di), leaf(b, s, n), leaf(b, s, n)
    a, dsk = leaf(di, n, dt=torch.float32), leaf(di, dt=torch.float32)
    x, scale = leaf(b, s, d), leaf(d)
    counts = {"launches": [m.launches for m in (fa, ss, rn)]}

    def program(q, k, v, u, dt_, a, bm, cm, dsk, x, scale):
        o = ops.flash_attention(q, k, v, causal=True, window=40)
        y, h_last = ops.selective_scan(u, dt_, a, bm, cm, dsk)
        z = ops.rms_norm(x, scale)
        assert (o.shape, o.dtype, y.shape, y.dtype, h_last.shape, z.shape, z.dtype) == \
            (q.shape, dtype, u.shape, torch.float32, (b, di, n), x.shape, dtype)
        torch.autograd.grad(o.sum() + y.sum() + z.sum(), [q, k, v, u, dt_, a, bm, cm, dsk,
                                                           x, scale])

    stats = program_stats(program, q, k, v, u, dt_, a, bm, cm, dsk, x, scale)
    it = dtype.itemsize
    want = {
        "flash_attention": work.attention(b, h, kh, s, s, hd, True, 40, it, lse=True),
        "flash_attention_bwd": work.attention_bwd(b, h, kh, s, s, hd, True, 40, it),
        "selective_scan": work.scan(b, s, di, n, it, ckpt_steps=ss.CKPT_STEPS),
        "selective_scan_bwd": work.scan_bwd(b, s, di, n, it, ckpt_steps=ss.CKPT_STEPS),
        "rms_norm": work.norm(b * s, d, it, it),
        "rms_norm_bwd": work.norm_bwd(b * s, d, it, it),
    }
    assert stats["kernels"] == {name: {"calls": 1, **w._asdict()} for name, w in want.items()}
    admitted = work.admitted_scores(s, s, True, 40) * b * h
    assert stats["dot_flops_by_dtype"][str(dtype).removeprefix("torch.")] >= \
        14 * hd * admitted
    assert stats["traffic_by_tag"]["kernels"] == sum(w.bytes for w in want.values())
    # nothing was launched, and nothing counted as a launch
    assert counts["launches"] == [m.launches for m in (fa, ss, rn)]


def test_collective_bytes_loop_weighted():
    """``test_collective_bytes_loop_weighted``: an all-reduce in a 24-turn
    loop counts 24 times, an all-gather at top level once."""
    with dryrun.fake_world(8):
        group = dist.new_group(list(range(4)))

        def program(a):
            out = a.new_empty((16, 16))
            dist.all_gather_into_tensor(out, a.reshape(4, 16).repeat(1, 1), group=group)
            x = a.clone()
            for _ in range(24):
                dist.all_reduce(x, group=group)
            return out, x

        s = program_stats(program, meta(8, 8))
    coll = s["collectives"]
    assert coll["ok"]
    assert coll["all-reduce"] == 8 * 8 * 4 * 24
    assert coll["all-gather"] == 16 * 16 * 4
    assert coll["total"] == coll["all-reduce"] + coll["all-gather"] == coll["flat_total"]
    assert not dist.is_initialized()


def _cpu_args(name, margs, cfg, rows, seq):
    rng = np.random.default_rng(0)
    params = lm.flat_params(lm.init_lm(cfg, seed=0, device="cpu"))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))
    if name == "train_4k":
        labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32))
        return (init_train_state(params, AdamWConfig(state_dtype=cfg.opt_state_dtype)),
                {"tokens": tokens, "labels": labels, "weights": torch.ones(rows)})
    if name == "prefill_32k":
        return params, {"tokens": tokens}
    cache = {k: torch.zeros(v.shape, dtype=v.dtype) if isinstance(v, torch.Tensor) else v
             for k, v in margs[1].items()}
    return params, cache, tokens[:, 0].clone()


@pytest.mark.parametrize("arch,name", [("qwen2-0.5b", "train_4k"),
                                       ("hymba-1.5b", "train_4k"),
                                       ("hymba-1.5b", "prefill_32k"),
                                       ("falcon-mamba-7b", "decode_32k")])
def test_meta_and_cpu_runs_of_one_program_agree(arch, name):
    """The same program on meta tensors and on real CPU ones dispatches the
    same ops: every count equal, the peak too (the plain paths: on the CPU
    the kernels' wrappers are not reached)."""
    cfg = get_config(arch).reduced().replace(num_layers=3,
                                             grad_accum=2 if name == "train_4k" else 1)
    shape = dataclasses.replace(SHAPES[name].reduced(), global_batch=4)
    fn, margs = dryrun.cell_program(cfg, shape, None, dryrun.impls("ref"))
    on_meta = program_stats(fn, *margs)
    on_cpu = program_stats(fn, *_cpu_args(name, margs, cfg, 4, shape.seq_len))
    assert on_meta["ops"] > 100
    assert on_meta == on_cpu


def test_storage_bytes_counts_each_storage_once():
    x = meta(10, 10)
    tree = {"a": x, "b": [x[1:], x.t()], "c": (meta(3),)}
    assert op_analysis.storage_bytes(tree, "meta") == 4 * 103
    assert op_analysis.storage_bytes(tree, "cpu") == 0
