"""The reference's pieces against their definitions: the chunked linear
scan against a loop, the selective scan's forward and hand-written
backward against autograd through a step-by-step loop (float64), SOLAR's
membership, the reference AdamW against its formula, and the seed's
weights and store rows against their pinned digests."""
from __future__ import annotations

import hashlib
import math

import numpy as np
import pytest
import torch

from bench.reference import scan, solar
from bench.reference.common import AdamW, Rounding


def _loop_scan(a, b):
    h, out = torch.zeros_like(b[0]), []
    for t in range(a.shape[0]):
        h = a[t] * h + b[t]
        out.append(h)
    return torch.stack(out)


@pytest.mark.parametrize("s,chunk", [(1, 4), (5, 4), (8, 4), (37, 8), (64, 32), (33, 32)])
def test_linear_scan_is_the_recurrence(s, chunk):
    g = torch.Generator().manual_seed(s)
    a = torch.rand((s, 3, 2), generator=g, dtype=torch.float64)
    b = torch.randn((s, 3, 2), generator=g, dtype=torch.float64)
    got = scan.linear_scan(a, b, chunk=chunk)
    torch.testing.assert_close(got, _loop_scan(a, b), rtol=1e-12, atol=1e-12)


def _loop_selective(u, dt, a, b, c, d):
    decay = torch.exp(dt[:, :, None] * a)
    inp = (dt * u)[:, :, None] * b[:, None, :]
    h = _loop_scan(decay, inp)
    return torch.einsum("sdn,sn->sd", h, c) + u * d


@pytest.mark.parametrize("s", [1, 7, 40, 70])
def test_selective_scan_forward_and_gradient_match_autograd_of_the_loop(s):
    g = torch.Generator().manual_seed(100 + s)
    di, n = 5, 3
    args = [torch.randn((s, di), generator=g, dtype=torch.float64),
            torch.rand((s, di), generator=g, dtype=torch.float64) * 0.5,
            -torch.rand((di, n), generator=g, dtype=torch.float64) * 2,
            torch.randn((s, n), generator=g, dtype=torch.float64),
            torch.randn((s, n), generator=g, dtype=torch.float64),
            torch.randn((di,), generator=g, dtype=torch.float64)]
    dy = torch.randn((s, di), generator=g, dtype=torch.float64)
    mine = [x.clone().requires_grad_(True) for x in args]
    theirs = [x.clone().requires_grad_(True) for x in args]
    y1 = scan.selective_scan(*mine)
    y2 = _loop_selective(*theirs)
    torch.testing.assert_close(y1, y2, rtol=1e-10, atol=1e-10)
    g1 = torch.autograd.grad((y1 * dy).sum(), mine)
    g2 = torch.autograd.grad((y2 * dy).sum(), theirs)
    for x1, x2 in zip(g1, g2):
        torch.testing.assert_close(x1, x2, rtol=1e-9, atol=1e-9)


def test_membership_accepts_the_shuffles_batches_in_any_epoch_order():
    m = solar.Membership(32, 3, 8, seed=2 ** 40 + 3)
    steps = []
    for e in (2, 0, 1):
        for s in range(4):
            ids = m.batch(e, s)
            steps.append([ids[:3], ids[3:]])  # any split over nodes
    where, faults = m.check(steps)
    assert faults == 0 and where[0] == (2, 0) and where[-1] == (1, 3)


@pytest.mark.parametrize("fault", ["swap", "repeat_epoch", "out_of_order", "duplicate"])
def test_membership_counts_a_fault(fault):
    m = solar.Membership(32, 3, 8, seed=11)
    steps = [[m.batch(0, s)] for s in range(4)] + [[m.batch(1, s)] for s in range(4)]
    if fault == "swap":
        a, b = steps[1][0].copy(), steps[2][0].copy()
        a[0], b[0] = b[0], a[0]
        steps[1], steps[2] = [a], [b]
    elif fault == "repeat_epoch":
        steps += [[m.batch(0, s)] for s in range(4)]
    elif fault == "out_of_order":
        steps[1], steps[2] = steps[2], steps[1]
    else:
        steps[0] = [np.concatenate([steps[0][0][:7], steps[0][0][:1]])]
    assert m.check(steps)[1] > 0


def test_permutations_are_the_ports_shuffle():
    from repro_torch.core.shuffle import generate_epoch_permutations

    np.testing.assert_array_equal(solar.epoch_permutations(100, 4, 2 ** 33 + 1),
                                  generate_epoch_permutations(100, 4, 2 ** 33 + 1))


def test_adamw_first_step_is_the_sign_times_the_warmup_rate():
    opt = {"lr": 1e-2, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0,
           "clip_norm": 0.0, "warmup_steps": 10, "total_steps": 1000}
    p = {"w": torch.zeros(4)}
    g = {"w": torch.tensor([3.0, -2.0, 0.5, -1e-3])}
    adam = AdamW(p, opt, {"w": torch.float32})
    adam.opt = dict(opt, clip_norm=1e9)
    adam.update(p, g)
    want = -1e-3 * torch.sign(g["w"]) * (g["w"].abs() / (g["w"].abs() + 1e-8))
    torch.testing.assert_close(p["w"], want)


def test_adamw_clips_by_the_global_norm():
    opt = {"lr": 1.0, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0,
           "clip_norm": 1.0, "warmup_steps": 0, "total_steps": 10}
    p = {"a": torch.zeros(1), "b": torch.zeros(1)}
    adam = AdamW(p, opt, {"a": torch.float32, "b": torch.float32})
    scale = adam.update(p, {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])})
    assert scale == pytest.approx(0.2)
    torch.testing.assert_close(adam.mu["a"], torch.tensor([0.1 * 0.6]))


@pytest.mark.parametrize("precision,rel", [("bfloat16", 2 ** -8), ("fp8", 2 ** -4)])
def test_rounding_keeps_its_precisions_relative_error(precision, rel):
    x = torch.randn(10000, generator=torch.Generator().manual_seed(3)) + 5
    err = ((Rounding(precision)(x) - x).abs() / x.abs()).max()
    assert 0 < err <= rel * 1.01
    assert torch.equal(Rounding(None)(x), x)


def test_rounding_passes_a_rounded_gradient_back():
    x = torch.randn(64, generator=torch.Generator().manual_seed(4), requires_grad=True)
    y = Rounding("bfloat16")(x)
    (g,) = torch.autograd.grad((y * math.pi).sum(), x)
    assert torch.equal(g, torch.full_like(g, math.pi).to(torch.bfloat16).float())


def test_weights_follow_the_configurations_init():
    from bench import tiny
    from bench.traffic import weights

    config, _ = tiny.cell("hymba-1.5b.train-solar-2k", "float32")
    w = weights.make(config, 2 ** 40 + 1, torch.device("cpu"))
    dt = torch.nn.functional.softplus(w["layers.ssm.dt_bias"][0].double())
    assert dt[0] == pytest.approx(config["init"]["dt_min"], rel=1e-5)
    assert dt[-1] == pytest.approx(config["init"]["dt_max"], rel=1e-5)
    ratio = dt[1:] / dt[:-1]
    assert torch.allclose(ratio, ratio[0], rtol=1e-6)   # log-even
    layers = config["model"]["num_layers"]
    f = config["model"]["d_ff"]
    std = float(w["layers.wo_mlp"].std())
    assert std == pytest.approx(1 / math.sqrt(f) / math.sqrt(2 * layers), rel=0.1)
    assert float(w["layers.ln1"].abs().max()) == 0.0
    assert torch.equal(w["layers.ssm.a_log"][0, 0], torch.log(torch.arange(1.0, 9.0)))


def test_weights_are_the_same_for_a_seed_and_differ_between_seeds():
    from bench import tiny
    from bench.traffic import weights

    config, _ = tiny.cell("cosmoflow.solar-spill")
    a = weights.make(config, 5, torch.device("cpu"))
    b = weights.make(config, 5, torch.device("cpu"))
    c = weights.make(config, 6, torch.device("cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["enc.0.w"], c["enc.0.w"])


#: SHA-256 of ``weights.make`` and ``generator.data`` at each cell's CPU cut
#: (in the configuration's own dtypes) from seed 2**40 + 7: what a kind
#: module's layout and data draw must keep, bit for bit, for the ledger's
#: numbers of a cell to stay comparable
DIGESTS = {
    "cosmoflow.solar-spill": (
        "4b3c7cace19663965899d4f8264502c1981101016b9e90a535fb119bfb65bd9d",
        "e3abbd6edf578a03be3a1882286ab79f1226f9fbea2199264cfb3323b087cfad"),
    "hymba-1.5b.train-solar-2k": (
        "3019a52af8229c4f3bf3f1f5ff32b391d4e3eba9a7beb9c24417eede07d2b17d",
        "080968cbc484989126c43c1f070534c503aeba6555ef7ec6c6836d5082f0c051"),
}


def _digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for name, t in tensors.items():
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_seeds_weights_and_store_rows_keep_their_bits(name):
    from bench import tiny
    from bench.traffic import generator, weights

    config, mix = tiny.cell(name)
    cpu = torch.device("cpu")
    got = (_digest(weights.make(config, 2 ** 40 + 7, cpu)),
           _digest({"data": generator.data(config, mix, 2 ** 40 + 7, cpu)}))
    assert got == DIGESTS[name]
