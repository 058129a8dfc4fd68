"""AI21-Jamba2-3B in the benchmark, on the CPU: the port's interleaved
family against the plain reference (``reference/jamba.py``) at the cell's
CPU cut in float32, the kind module's weight layout against the port's
init at the published widths, its FLOP count, the new cell's pinned
weights and store rows, and its cut in the correctness tests.

Tolerances are hymba's (``tests/test_torch_lm_train.py``): the loss within
1e-5 relative, as both sides run the same float32 operations summed in
other orders; each gradient leaf within 1e-4 of its own largest magnitude,
as a gradient sums the same products over the rows and positions in
another order (and through the selective scan the port's chunked scan
against the reference's), a few float32 ulps of its largest element."""
from __future__ import annotations

import pytest
import torch

from bench import kinds, tiny
from bench.reference.common import Rounding, exact_f32
from bench.test_bench_reference import _digest
from bench.traffic import generator, weights

CELL = "jamba2-3b.train-solar-4k"
CPU = torch.device("cpu")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def _noisy(w: dict, seed: int, noise: float = 0.05) -> dict:
    """The seed's weights with seeded noise on every leaf (float32): a zero
    norm scale or bias would hide a 1 + scale or bias fault."""
    g = torch.Generator().manual_seed(seed)
    return {k: v.float() + noise * torch.randn(v.shape, generator=g) for k, v in w.items()}


def test_the_ports_loss_and_every_gradient_are_the_references():
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    config, mix = tiny.cell(CELL, "float32")
    cfg = get_config(config["arch"]).replace(**config["model"])
    assert cfg.layer_kinds.count("attention") and cfg.layer_kinds[0] == "mamba"
    w = _noisy(weights.make(config, 2 ** 31 + 3, CPU), 5)
    rows = generator.data(config, mix, 2 ** 31 + 3, CPU)[:3].long()

    ours = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss, _ = lm.train_loss(lm.nested_params(ours), {"tokens": rows[:, :-1],
                                                      "labels": rows[:, 1:]}, cfg)
    grads = dict(zip(ours, torch.autograd.grad(loss, list(ours.values()))))

    theirs = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    with exact_f32():
        ref_loss, ref_grads = kinds.get("interleaved").reference_step(
            theirs, rows, config, mix, Rounding())
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=LOSS_RTOL)
    assert set(grads) == set(ref_grads)
    for k, g in grads.items():
        scale = float(ref_grads[k].abs().max())
        assert scale > 0, k
        err = float((g - ref_grads[k]).abs().max())
        assert err <= GRAD_TOL * scale, (k, err, scale)


def test_the_layout_is_the_ports_init_at_the_published_widths():
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from bench import manifest

    config = manifest.config("jamba2-3b")
    cfg = get_config(config["arch"]).replace(**config["model"])
    ours = [(n, tuple(s), dt) for n, s, dt, _ in weights.layout(config)]
    port = [(n, tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for n, t in lm.flat_params(lm.init_lm(cfg, device="meta")).items()]
    assert ours == port
    assert sum(torch.Size(s).numel() for _, s, _ in ours) == cfg.num_params()


def test_the_model_flops_count_the_products_and_the_admitted_scores():
    from bench import manifest
    from bench.counts.kernels import admitted_scores

    config, mix = manifest.config("jamba2-3b"), {"seq_len": 4096}
    kind = kinds.get("interleaved")
    skip = ("norm", "ln1", "ln2", "conv_b", "dt_bias", "a_log", "d_skip")
    products = sum(torch.Size(s).numel() for n, s, _, _ in weights.layout(config)
                   if not n.endswith(skip))
    assert kind.matmul_params(config["model"]) == products == 1_597_214_720  # 14 layers
    # the published 28 layers: 3.026 B products (the tied head counted once)
    whole = dict(config["model"], num_layers=28)
    assert 3.026e9 < kind.matmul_params(whole) < 3.027e9
    scores = admitted_scores(4096, 4096, True, 0)
    assert kind.model_flops_per_row(config, mix) == pytest.approx(
        6 * products * 4096 + 12 * 128 * 20 * scores * 1)


#: SHA-256 of ``weights.make`` and ``generator.data`` at the new cell's CPU
#: cut (in the configuration's own dtypes) from seed 2**40 + 7, as
#: ``test_bench_reference.DIGESTS`` pins the others'
DIGESTS = {
    CELL: (
        "cdc3a275b97eacd2e0dc0c94c14b590c85eb4f28e0d3e8a3c5069d09f4367c34",
        "080968cbc484989126c43c1f070534c503aeba6555ef7ec6c6836d5082f0c051"),
}


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_new_cells_weights_and_store_rows_keep_their_bits(name):
    config, mix = tiny.cell(name)
    got = (_digest(weights.make(config, 2 ** 40 + 7, CPU)),
           _digest({"data": generator.data(config, mix, 2 ** 40 + 7, CPU)}))
    assert got == DIGESTS[name]


def test_the_correctness_tests_take_the_new_cut():
    from bench import test_bench_correctness

    assert set(DIGESTS) <= set(test_bench_correctness.CELLS)
