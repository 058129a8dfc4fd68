"""The window's arithmetic and the yardstick's counts, against closed forms
and brute force."""
from __future__ import annotations

import itertools
import math
import random

import numpy as np
import pytest
import torch

from bench import window
from bench.counts import kernels, models, peaks


def test_rate_divides_all_the_work_by_all_the_time():
    assert window.rate(450.0, 3.0) == 150.0
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)


@pytest.mark.parametrize("n", [1, 2, 5, 20, 101])
def test_percentile_is_numpys_linear_percentile(n):
    rng = random.Random(n)
    xs = [rng.random() for _ in range(n)]
    for q in (0, 50, 95, 100):
        assert window.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_p95_of_twenty_steps_is_between_the_two_largest():
    xs = list(range(1, 21))
    assert 19 < window.percentile(xs, 95) < 20


@pytest.mark.parametrize("intervals,length", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),            # overlapping kernels count once
    ([(0, 4), (1, 2), (2, 3)], 4.0),    # nested
    ([(0, 1), (2, 3)], 2.0),            # apart
    ([(2, 3), (0, 1), (0.5, 2.5)], 3.0),
])
def test_union_counts_overlapping_intervals_once(intervals, length):
    assert window.union_length(intervals) == pytest.approx(length)


def test_union_against_a_fine_grid():
    rng = random.Random(7)
    iv = [(a, a + rng.randint(1, 30)) for a in (rng.randint(0, 200) for _ in range(40))]
    grid = np.zeros(400, bool)
    for a, b in iv:
        grid[a:b] = True
    assert window.union_length(iv) == grid.sum()


def test_gaps_are_the_complement_of_the_union():
    iv = [(1, 2), (1.5, 3), (5, 6)]
    assert window.gaps(iv, 0, 7) == [(0, 1), (3, 5), (6, 7)]
    assert sum(b - a for a, b in window.gaps(iv, 0, 7)) + window.union_length(iv) == 7


@pytest.mark.parametrize("sq,sk,causal,w", [
    (s, k, c, w) for s, k in [(1, 1), (7, 7), (16, 16), (5, 12), (12, 5)]
    for c in (True, False) for w in (0, 1, 3, 8)])
def test_admitted_scores_count_the_mask(sq, sk, causal, w):
    i = np.arange(sq)[:, None]
    j = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= j <= i
    if w > 0:
        ok &= i - j < w
    assert kernels.admitted_scores(sq, sk, causal, w) == ok.sum()


def test_attention_work_at_hymbas_microbatch():
    w = kernels.attention(2, 25, 5, 2048, 2048, 64, True, 1024, 2)
    scores = sum(min(i + 1, 1024) for i in range(2048)) * 2 * 25
    assert w.dot_flops == 4 * 64 * scores
    assert w.bytes == (2 * 2 * 25 * 2048 * 64 + 2 * 2 * 5 * 2048 * 64) * 2
    assert kernels.attention_bwd(2, 25, 5, 2048, 2048, 64, True, 1024, 2).dot_flops \
        == 10 * 64 * scores


def test_scan_work_and_its_bound():
    w = kernels.scan(2, 2048, 3200, 16, 2)
    elems = 2 * 2048 * 3200 * 16
    assert (w.exps, w.f32_ops) == (elems, 6 * elems)
    sfu = elems / (peaks.SFU_PER_SM_CLK * peaks.SMS * peaks.MAX_SM_CLOCK_HZ)
    assert kernels.bound_s(w) == pytest.approx(max(sfu, 6 * elems / 67e12, w.bytes / 3.35e12))


def test_peaks_are_the_data_sheets():
    assert peaks.peak_flops("bfloat16") == 989e12
    assert peaks.peak_flops("tf32") == 495e12
    assert peaks.peak_flops("float32") == 67e12
    with pytest.raises(ValueError):
        peaks.peak_flops("int4")


HYMBA = {"family": "hybrid", "num_layers": 32, "d_model": 1600, "num_heads": 25,
         "num_kv_heads": 5, "head_dim": 64, "d_ff": 5504, "vocab_size": 32001,
         "ssm_state": 16, "ssm_expand": 2, "ssm_conv": 4, "sliding_window": 1024}


def test_lm_matmul_params_against_the_ports_count():
    from repro_torch.configs import get_config

    cfg = get_config("hymba-1.5b")
    # the port counts the input embedding, ln1, ln2, a_log, D and the final
    # norm too (and leaves out ln_ssm, conv_b and dt_bias)
    d, di, n, L = 1600, 3200, 16, 32
    extra = 32001 * d + L * (2 * d + di * n + di) + d
    assert models.lm_matmul_params(HYMBA) + extra == cfg.num_params()


def test_lm_train_flops_closed_form():
    n = models.lm_matmul_params(HYMBA)
    scores = sum(min(i + 1, 1024) for i in range(2048))
    want = 6 * n * 10 * 2048 + 12 * 64 * 25 * scores * 32 * 10
    assert models.lm_train_flops(HYMBA, 10, 2048) == pytest.approx(want)


COSMO = {"kind": "cosmoflow", "input_shape": [64, 64, 64, 4], "output_shape": [4],
         "base_channels": 16, "depth": 4}


def test_cnn_flops_count_every_convolution_output():
    total, c, s = 0, 4, 64
    for i in range(4):
        co, s = 16 * 2 ** i, s // 2
        total += 2 * s ** 3 * co * c * 27
        c = co
    total += 2 * (128 * 4 ** 3 * 128 + 128 * 4)
    assert models.cnn_forward_flops(COSMO) == total
    assert models.cnn_train_flops(COSMO, 24) == 3 * 24 * total


def test_cnn_flops_against_the_convolutions_shapes():
    """The output sizes the count assumes are those F.conv3d gives after the
    "SAME" padding (meta tensors: no compute)."""
    from bench.reference.cnn import _same_pads

    x = torch.empty((1, 4, 64, 64, 64), device="meta")
    c = 4
    for i in range(4):
        co = 16 * 2 ** i
        pads = list(itertools.chain(*(_same_pads(n) for n in reversed(x.shape[2:]))))
        x = torch.nn.functional.conv3d(torch.nn.functional.pad(x, pads),
                                       torch.empty((co, c, 3, 3, 3), device="meta"), stride=2)
        c = co
    assert tuple(x.shape) == (1, 128, 4, 4, 4)
    assert math.prod(x.shape[1:]) == 8192
