"""``correct`` on the CPU at a tiny size, with each cell's limits, for
every cell with a cut file (``cuts/<cell>.json``): a sound run of the port
passes; the control (the reference in the configuration's next lower
precision, in the port's place) fails; and so does a run with the timed
path broken underneath, once for each fault a training cell can have (its
state returned unchanged; half of the batch left out, the mean taken over
the rest).  The harness's look for a card is skipped: the cell runs on the
CPU through the same code it runs on the card."""
from __future__ import annotations

import importlib
import time

import pytest
import torch

from bench import cell, compare, kinds, manifest, tiny
from bench.follow import follow
from bench.reference.solar import Membership

CELLS = list(tiny.CUTS)
CPU = torch.device("cpu")


def _run(name, seed, config=None, mix=None):
    if config is None:
        config, mix = tiny.cell(name, "float32")
    return cell.run(name, seed, 0.5, False, CPU, time.perf_counter(), config=config, mix=mix,
                    full=("grad", "update"))


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct_and_agrees_with_the_reference(name):
    out = _run(name, 2 ** 31 + 17)
    assert out["correct"], out["checks"]
    assert out["checks"]["batch_faults"]["value"] == 0
    # the port in float32 on the CPU does the reference's arithmetic; the
    # change over two or three AdamW steps divides by the root of the second
    # moment, which turns the last bits of a near-zero gradient into whole
    # steps of the learning rate, so the changes agree less closely
    numbers = out["why"]["numbers"]
    assert set(numbers) >= set(out["checks"])
    for k, tol in (("loss_gap", 1e-5), ("grad_gap", 1e-4), ("grad_err", 1e-4),
                   ("update_gap", 1e-3), ("update_err", 1e-3)):
        assert numbers[k] < tol, (k, numbers)


@pytest.mark.parametrize("name", CELLS)
def test_the_lower_precision_control_is_not_correct(name):
    config, mix = tiny.cell(name, "float32", control=True)
    seed = 2 ** 32 + 9
    m = Membership(mix["num_samples"], mix["num_epochs"],
                   mix["num_nodes"] * mix["local_batch"], seed)
    rows = kinds.get(config["kind"]).CONTROL_ROWS
    ids = [m.batch(0, s)[:rows] for s in range(mix["checked_steps"])]
    ref = follow(config, mix, seed, CPU, ids)
    ctl = follow(config, mix, seed, CPU, ids, precision=config["control"])
    values, _ = compare.numbers(ctl, ref, 0)
    ok, checks = compare.judge(values, manifest.workload(name)["limits"])
    assert not ok, checks


def _unchanged(params, grads, state, cfg, *, gnorm=None):
    zero = torch.zeros((), device=next(iter(params.values())).device)
    return dict(params), state, {"grad_norm": zero, "lr": zero}


def _halved(loss_fn):
    def halved(params, batch, *args, **kw):
        rows = next(iter(batch.values())).shape[0]
        return loss_fn(params, {k: v[: max(rows // 2, 1)] for k, v in batch.items()},
                       *args, **kw)
    return halved


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(name, fault, monkeypatch):
    from repro_torch.train import step

    config, mix = tiny.cell(name, "float32")
    if fault == "state_unchanged":
        monkeypatch.setattr(step, "apply_updates", _unchanged)
    else:
        module, loss = kinds.get(config["kind"]).PROGRAM_LOSS
        module = importlib.import_module(module)
        monkeypatch.setattr(module, loss, _halved(getattr(module, loss)))
    out = _run(name, 2 ** 31 + 101, config, mix)
    assert not out["correct"], out["checks"]


def test_a_batch_from_the_wrong_rows_is_a_batch_fault(monkeypatch):
    from repro_torch.data import loaders

    config, mix = tiny.cell("cosmoflow.solar-spill", "float32")
    orig = loaders.StepBatch.to_global

    def shifted(self, capacity):
        data, w = orig(self, capacity)
        return data[::-1].copy(), w[::-1].copy()

    monkeypatch.setattr(loaders.StepBatch, "to_global", shifted)
    out = _run("cosmoflow.solar-spill", 77, config, mix)
    assert out["checks"]["batch_faults"]["value"] > 0 and not out["correct"]
