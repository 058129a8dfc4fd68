"""The comparison that decides ``correct``: the numbers compared and their
limits.

* ``batch_faults``: trained steps whose samples are not one global batch of
  the seed's shuffle in SOLAR's order, plus checked steps whose rows or
  weights differ from the store's rows regenerated from the seed (an exact
  comparison, limit 0);
* ``loss_gap``: the largest relative gap of a checked step's loss;
* ``grad_gap``: of the first gradient as the optimizer takes it, before
  its clipping (the port's from its first moment after one step and the
  global norm the step reports), the worst leaf's gap between the port's
  norm and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf;
* ``update_gap``: the same for each leaf's change over the checked steps;
* ``grad_err``, ``update_err``: the norm of the difference between the
  port's first gradient (change) and the reference's, over the norm of
  the reference's, all counted leaves together.  A norm moves little under
  unbiased rounding noise, so the gaps of norms read a lower precision
  about as they read the configuration's; the differences separate them
  (PERF.md §2 gives the readings).

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's move by round-off alone and are left out of all four.  A
cell's file lists the numbers it compares, each with its limit; the others
are reported beside them."""
from __future__ import annotations

import statistics

__all__ = ["numbers", "judge", "COUNTED_FLOOR"]

COUNTED_FLOOR = 1e-3


def _leaf_gaps(prog: dict, ref: dict, counted: list) -> dict:
    med = statistics.median(ref[k] for k in counted)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in counted}


def _worst(gaps: dict, n: int = 3) -> list:
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:n]


def diff_norms(a: dict, b: dict) -> dict:
    """Each leaf's norm of ``a - b`` (float64), leaf by leaf on ``b``'s
    device."""
    import torch

    out = {}
    for k, t in b.items():
        d = a[k].to(t.device, torch.float32) - t.float()
        out[k] = float(torch.linalg.vector_norm(d.double()))
        del d
    return out


def numbers(prog: dict, ref: dict, batch_faults: int) -> tuple[dict, dict]:
    """(the numbers compared, what explains them: the leaves counted and the
    worst leaf of each gap)."""
    med = statistics.median(ref["grad"].values())
    counted = [k for k, v in ref["grad"].items() if v >= COUNTED_FLOOR * med]
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["loss"], ref["loss"]))
    grad = _leaf_gaps(prog["grad"], ref["grad"], counted)
    update = _leaf_gaps(prog["update"], ref["update"], counted)
    out = {"batch_faults": float(batch_faults), "loss_gap": loss_gap,
           "grad_gap": max(grad.values()), "update_gap": max(update.values())}
    errs = {}
    for key in ("grad", "update"):
        if f"{key}_full" in prog and f"{key}_full" in ref:
            diff = diff_norms(prog[f"{key}_full"], ref[f"{key}_full"])
            med = statistics.median(ref[key][k] for k in counted)
            errs[key] = {k: diff[k] / max(ref[key][k], med, 1e-30) for k in counted}
            whole = sum(ref[key][k] ** 2 for k in counted) ** 0.5
            out[f"{key}_err"] = sum(diff[k] ** 2 for k in counted) ** 0.5 / max(whole, 1e-30)
    why = {"leaves_counted": len(counted), "leaves": len(ref["grad"]),
           "grad_worst": _worst(grad), "update_worst": _worst(update),
           **{f"{k}_err_worst": _worst(v) for k, v in errs.items()},
           "grad_norm_program": prog.get("grad_norm"), "grad_norm_reference": ref["grad_norm"],
           "loss_program": prog["loss"], "loss_reference": ref["loss"],
           "grad_leaves": {k: [prog["grad"][k], ref["grad"][k]] for k in ref["grad"]},
           "update_leaves": {k: [prog["update"][k], ref["update"][k]] for k in ref["update"]}}
    return out, why


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that has a limit within it, ``{name: {"value",
    "limit"}}`` of those numbers)."""
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    return all(values[k] <= lim for k, lim in limits.items()), checks
