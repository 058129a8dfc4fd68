"""Behind the numbers that decide ``correct``: how far the reference's own
numbers spread, and where a bfloat16 program's update parts from the
reference's.  Run by hand on the card; the benchmark's runs run none of it.

    python3 bench/checks.py repeat --workload <cell> --seed <n> --seconds <s> \
        [--repeats 6] [--deterministic-repeats 2] [--reference-only]
    python3 bench/checks.py ulps --workload <cell> --seed <n> --seconds <s>

``repeat`` runs the cell once (``cell.run``, ``--trace 0``), then its
reference again ``--repeats`` times on the same checked batches in the same
process, the last ``--deterministic-repeats`` of them under
``torch.backends.cudnn.deterministic``.  ``--reference-only`` leaves the
program out: the reference alone in a fresh process, on the checked steps
of the seed's shuffle (the batches a run whose ``batch_faults`` is 0
trains).  The line holds each step's sample ids as a digest, the program's
and each reference's step losses, and each reference's per-leaf update
norms.

``ulps`` runs the cell with the whole first gradient and update of both
sides kept, and splits each counted leaf's update difference
(:func:`ulp_split`): the elements that differ, those that differ by one
bfloat16 ulp of the weight, and those whose first gradient has the other
sign on the two sides; the line gives the three leaves that set
``update_err`` and all counted leaves together.

The splits import nothing of the port."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__":
    HERE = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != HERE]
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

import torch  # noqa: E402

__all__ = ["bf16_ulp", "ulp_split", "merge_splits", "ids_digest"]


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at each element of ``x`` (8
    significant bits; the smallest normal's spacing at 0)."""
    m = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.ldexp(torch.ones_like(m), torch.frexp(m).exponent - 8)


def ulp_split(p0, change_prog, change_ref, grad_prog, grad_ref) -> dict:
    """Of one bfloat16 leaf: its weights ``p0``, each side's change over
    the checked steps and first gradient.  Counts the elements, those whose
    change differs, those that differ by at most one ulp of the larger of
    the two new weights, and those whose first gradient has the other sign;
    and the squares of the difference that each of the last two carries."""
    p0 = p0.float()
    a, b = p0 + change_prog.float(), p0 + change_ref.float()
    diff = (change_prog.float() - change_ref.float()).abs()
    one = (diff > 0) & (diff <= bf16_ulp(torch.maximum(a.abs(), b.abs())))
    flip = torch.sign(grad_prog.float()) != torch.sign(grad_ref.float())
    sq = diff.double().square()
    return {"elements": diff.numel(), "differ": int((diff > 0).sum()),
            "one_ulp": int(one.sum()), "grad_sign_flips": int(flip.sum()),
            "diff_sq": float(sq.sum()), "diff_sq_one_ulp": float(sq[one].sum()),
            "diff_sq_sign_flips": float(sq[flip].sum()),
            "ref_sq": float(change_ref.double().square().sum())}


def merge_splits(splits) -> dict:
    """Sums of :func:`ulp_split`'s counts, with the shares they give:
    ``update_err`` (the difference's norm over the reference's) and the
    shares of the squared difference carried by one-ulp elements and by
    sign flips."""
    out = {}
    for s in splits:
        for k, v in s.items():
            out[k] = out.get(k, 0) + v
    d = max(out["diff_sq"], 1e-300)
    out["update_err"] = (out["diff_sq"] / max(out["ref_sq"], 1e-300)) ** 0.5
    out["share_of_diff_sq_one_ulp"] = out["diff_sq_one_ulp"] / d
    out["share_of_diff_sq_sign_flips"] = out["diff_sq_sign_flips"] / d
    return out


def ids_digest(step_ids) -> list:
    """Each step's sample ids, in order, as a short digest."""
    import numpy as np

    return [hashlib.sha256(np.asarray(ids, np.int64).tobytes()).hexdigest()[:16]
            for ids in step_ids]


def _repeat(args, device) -> dict:
    from bench import cell, manifest
    from bench.follow import follow
    from bench.reference.solar import Membership
    from bench.traffic import generator

    wl = manifest.workload(args.workload)
    config, mix = manifest.config(wl["config"]), generator.load(wl["traffic"])
    line = {"workload": args.workload, "seed": args.seed}
    seen = {}
    if args.reference_only:
        m = Membership(mix["num_samples"], mix["num_epochs"],
                       mix["num_nodes"] * mix["local_batch"], args.seed)
        seen["ids"] = [m.batch(0, s) for s in range(mix["checked_steps"])]
    else:
        def kept(config_, mix_, seed, dev, ids, **kw):
            seen["ids"] = ids
            return follow(config_, mix_, seed, dev, ids, **kw)

        cell.follow = kept
        try:
            out = cell.run(args.workload, args.seed, args.seconds, False, device, T_START,
                           log=lambda *a: print(*a, file=sys.stderr))
        finally:
            cell.follow = follow
        why = out["why"]
        line.update(correct=out["correct"], numbers=why["numbers"],
                    loss_program=why["loss_program"], loss_reference=why["loss_reference"],
                    update_program={k: v[0] for k, v in why["update_leaves"].items()},
                    update_reference={k: v[1] for k, v in why["update_leaves"].items()})
    line["ids"] = ids_digest(seen["ids"])
    repeats = []
    for i in range(args.repeats):
        torch.backends.cudnn.deterministic = i >= args.repeats - args.deterministic_repeats
        ref = follow(config, mix, args.seed, device, seen["ids"], full=())
        repeats.append({"cudnn_deterministic": torch.backends.cudnn.deterministic,
                        "loss": ref["loss"], "update": ref["update"]})
    torch.backends.cudnn.deterministic = False
    line["repeats"] = repeats
    return line


def _ulps(args, device) -> dict:
    from bench import cell, compare, manifest
    from bench.traffic import weights

    wl = manifest.workload(args.workload)
    config = manifest.config(wl["config"])
    seen = {}
    numbers = compare.numbers

    def kept(prog, ref, faults):
        seen["prog"], seen["ref"] = prog, ref
        return numbers(prog, ref, faults)

    cell.compare.numbers = kept
    try:
        out = cell.run(args.workload, args.seed, args.seconds, False, device, T_START,
                       full=("grad", "update"), log=lambda *a: print(*a, file=sys.stderr))
    finally:
        cell.compare.numbers = numbers
    prog, ref, why = seen["prog"], seen["ref"], out["why"]
    p0 = weights.make(config, args.seed, device)
    med = statistics.median(ref["grad"].values())
    counted = [k for k, v in ref["grad"].items() if v >= compare.COUNTED_FLOOR * med]
    splits = {k: ulp_split(*(t.to(device) for t in (
        p0[k], prog["update_full"][k], ref["update_full"][k], prog["grad_full"][k],
        ref["grad_full"][k]))) for k in counted}
    worst = [k for k, _ in why.get("update_err_worst", [])]
    return {"workload": args.workload, "seed": args.seed, "correct": out["correct"],
            "numbers": why["numbers"], "update_err_worst": why.get("update_err_worst"),
            "leaves": {k: merge_splits([splits[k]]) for k in worst},
            "all_counted": merge_splits(splits.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("repeat", "ulps"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--deterministic-repeats", type=int, default=2)
    ap.add_argument("--reference-only", action="store_true")
    args = ap.parse_args(argv)

    from bench import run as bench_run

    bench_run._environment()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    line = (_repeat if args.what == "repeat" else _ulps)(args, device)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
