"""The readings that a cell's limits are set from, on the card, in one
process (the kernels built once):

    python3 bench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--out chiprun_out/calibrate.json]

For each of ``--seeds`` seeds a run of the cell with a one-step window
(the checked steps and the reference, as every run makes them): the
port's numbers, whose largest are the lower readings.  For each of
``--control-seeds`` seeds, the reference put in the port's place on the
same global batches: in the configuration's next lower precision (the
control) and with half of each step's rows left out (a planted fault),
each compared with the float32 reference; the smallest are the upper
readings.  A configuration that turns TF32 off has the port with TF32 on
for its control: a whole run of the cell.  Each control and fault is
judged against the cell's limits, its verdict kept beside its numbers
(``control_correct``, ``half_batch_correct``).  A state returned
unchanged reads 1 on ``update_gap`` by definition and is not run.  The
benchmark's own runs run none of this."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:] = [p for p in sys.path if p and Path(p).resolve() != Path(__file__).resolve().parent]
sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2 ** 31 + 1000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--model", default=None,
                    help="JSON changes to the configuration's model block, for a "
                         "witness at another size or precision (not a cell's reading)")
    ap.add_argument("--control", default=None,
                    help="the control's precision, if not the configuration's (a witness)")
    args = ap.parse_args(argv)

    import torch

    from bench import cell, compare, manifest
    from bench.follow import follow
    from bench.reference.solar import Membership
    from bench.traffic import generator

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    wl = manifest.workload(args.workload)
    config, mix = manifest.config(wl["config"]), generator.load(wl["traffic"])
    if args.model:
        config["model"].update(json.loads(args.model))
    report = {"cell": args.workload, "card": torch.cuda.get_device_name(device),
              "model": args.model,
              "program": [], "control": [], "half_batch": []}
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t = time.perf_counter()
        out = cell.run(args.workload, seed, 0.01, False, device, t, config=config, mix=mix,
                       full=("grad", "update"))
        row = {"seed": seed, **out["why"]["numbers"],
               "correct": out["correct"], "why": out["why"],
               "seconds": time.perf_counter() - t}
        report["program"].append(row)
        print(json.dumps(row), flush=True)
    for i in range(args.control_seeds):
        seed = args.first_seed + 104729 * (i + 1)
        m = Membership(mix["num_samples"], mix["num_epochs"],
                       mix["num_nodes"] * mix["local_batch"], seed)
        ids = [m.batch(0, s) for s in range(mix["checked_steps"])]
        t = time.perf_counter()
        if config.get("allow_tf32") is False and not args.control:
            t = time.perf_counter()
            out = cell.run(args.workload, seed, 0.01, False, device, t,
                           config={**config, "allow_tf32": True}, mix=mix,
                           full=("grad", "update"))
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
            row = {"seed": seed, **out["why"]["numbers"], "correct": out["correct"],
                   "checks": out["checks"], "why": out["why"],
                   "seconds": time.perf_counter() - t}
            report["control"].append(row)
            print("control", json.dumps(row), flush=True)
        ref = follow(config, mix, seed, device, ids)
        controls = (() if config.get("allow_tf32") is False and not args.control
                    else (("control", {"precision": args.control or config["control"]}),))
        for key, kw in controls + (("half_batch", {"half": True}),):
            other = follow(config, mix, seed, device, ids, **kw)
            values, why = compare.numbers(other, ref, 0)
            row = {"seed": seed, **values, "correct": compare.judge(values, wl["limits"])[0],
                   "why": why, "seconds": time.perf_counter() - t}
            report[key].append(row)
            print(key, json.dumps(row), flush=True)
    summary = {}
    for key in ("program", "control", "half_batch"):
        rows = report[key]
        if rows:
            agg = max if key == "program" else min
            summary[key] = {k: agg(r[k] for r in rows)
                            for k in ("loss_gap", "grad_gap", "update_gap", "grad_err",
                                      "update_err") if k in rows[0]}
    for key in ("control", "half_batch"):
        summary[f"{key}_correct"] = [r["correct"] for r in report[key]]
    report["summary"] = summary
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
