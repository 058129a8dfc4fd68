"""Open-loop tenant read load on a data tier, in a process of its own.

    PYTHONPATH=src python -m repro_torch.serve.tenant_load \
        --endpoints 0=127.0.0.1:41000,1=127.0.0.1:41001 --tenant 2 \
        --token batch-reader --num-samples 8192 --ids 8 --pause 0.002

Reads ``--ids`` random sample ids (seeded, uniform over ``--num-samples``)
every ``--pause`` seconds through a
:class:`~repro_torch.serve.datatier.DataTierClient` that gives up on the
first shed, the way a batch reader behind a rate limit does.  It prints
``{"ready": true}`` once attached, reads until its standard input closes,
then prints the client's ``stats()`` as one JSON line and exits.

Run as its own process it shares no interpreter with the tier's servers or
with a serving replica, so a read storm competes with them for cores only.
Numpy-only: it imports no torch.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from repro_torch.serve.datatier import DataTierClient

__all__ = ["parse_endpoints", "run", "main"]


def parse_endpoints(text: str) -> dict[int, tuple[str, int]]:
    """``"0=host:port,1=host:port"`` -> {node: (host, port)}."""
    out = {}
    for item in text.split(","):
        node, addr = item.split("=")
        host, port = addr.rsplit(":", 1)
        out[int(node)] = (host, int(port))
    return out


def run(endpoints, *, tenant: int, token: str, num_samples: int, ids: int = 8,
        pause_s: float = 0.002, seed: int = 2, stop: threading.Event,
        on_ready=None, timeout_s: float = 10.0) -> dict:
    """Read until ``stop`` is set; returns the client's ``stats()``."""
    rng = np.random.default_rng(seed)
    client = DataTierClient(endpoints, tenant=tenant, token=token, timeout_s=timeout_s,
                            shed_wait_s=0.001, max_shed_retries=0)
    try:
        client.warmup()
        if on_ready is not None:
            on_ready()
        while not stop.is_set():
            client.read(rng.integers(0, num_samples, ids))
            time.sleep(pause_s)
        return client.stats()
    finally:
        client.close()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="repro_torch.serve.tenant_load")
    ap.add_argument("--endpoints", required=True,
                    help="comma-separated node=host:port buffer-server addresses")
    ap.add_argument("--tenant", type=int, required=True)
    ap.add_argument("--token", required=True)
    ap.add_argument("--num-samples", type=int, required=True,
                    help="ids are drawn from [0, num_samples)")
    ap.add_argument("--ids", type=int, default=8, help="ids per read")
    ap.add_argument("--pause", type=float, default=0.002,
                    help="seconds between reads")
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    stop = threading.Event()

    def wait_for_eof():
        sys.stdin.read()
        stop.set()

    threading.Thread(target=wait_for_eof, name="stdin-eof", daemon=True).start()
    stats = run(parse_endpoints(args.endpoints), tenant=args.tenant, token=args.token,
                num_samples=args.num_samples, ids=args.ids, pause_s=args.pause,
                seed=args.seed, stop=stop,
                on_ready=lambda: print(json.dumps({"ready": True}), flush=True))
    print(json.dumps(stats), flush=True)
    return stats


if __name__ == "__main__":
    main()
